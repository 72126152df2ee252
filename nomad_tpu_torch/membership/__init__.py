"""Cluster membership: SWIM-style gossip + region routing.

Reference: nomad/serf.go (serf/memberlist gossip joins the servers,
fires nodeJoin/nodeFailed events) and the region forwarding that rides
on it (nomad/server.go:1498 Regions, nomad/rpc.go forward to a remote
region by name).

The counterpart of `nomad_tpu.membership`.
"""
from .gossip import GossipAgent, Member
from .regions import RegionRouter

__all__ = ["GossipAgent", "Member", "RegionRouter"]
