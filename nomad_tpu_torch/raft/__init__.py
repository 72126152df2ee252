"""Replicated log + consensus for the control plane.

The reference rides hashicorp/raft (nomad/server.go:1157 setupRaft) with
an FSM in nomad/fsm.go, BoltDB log storage, and FileSnapshotStore. This
package rebuilds that contract: a durable typed entry log (log.py), the
state-store FSM with snapshot/restore (fsm.py), and a raft node with
leader election, log replication, commit tracking and snapshot install
over pluggable transports (node.py).

The counterpart of `nomad_tpu.raft`.  The in-process transport carries
multi-server clusters in one process; the TCP transport (the reference's
`rpc` package) is ROADMAP.md Queue 1's `rpc/` item.
"""
from .fsm import StateFSM
from .log import LogEntry, RaftLog
from .node import (InProcTransport, NotLeaderError, RaftConfig, RaftNode,
                   ROLE_CANDIDATE, ROLE_FOLLOWER, ROLE_LEADER)

__all__ = ["StateFSM", "LogEntry", "RaftLog", "InProcTransport",
           "NotLeaderError", "RaftConfig", "RaftNode", "ROLE_CANDIDATE",
           "ROLE_FOLLOWER", "ROLE_LEADER"]
