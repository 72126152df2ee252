"""Multi-region request routing over gossip membership.

Reference: nomad/rpc.go forward() — a request naming another region is
proxied to a live server of that region discovered via the WAN gossip
pool (nomad/server.go:1498 Regions / serf member tags).

The counterpart of `nomad_tpu.membership.regions`; the order in which a
region's members are tried comes from the router's own `random.Random`.
"""
from __future__ import annotations

import random
from typing import Any, List, Optional

from ..rpc.client import ClientPool, RpcError
from .gossip import GossipAgent


class RegionRouter:
    """Routes RPC verbs to a region's servers using the member list."""

    def __init__(self, gossip: GossipAgent):
        self.gossip = gossip
        self._pool = ClientPool()
        self._rng = random.Random()

    def regions(self) -> List[str]:
        return self.gossip.regions()

    def close(self) -> None:
        self._pool.close()

    def call_region(self, region: str, method: str, params: List[Any],
                    timeout: float = 30.0) -> Any:
        """Invoke an RPC verb on some live server of `region`; tries
        members in random order, following in-region leader forwarding
        server-side."""
        members = self.gossip.members_of_region(region)
        if not members:
            raise ConnectionError(f"no live servers in region {region!r}")
        self._rng.shuffle(members)
        last: Optional[Exception] = None
        for m in members:
            try:
                return self._pool.get(m.id, m.addr).call(
                    method, params, timeout=timeout)
            except (ConnectionError, RpcError) as e:
                if isinstance(e, RpcError) and e.kind not in (
                        "not_leader", "forward_failed"):
                    raise
                last = e
        raise last if last is not None else \
            ConnectionError(f"region {region!r} unreachable")
