"""Fit checking and bin-pack scoring — the inner arithmetic of placement.

Reference: nomad/structs/funcs.go `AllocsFit` :103, `ScoreFit` :155.
These host-side scalar versions are the golden semantics the solver's
tensor scoring vectorizes; the scheduler uses them for single-node fits
(sticky placements, in-place updates, host-side preemption).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .alloc import Allocation
from .node import Node
from .resources import ComparableResources
from .network import NetworkIndex
from .devices import DeviceAccounter

# Maximum achievable score: both dimensions completely free
# (20 - (10^0 + 10^0)) = 18. Reference: scheduler/rank.go:13.
BINPACK_MAX_FIT_SCORE = 18.0


def allocs_fit(node: Node, allocs: List[Allocation],
               net_idx: Optional[NetworkIndex] = None,
               check_devices: bool = False,
               ) -> Tuple[bool, str, ComparableResources]:
    """Would this set of allocations fit on the node?

    Returns (fit, exhausted_dimension, used). Semantics mirror
    reference funcs.go:103: terminal allocs are skipped; node reserved
    resources count as used; port collisions and bandwidth overcommit are
    network-dimension failures; device oversubscription optional.
    """
    used = ComparableResources()
    used.add(node.comparable_reserved_resources())
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        used.add(alloc.comparable_resources())

    ok, dim = node.comparable_resources().superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None:
        net_idx = NetworkIndex()
        collide = net_idx.set_node(node) or net_idx.add_allocs(allocs)
        if collide:
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices:
        acct = DeviceAccounter(node)
        if acct.add_allocs(allocs):
            return False, "device oversubscribed", used

    return True, "", used


def score_fit(node: Node, util: ComparableResources) -> float:
    """Google BestFit-v3 bin-pack score (reference funcs.go:155).

    0 (empty / overfit-clamped) .. 18 (perfectly packed). Higher is better:
    prefers filling nodes.
    """
    res = node.comparable_resources()
    reserved = node.comparable_reserved_resources()
    node_cpu = float(res.cpu) - float(reserved.cpu)
    node_mem = float(res.memory_mb) - float(reserved.memory_mb)
    if node_cpu <= 0 or node_mem <= 0:
        return 0.0

    free_pct_cpu = 1.0 - (float(util.cpu) / node_cpu)
    free_pct_mem = 1.0 - (float(util.memory_mb) / node_mem)

    total = math.pow(10, free_pct_cpu) + math.pow(10, free_pct_mem)
    score = 20.0 - total
    return max(0.0, min(BINPACK_MAX_FIT_SCORE, score))


def filter_terminal_allocs(allocs: List[Allocation]
                           ) -> Tuple[List[Allocation], dict]:
    """Split out server-terminal allocs; keep latest terminal per name.

    Reference: funcs.go FilterTerminalAllocs.
    """
    terminal_by_name = {}
    live = []
    for a in allocs:
        if a.terminal_status():
            prev = terminal_by_name.get(a.name)
            if prev is None or a.create_index > prev.create_index:
                terminal_by_name[a.name] = a
        else:
            live.append(a)
    return live, terminal_by_name


def generate_migrate_token(alloc_id: str, node_secret_id: str) -> str:
    """Token authorizing a REPLACEMENT alloc to read its previous
    alloc's ephemeral disk through the owning agent's fs API
    (reference: structs.GenerateMigrateToken — HMAC of the alloc id
    under the owning NODE's secret, so the serving agent can verify it
    without a server round trip)."""
    import base64
    import hashlib
    import hmac
    mac = hmac.new((node_secret_id or "").encode(),
                   alloc_id.encode(), hashlib.sha256).digest()
    return base64.urlsafe_b64encode(mac).decode().rstrip("=")


def compare_migrate_token(alloc_id: str, node_secret_id: str,
                          token: str) -> bool:
    """Constant-time migrate-token check (reference:
    structs.CompareMigrateToken)."""
    import hmac
    if not token:
        return False
    return hmac.compare_digest(
        generate_migrate_token(alloc_id, node_secret_id), token)
