"""Leader-side node failure detector.

A single watcher thread over a deadline heap tracks every node's
heartbeat TTL (same pattern as the broker's delayed-eval watcher); expiry
marks the node down and (via the server's node-eval path) reschedules its
allocs. The TTL is rate-scaled to cluster size so aggregate heartbeat QPS
stays bounded (reference: nomad/heartbeat.go:34 nodeHeartbeater,
:90 resetHeartbeatTimer, :104 rate-scaled TTL via lib.RateScaledInterval,
:135 invalidateHeartbeat). The reference uses one time.Timer per node;
one Python thread per node would not scale to the 10K-node target, so
the deadline heap replaces the timer map — a reset simply moves the
node's authoritative deadline, and stale heap entries are skipped.

The counterpart of `nomad_tpu.server.heartbeat`.
"""
from __future__ import annotations

import heapq
import logging
import random
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)


def rate_scaled_interval(rate: float, min_s: float, n: int) -> float:
    """Interval targeting `rate` aggregate actions/sec across n actors
    (reference: consul lib.RateScaledInterval)."""
    if rate <= 0.0:
        return min_s
    interval = n / rate
    return max(interval, min_s)


class NodeHeartbeater:
    """Tracks heartbeat expiry per node (reference: nomad/heartbeat.go:34).

    `on_expire(node_id)` runs on the watcher thread when a node misses its
    TTL; the server wires it to update_node_status(down), which applies the
    status and fans out reschedule evals (SURVEY §3.3).
    """

    def __init__(self, on_expire: Callable[[str], None],
                 min_heartbeat_ttl_s: float = 10.0,
                 max_heartbeats_per_second: float = 50.0,
                 heartbeat_grace_s: float = 10.0,
                 failover_heartbeat_ttl_s: float = 300.0):
        self._on_expire = on_expire
        self.min_ttl = min_heartbeat_ttl_s
        self.max_rate = max_heartbeats_per_second
        self.grace = heartbeat_grace_s
        self.failover_ttl = failover_heartbeat_ttl_s
        # node id -> authoritative deadline; heap entries are advisory and
        # skipped unless they match the authoritative value
        self._deadlines: Dict[str, float] = {}
        self._heap: List[Tuple[float, str]] = []
        self._cv = threading.Condition()
        self._enabled = False
        self._watcher: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def set_enabled(self, enabled: bool) -> None:
        """Leadership gate: the watcher only runs on the leader
        (reference: heartbeat.go:94-100 IsLeader check)."""
        watcher = None
        with self._cv:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                # thread handle guarded by _cv
                self._watcher = threading.Thread(target=self._watch,
                                                 daemon=True)
                self._watcher.start()
            else:
                self._deadlines.clear()
                self._heap.clear()
                watcher, self._watcher = self._watcher, None
                self._cv.notify_all()
        if watcher is not None:
            watcher.join(timeout=1.0)

    def initialize(self, node_ids) -> None:
        """On leadership gain, grant every known live node the failover TTL
        before expecting fresh heartbeats (reference: heartbeat.go:56
        initializeHeartbeatTimers)."""
        with self._cv:
            if not self._enabled:
                return
            now = _time.monotonic()
            for nid in node_ids:
                self._set_deadline_locked(nid, now + self.failover_ttl)
            self._cv.notify_all()

    # ---------------------------------------------------------- heartbeats
    def reset(self, node_id: str) -> Optional[float]:
        """Reset a node's TTL; returns the TTL the client should wait
        before its next heartbeat, or None if not leader
        (reference: heartbeat.go:90 resetHeartbeatTimer)."""
        with self._cv:
            if not self._enabled:
                return None
            n = len(self._deadlines)
            ttl = rate_scaled_interval(self.max_rate, self.min_ttl, n)
            ttl += random.uniform(0, ttl)   # stagger, reference :107
            self._set_deadline_locked(
                node_id, _time.monotonic() + ttl + self.grace)
            self._cv.notify_all()
            return ttl

    def _set_deadline_locked(self, node_id: str, deadline: float) -> None:
        self._deadlines[node_id] = deadline
        heapq.heappush(self._heap, (deadline, node_id))

    def clear(self, node_id: str) -> None:
        """Node became terminal: stop tracking it (the stale heap entry is
        skipped by the watcher; reference: heartbeat.go:171)."""
        with self._cv:
            self._deadlines.pop(node_id, None)

    def active(self) -> int:
        with self._cv:
            return len(self._deadlines)

    # ------------------------------------------------------------- watcher
    def _watch(self) -> None:
        while True:
            expired: List[str] = []
            with self._cv:
                if not self._enabled:
                    return
                now = _time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    deadline, nid = heapq.heappop(self._heap)
                    # only authoritative (not reset-superseded or cleared)
                    # entries expire the node
                    if self._deadlines.get(nid) == deadline:
                        del self._deadlines[nid]
                        expired.append(nid)
                if not expired:
                    wait = 0.5
                    if self._heap:
                        wait = min(wait, max(self._heap[0][0] - now, 0.001))
                    self._cv.wait(wait)
                    continue
            for nid in expired:
                # the callback races node deletion (reap_nodes); an exception
                # here must not kill the watcher and silently disable failure
                # detection for the whole cluster
                try:
                    self._on_expire(nid)
                except Exception:
                    _log.exception(
                        "heartbeat expiry callback failed for node %s", nid)
