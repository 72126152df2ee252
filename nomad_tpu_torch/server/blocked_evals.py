"""BlockedEvals: evals that failed placement, waiting for capacity.

Reference: nomad/blocked_evals.go — Block :166, class/quota-keyed Unblock
:418, UnblockNode :501, missed-unblock index check :316, per-job dedup
with duplicate surfacing :642.

Extension (serving tier): a `shed` lane for evals the
admission controller refused at ingress under overload.  Shed evals are
never dropped — they share the per-job dedup/duplicate machinery with
capacity-blocked evals and are popped back into the broker in priority
order by `pop_shed` once the queue drains (the worker's readmit tick).
Unlike capacity-blocked evals they do NOT unblock on capacity change:
they wait on queue drain, not on node state.

The counterpart of `nomad_tpu.server.blocked_evals`.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Tuple

from ..structs import EVAL_STATUS_PENDING, Evaluation


class BlockedEvals:
    def __init__(self, broker):
        self._lock = threading.Lock()
        self._broker = broker
        self._enabled = False
        self._captured: Dict[str, Evaluation] = {}
        self._escaped: Dict[str, Evaluation] = {}
        self._by_job: Dict[Tuple[str, str], str] = {}
        self._by_node: Dict[str, List[str]] = {}   # system evals per node
        self._node_of: Dict[str, str] = {}         # eval id -> node id
        self._duplicates: List[Evaluation] = []
        self._dup_event = threading.Event()
        # class -> latest state index at which capacity changed; an eval
        # blocked with an older snapshot may have missed that unblock
        self._unblock_indexes: Dict[str, int] = {}
        # admission-shed evals: id -> eval plus a max-priority
        # pop order; total_shed counts lifetime sheds for the stats line
        self._shed: Dict[str, Evaluation] = {}
        self._shed_heap: List[tuple] = []
        self._shed_count = itertools.count()
        self._sheds_total = 0

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()
                self._by_job.clear()
                self._by_node.clear()
                self._duplicates.clear()
                self._unblock_indexes.clear()
                self._shed.clear()
                self._shed_heap.clear()

    @property
    def enabled(self) -> bool:
        with self._lock:    # guarded by _lock: see set_enabled
            return self._enabled

    # --------------------------------------------------------------- block
    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            if (ev.id in self._captured or ev.id in self._escaped
                    or ev.id in self._shed):
                return
            namespaced = (ev.namespace, ev.job_id)
            existing_id = self._by_job.get(namespaced)
            if existing_id is not None and existing_id != ev.id:
                # one blocked eval per job: newer wins, older surfaces as a
                # duplicate for cancellation
                old = self._captured.pop(existing_id, None) \
                    or self._escaped.pop(existing_id, None) \
                    or self._shed.pop(existing_id, None)
                if old is not None:
                    self._scrub_node_locked(existing_id)
                    self._duplicates.append(old)
                    self._dup_event.set()
            self._by_job[namespaced] = ev.id

            # missed-unblock check: capacity may have changed between the
            # scheduler's snapshot and now
            if self._missed_unblock_locked(ev):
                self._by_job.pop(namespaced, None)
                self._broker.enqueue(_reset(ev))
                return

            if ev.escaped_computed_class or not ev.class_eligibility:
                self._escaped[ev.id] = ev
            else:
                self._captured[ev.id] = ev
            if ev.node_id:
                self._by_node.setdefault(ev.node_id, []).append(ev.id)
                self._node_of[ev.id] = ev.node_id

    def _missed_unblock_locked(self, ev: Evaluation) -> bool:
        if not ev.snapshot_index:
            return False
        for cls, index in self._unblock_indexes.items():
            if index <= ev.snapshot_index:
                continue
            elig = ev.class_eligibility.get(cls)
            if elig is None or elig:
                # unseen or eligible class changed after our snapshot
                return True
            if ev.escaped_computed_class:
                return True
        return False

    # ---------------------------------------------------------------- shed
    def shed(self, ev: Evaluation) -> None:
        """Park an admission-shed eval (serving tier backpressure).
        Same per-job dedup as block(): newer wins, the displaced eval
        surfaces as a duplicate for cancellation — shedding never
        silently drops work."""
        with self._lock:
            if not self._enabled:
                return
            if (ev.id in self._shed or ev.id in self._captured
                    or ev.id in self._escaped):
                return
            namespaced = (ev.namespace, ev.job_id)
            existing_id = self._by_job.get(namespaced)
            if existing_id is not None and existing_id != ev.id:
                old = self._captured.pop(existing_id, None) \
                    or self._escaped.pop(existing_id, None) \
                    or self._shed.pop(existing_id, None)
                if old is not None:
                    self._scrub_node_locked(existing_id)
                    self._duplicates.append(old)
                    self._dup_event.set()
            if ev.job_id:
                self._by_job[namespaced] = ev.id
            self._shed[ev.id] = ev
            heapq.heappush(self._shed_heap,
                           (-ev.priority, next(self._shed_count), ev.id))
            self._sheds_total += 1

    def pop_shed(self, max_n: int) -> List[Evaluation]:
        """Pop up to max_n shed evals in (priority desc, shed order)
        for readmission; the caller re-enqueues them on the broker.
        Stale heap entries (displaced by a newer eval for the job) are
        skipped — the newer eval owns the job slot."""
        out: List[Evaluation] = []
        with self._lock:
            while self._shed_heap and len(out) < max_n:
                _, _, eid = heapq.heappop(self._shed_heap)
                ev = self._shed.pop(eid, None)
                if ev is None:
                    continue
                self._by_job.pop((ev.namespace, ev.job_id), None)
                out.append(ev)
        return [_reset(ev) for ev in out]

    def shed_count(self) -> int:
        with self._lock:
            return len(self._shed)

    # ------------------------------------------------------------- unblock
    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity changed on nodes of `computed_class` at state `index`."""
        with self._lock:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            unblock: List[Evaluation] = []
            for eid, ev in list(self._escaped.items()):
                unblock.append(ev)
                del self._escaped[eid]
            for eid, ev in list(self._captured.items()):
                elig = ev.class_eligibility.get(computed_class)
                if elig is None or elig:
                    unblock.append(ev)
                    del self._captured[eid]
            for ev in unblock:
                self._by_job.pop((ev.namespace, ev.job_id), None)
                self._scrub_node_locked(ev.id)
        for ev in unblock:
            self._broker.enqueue(_reset(ev))

    def unblock_all(self, index: int) -> None:
        with self._lock:
            if not self._enabled:
                return
            evs = list(self._captured.values()) + list(self._escaped.values())
            self._captured.clear()
            self._escaped.clear()
            self._by_job.clear()
            self._by_node.clear()
            self._node_of.clear()
        for ev in evs:
            self._broker.enqueue(_reset(ev))

    def unblock_node(self, node_id: str, index: int) -> None:
        with self._lock:
            if not self._enabled:
                return
            ids = self._by_node.pop(node_id, [])
            evs = []
            for eid in ids:
                self._node_of.pop(eid, None)
                ev = self._captured.pop(eid, None) \
                    or self._escaped.pop(eid, None)
                if ev is not None:
                    self._by_job.pop((ev.namespace, ev.job_id), None)
                    evs.append(ev)
        for ev in evs:
            self._broker.enqueue(_reset(ev))

    # ------------------------------------------------------------ plumbing
    def untrack(self, namespace: str, job_id: str) -> None:
        """Job deregistered: drop its blocked eval."""
        with self._lock:
            eid = self._by_job.pop((namespace, job_id), None)
            if eid:
                self._captured.pop(eid, None)
                self._escaped.pop(eid, None)
                self._shed.pop(eid, None)
                self._scrub_node_locked(eid)

    def _scrub_node_locked(self, eval_id: str) -> None:
        nid = self._node_of.pop(eval_id, None)
        if nid is None:
            return
        ids = self._by_node.get(nid)
        if ids:
            ids = [i for i in ids if i != eval_id]
            if ids:
                self._by_node[nid] = ids
            else:
                del self._by_node[nid]

    def get_duplicates(self, timeout: float = 0.0) -> List[Evaluation]:
        if timeout:
            self._dup_event.wait(timeout)
        with self._lock:
            dups = self._duplicates
            self._duplicates = []
            self._dup_event.clear()
            return dups

    def stats(self) -> dict:
        with self._lock:
            return {
                "total_blocked": len(self._captured),
                "total_escaped": len(self._escaped),
                "total_shed": len(self._shed),
                "sheds_lifetime": self._sheds_total,
            }


def _reset(ev: Evaluation) -> Evaluation:
    import copy
    e = copy.copy(ev)
    e.status = EVAL_STATUS_PENDING
    e.status_description = ""
    return e
