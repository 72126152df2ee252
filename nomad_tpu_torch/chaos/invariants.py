"""The invariant harness: end-to-end properties checked CONTINUOUSLY
while a fault storm runs, not just at the end of a test.  The
counterpart of `nomad_tpu.chaos.invariants`; the solver side it reads
(`usage()`, `template`, `plane_checksum()`) is the port's resident,
sharded and cross-region solvers'.

The harness is a ledger plus a set of check methods.  The driving loop
feeds it ground truth as it happens (evals enqueued, outcomes reached,
allocs placed, usage committed) and calls the checks at every quiesce
point; each failed check appends a structured violation (and records a
``chaos.invariant_violation`` mesh event) instead of raising, so one
broken invariant never masks the others — `raise_if_violated` turns
the accumulated list into an exception at the end.

Checks:
  * eval conservation — every eval the harness saw enter is accounted
    for across terminal outcomes + broker-resident states + shed lane
    (at-least-once, nothing dropped)
  * no double placement — an alloc id placed on two nodes, or the
    same (eval, placement slot) decided twice, trips immediately
  * usage conservation — per-node device-carried usage equals a
    from-scratch host recompute of the ledger, bit-identical
  * shed/admission balance — offered == admitted + shed, and the
    router's shed lane drains only into readmissions
  * plane checksums — device-resident node planes hash-identical to
    the host template (the raft-fed source of truth) at quiesce
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np


class InvariantViolation(AssertionError):
    """One or more invariants failed during a storm."""


class InvariantHarness:
    def __init__(self, event_log=None):
        if event_log is None:
            from ..utils.tracing import global_mesh_events
            event_log = global_mesh_events
        self.event_log = event_log
        self._lock = threading.Lock()
        self.violations: List[dict] = []
        self.checks_run = 0
        # eval ledger: id -> terminal outcome ("" while in flight)
        self._evals: Dict[str, str] = {}
        # alloc ledger: alloc id -> node id
        self._alloc_nodes: Dict[str, str] = {}
        # usage ledger: node id -> summed usage vector (host recompute)
        self._usage: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ feed
    def note_enqueued(self, eval_id: str) -> None:
        with self._lock:
            self._evals.setdefault(eval_id, "")

    def note_outcome(self, eval_id: str, outcome: str) -> None:
        """Terminal outcome: "acked", "failed", "shed"... — an eval
        reaching two different terminal outcomes is itself a
        violation (a shed eval later acked is fine: readmission
        overwrites "shed")."""
        with self._lock:
            prev = self._evals.get(eval_id)
            if prev is None:
                self._evals[eval_id] = outcome
                return
            if prev and prev != outcome and prev != "shed":
                self._violate_locked(
                    "eval_conservation",
                    f"eval {eval_id} reached {outcome!r} after {prev!r}")
            self._evals[eval_id] = outcome

    def note_placement(self, alloc_id: str, node_id: str) -> None:
        with self._lock:
            prev = self._alloc_nodes.get(alloc_id)
            if prev is not None and prev != node_id:
                self._violate_locked(
                    "double_placement",
                    f"alloc {alloc_id} placed on {node_id} and {prev}")
            self._alloc_nodes[alloc_id] = node_id

    def note_usage(self, node_id: str, vec) -> None:
        vec = np.asarray(vec, np.float32)
        with self._lock:
            cur = self._usage.get(node_id)
            if cur is None:
                self._usage[node_id] = vec.copy()
            else:
                cur += vec

    # ---------------------------------------------------------- checks
    def check_eval_conservation(self, broker=None,
                                shed_pending: int = 0) -> bool:
        """Everything that entered is terminal, in the broker, or in
        the shed lane.  `shed_pending`: evals currently parked in the
        BlockedEvals shed lane (in flight, not lost)."""
        with self._lock:
            total = len(self._evals)
            terminal = sum(1 for o in self._evals.values() if o)
        in_broker = 0
        if broker is not None:
            st = broker.stats()
            in_broker = (st["total_ready"] + st["total_unacked"]
                         + st["total_blocked"] + st["total_waiting"])
        lost = total - terminal - in_broker - int(shed_pending)
        ok = lost == 0
        if not ok:
            self._violate(
                "eval_conservation",
                f"{lost} eval(s) unaccounted for "
                f"(saw {total}, terminal {terminal}, broker "
                f"{in_broker}, shed {shed_pending})")
        self.checks_run += 1
        return ok

    def check_no_double_placement(self) -> bool:
        # dupes trip inline in note_placement; this quiesce-point call
        # exists so the check shows up in checks_run accounting
        self.checks_run += 1
        return not any(v["check"] == "double_placement"
                       for v in self.violations)

    def check_usage_conservation(self, solver,
                                 baseline: Optional[Dict] = None
                                 ) -> bool:
        """Device-carried per-node usage == from-scratch host recompute
        of the ledger, bit-identical.  `solver` is any resident solver
        exposing `usage()` and `template.node_ids`; `baseline` maps
        node id -> usage vector present before the ledger started
        (template used0 at harness start)."""
        used, _dev_used = solver.usage()
        node_ids = solver.template.node_ids
        ok = True
        with self._lock:
            ledger = {k: v.copy() for k, v in self._usage.items()}
        for i, nid in enumerate(node_ids):
            if i >= solver.template.n_real or \
                    not solver.template.valid[i]:
                continue
            expect = np.zeros(used.shape[1], np.float32)
            if baseline is not None and nid in baseline:
                expect = np.asarray(baseline[nid], np.float32).copy()
            if nid in ledger:
                expect = expect + ledger[nid]
            if not np.array_equal(used[i], expect):
                ok = False
                self._violate(
                    "usage_conservation",
                    f"node {nid} carried usage {used[i].tolist()} != "
                    f"recomputed {expect.tolist()}")
        self.checks_run += 1
        return ok

    def check_shed_accounting(self, admission=None, router=None,
                              shed_pending: int = 0) -> bool:
        """offered == admitted + shed on the admission tier; on the
        router, lifetime sheds == readmitted + still parked."""
        ok = True
        if admission is not None:
            st = admission.stats()
            offered = st.get("offered",
                             st["admitted"] + st["shed"])
            if offered != st["admitted"] + st["shed"]:
                ok = False
                self._violate(
                    "shed_accounting",
                    f"admission offered {offered} != admitted "
                    f"{st['admitted']} + shed {st['shed']}")
        if router is not None:
            st = router.stats()
            counts = st.get("counts", st)
            shed = counts.get("shed", 0)
            readmitted = counts.get("readmitted", 0)
            parked = router.shed_depth()
            if shed != readmitted + parked:
                ok = False
                self._violate(
                    "shed_accounting",
                    f"router shed {shed} != readmitted {readmitted} "
                    f"+ parked {parked}")
        if shed_pending < 0:
            ok = False
            self._violate("shed_accounting",
                          f"negative shed lane depth {shed_pending}")
        self.checks_run += 1
        return ok

    def check_plane_checksums(self, solver) -> bool:
        """Device-resident node planes hash-identical to the host
        template (only meaningful at healthy quiesce points — a
        degraded mesh deliberately zeroes lost tiles)."""
        from ..solver.tensorize import template_checksum
        state = getattr(solver, "mesh_state", "healthy")
        if state != "healthy":
            self.checks_run += 1
            return True
        dev = solver.plane_checksum()
        host = template_checksum(solver.template)
        ok = dev == host
        if not ok:
            self._violate(
                "plane_checksum",
                f"device planes {dev:#010x} != template {host:#010x}")
        self.checks_run += 1
        return ok

    # --------------------------------------------------------- results
    def _violate(self, check: str, message: str) -> None:
        with self._lock:
            self._violate_locked(check, message)

    def _violate_locked(self, check: str, message: str) -> None:
        self.violations.append({"check": check, "message": message})
        if self.event_log is not None:
            self.event_log.record("chaos.invariant_violation",
                                  check=check, message=message)

    @property
    def ok(self) -> bool:
        return not self.violations

    def report(self) -> dict:
        with self._lock:
            by_check: Dict[str, int] = {}
            for v in self.violations:
                by_check[v["check"]] = by_check.get(v["check"], 0) + 1
            return {"ok": not self.violations,
                    "checks_run": self.checks_run,
                    "violations": list(self.violations),
                    "violations_by_check": by_check,
                    "evals_seen": len(self._evals),
                    "allocs_seen": len(self._alloc_nodes)}

    def raise_if_violated(self) -> None:
        if self.violations:
            lines = [f"[{v['check']}] {v['message']}"
                     for v in self.violations]
            raise InvariantViolation(
                f"{len(lines)} invariant violation(s):\n"
                + "\n".join(lines))
