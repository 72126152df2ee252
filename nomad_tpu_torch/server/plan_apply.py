"""The plan applier — the single serialization point of the control plane.

Workers plan optimistically against snapshots; this component re-validates
every plan against the LATEST state before commit, dropping per-node
placements that no longer fit, and hands partial committers a refresh
index so they retry against fresh data.

Reference: nomad/plan_apply.go — planApply loop :71-178, evaluatePlan
:399, evaluatePlanPlacements :436 (per-node fit re-check with partial
commit + RefreshIndex :568-584), evaluateNodePlan :628, applyPlan :204,
plan_apply_pool.go (per-node verify fan-out over NumCPU/2 workers).

PIPELINING: plan N's raft consensus round trip overlaps plan N+1's
evaluation — the applier evaluates N+1 against plan N's KNOWN result
overlaid on the snapshot (`_OverlaySnapshot`), dispatches N+1's raft
apply, and waits/responds for N before it takes N+2 (the reference
overlaps the same region via applyPlan's async raft future +
asyncPlanWait; it re-snapshots at min-index instead of overlaying,
trading the extra wait for a narrower optimism window — both designs
accept the same hazard class, writes landing between evaluate and
apply).  N's wait and answer run on the applier's finisher thread
while the loop dispatches N+1: the single-server raft applies an entry
inside the dispatch, and answering N after it would hold N's worker
for the whole of N+1's apply.  The loop joins the finisher before it
evaluates N+2, so N+2 is evaluated against a store that holds N plus
N+1's overlay, and at most one plan is answered (and its CSI volumes
claimed) at a time.  A plan is only held outstanding while another is
ALREADY queued, so a singleton plan keeps today's latency.

The counterpart of `nomad_tpu.server.plan_apply`.  The port's applier
waits for a dispatched apply with no deadline (raft answers it, or
raises when leadership is lost or raft stops), and `stop()` answers
every plan the applier holds with an error: the workers wait for their
plans with no deadline either, as Nomad's do.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import (EVAL_TRIGGER_PREEMPTION, Allocation, Evaluation, Plan,
                       PlanResult)
from ..structs.funcs import allocs_fit
from .plan_queue import PendingPlan, PlanQueue

# applier callback: (plan, result) -> commit index. In the single-server
# build this writes the state store directly; under raft it is the
# ApplyPlanResults log entry.
ApplyFn = Callable[[Plan, PlanResult], int]


def evaluate_node_plan(snapshot, plan: Plan, node_id: str
                       ) -> Tuple[bool, str]:
    """Can this node accommodate the plan's allocations for it?
    (reference: plan_apply.go:628)."""
    new_allocs = plan.node_allocation.get(node_id, [])
    if not new_allocs:
        return True, ""
    node = snapshot.node_by_id(node_id)
    if node is None:
        return False, "node does not exist"
    if node.terminal_status():
        return False, "node is not ready for placements"
    if node.drain or not node.ready():
        return False, "node is not eligible"

    existing = [a for a in snapshot.allocs_by_node(node_id)
                if not a.terminal_status()]
    remove_ids = {a.id for a in plan.node_update.get(node_id, [])}
    remove_ids.update(a.id for a in plan.node_preemptions.get(node_id, []))
    proposed = [a for a in existing if a.id not in remove_ids]
    # an update of an existing alloc replaces it
    new_ids = {a.id for a in new_allocs}
    proposed = [a for a in proposed if a.id not in new_ids]
    proposed.extend(new_allocs)

    fit, reason, _used = allocs_fit(node, proposed, check_devices=True)
    if not fit:
        return False, reason or "does not fit"
    return True, ""


class _OverlaySnapshot:
    """A snapshot with an in-flight plan's result applied on top: the
    applier KNOWS what plan N will commit, so plan N+1 validates
    against base+N without waiting for the raft apply (reference
    analog: plan_apply.go's "snapshot at min-index" — ours trades that
    wait for an optimistic overlay)."""

    def __init__(self, base, result: PlanResult):
        self._base = base
        self._extra: Dict[str, List[Allocation]] = {
            nid: list(allocs)
            for nid, allocs in result.node_allocation.items()}
        removed = set()
        for allocs in result.node_update.values():
            removed.update(a.id for a in allocs)
        for allocs in result.node_preemptions.values():
            removed.update(a.id for a in allocs)
        self._removed = removed

    def allocs_by_node(self, node_id: str):
        # idempotent whether or not the overlaid plan has ALREADY been
        # applied to the base (the base is a fresh snapshot racing the
        # consensus thread): stops/preemptions filter by id, placements
        # replace any same-id alloc the base may carry
        extra = self._extra.get(node_id, ())
        extra_ids = {a.id for a in extra}
        base = [a for a in self._base.allocs_by_node(node_id)
                if a.id not in self._removed and a.id not in extra_ids]
        return base + list(extra)

    def __getattr__(self, name):
        return getattr(self._base, name)


#: per-node verify fan-out (reference: plan_apply_pool.go NumCPU/2
#: workers); small plans stay on the applier thread
_POOL_MIN_NODES = 16
_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _verify_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=max(2, (os.cpu_count() or 4) // 2),
                thread_name_prefix="plan-verify")
        return _pool


def evaluate_plan(snapshot, plan: Plan) -> PlanResult:
    """Re-check the whole plan against `snapshot`, keeping only nodes that
    still fit; partial results carry a refresh index."""
    # stops always commit; placements and the preemptions that make room
    # for them are gated per node on the fit re-check
    result = PlanResult(
        node_update=dict(plan.node_update),
        deployment=plan.deployment,
        deployment_updates=list(plan.deployment_updates))

    if plan.all_at_once:
        # all-or-nothing: any failing node voids every placement
        for node_id in plan.node_allocation:
            ok, _why = evaluate_node_plan(snapshot, plan, node_id)
            if not ok:
                result.node_allocation = {}
                result.deployment = None
                result.deployment_updates = []
                result.refresh_index = snapshot.latest_index() \
                    if hasattr(snapshot, "latest_index") else snapshot.index
                return result
        result.node_allocation = dict(plan.node_allocation)
        result.node_preemptions = dict(plan.node_preemptions)
        return result

    partial = False
    node_ids = list(plan.node_allocation)
    if len(node_ids) >= _POOL_MIN_NODES:
        oks = list(_verify_pool().map(
            lambda nid: evaluate_node_plan(snapshot, plan, nid)[0],
            node_ids))
    else:
        oks = [evaluate_node_plan(snapshot, plan, nid)[0]
               for nid in node_ids]
    for node_id, ok in zip(node_ids, oks):
        if ok:
            result.node_allocation[node_id] = plan.node_allocation[node_id]
            if node_id in plan.node_preemptions:
                result.node_preemptions[node_id] = \
                    plan.node_preemptions[node_id]
        else:
            partial = True
    if partial:
        result.refresh_index = max(snapshot.table_index("nodes"),
                                   snapshot.table_index("allocs"))
        # a partial commit voids the deployment objects — the scheduler
        # recreates them on retry (reference: plan_apply.go:560-566)
        result.deployment = None
        result.deployment_updates = []
    return result


class _Outstanding:
    """A dispatched-but-unacknowledged apply: one plan, or a
    group-commit batch of K plans riding a single raft entry (one
    fsync); each member keeps its own future + result."""
    __slots__ = ("items", "finish", "done", "lock")

    def __init__(self, items, finish):
        self.items = items            # [(pending, plan, result), ...]
        self.finish = finish          # blocks until raft-applied
        self.done = False             # set by the one _finalize
        self.lock = threading.Lock()  # makes that claim atomic


class PlanApplier:
    """Owns the applier loop: dequeue pending plan -> evaluate ->
    apply, pipelined when plans are queued back to back (see module
    docstring)."""

    def __init__(self, queue: PlanQueue, store, apply_fn: ApplyFn,
                 create_evals: Optional[Callable[[List[Evaluation]], None]]
                 = None, apply_async_fn=None, apply_batch_async_fn=None,
                 group_commit: int = 1):
        self.queue = queue
        self.store = store
        self.apply_fn = apply_fn
        self.apply_async_fn = apply_async_fn
        #: group commit: batch fn takes [(plan, result)] and
        #: dispatches ONE raft entry carrying all K results; group_commit
        #: caps K.  Plans are only grouped when already queued back to
        #: back, so a singleton keeps the unbatched latency.
        self.apply_batch_async_fn = apply_batch_async_fn
        self.group_commit = max(1, int(group_commit))
        self.create_evals = create_evals
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the plans taken off the queue and not yet answered (answered
        # ones are pruned as new ones come): stop() answers them
        self._held_lock = threading.Lock()
        self._held: List[PendingPlan] = []
        # answers dispatched applies while the loop dispatches the next
        # (the loop's own; None outside it: apply_one answers in line)
        self._finisher: Optional[ThreadPoolExecutor] = None

    def start(self) -> None:
        self._stop.clear()
        thread = threading.Thread(target=self._run, daemon=True)
        with self._held_lock:
            self._thread = thread
        thread.start()

    def stop(self) -> None:
        """Stop the loop and answer every plan it holds with an error, so
        no worker waits on a plan whose apply is still in flight (its
        eval is nacked and runs again under the next leader, which
        applies the log first)."""
        with self._held_lock:
            self._stop.set()
            held, self._held = self._held, []
        for pending in held:
            pending.future.respond(None, "plan applier stopped")
        if self._thread:
            self._thread.join(timeout=2.0)

    def _hold(self, pending: PendingPlan) -> bool:
        """Hold a plan taken off the queue until it is answered; once the
        applier is stopping, answer it at once and return False (the
        caller leaves it unapplied)."""
        with self._held_lock:
            if self._stop.is_set():
                pending.future.respond(None, "plan applier stopped")
                return False
            self._held = [p for p in self._held if not p.future.done()]
            self._held.append(pending)
        return True

    def _run(self) -> None:
        finisher = ThreadPoolExecutor(1, thread_name_prefix="plan-finish")
        with self._held_lock:
            self._finisher = finisher
        try:
            self._loop()
        finally:
            with self._held_lock:
                self._finisher = None
            finisher.shutdown(wait=True)

    def _loop(self) -> None:
        out: Optional[_Outstanding] = None
        while not self._stop.is_set():
            # only hold a plan outstanding while another is already
            # queued: a singleton plan is finalized immediately and
            # keeps the unpipelined latency
            pending = self.queue.dequeue(0.0 if out is not None else 0.2)
            if pending is None:
                if out is not None:
                    out = self._finalize(out)
                continue
            if not self._hold(pending):
                continue
            # clear the outstanding slot BEFORE the raising path:
            # apply_one owns `prev` from here (it finalizes it on every
            # branch, and _finalize never raises), so an exception out
            # of apply_one can no longer leave a consumed _Outstanding
            # in the loop slot to be finalized — and its future
            # responded — a second time
            prev, out = out, None
            try:
                out = self.apply_one(pending, prev)
            except Exception as e:   # keep the applier alive
                pending.future.respond(None, f"plan apply error: {e}")
        if out is not None:
            self._finalize(out)

    def apply_one(self, pending: PendingPlan,
                  out: Optional[_Outstanding] = None
                  ) -> Optional[_Outstanding]:
        try:
            return self._apply_one(pending, out)
        except Exception:
            # the handed-over outstanding plan must reach its finalize
            # exactly once even when THIS plan's evaluate/dispatch blows
            # up — _finalize error-responds internally and never raises
            if out is not None:
                self._finalize(out)
            raise

    def _apply_one(self, pending: PendingPlan,
                   out: Optional[_Outstanding]
                   ) -> Optional[_Outstanding]:
        from ..utils.metrics import global_metrics as _m
        _m.set_gauge("plan.queue_depth", self.queue.depth()
                     if hasattr(self.queue, "depth") else 0)
        # group commit: opportunistically drain up to K-1 more queued
        # plans into this round — never waits, so an idle queue keeps
        # the per-plan latency and a saturated one amortizes the fsync
        group = [pending]
        if self.apply_batch_async_fn is not None and self.group_commit > 1:
            while len(group) < self.group_commit:
                extra = self.queue.dequeue(0.0)
                if extra is None:
                    break
                if not self._hold(extra):
                    break
                group.append(extra)
        snapshot = self.store.snapshot()
        if out is not None:
            # evaluate against base + the in-flight plans' known results
            # (the overlay is idempotent if the apply already landed)
            for _p, _pl, res in out.items:
                snapshot = _OverlaySnapshot(snapshot, res)
        items = []
        for p in group:
            try:
                with _m.timed("plan.evaluate"):
                    result = evaluate_plan(snapshot, p.plan)
            except Exception as e:
                # a poisoned group member must not strand the others
                p.future.respond(None, f"plan apply error: {e}")
                continue
            if result.is_no_op() and not result.refresh_index:
                p.future.respond(result, None)
                continue
            items.append((p, p.plan, result))
            # later members validate against earlier members' results:
            # intra-batch conflicts surface as partial commits exactly
            # as they would pipelined one by one
            snapshot = _OverlaySnapshot(snapshot, result)
        answered = None
        if out is not None:
            # N+1 is evaluated: N is answered beside N+1's async dispatch
            # (in line when there is none), and before N+2 is evaluated
            # (see the module docstring)
            finisher = self._finisher
            if finisher is None or not self._dispatches_async(items):
                self._finalize(out)
            else:
                answered = finisher.submit(self._finalize, out)
        try:
            return self._dispatch(items)
        finally:
            if answered is not None:
                answered.result()

    def _dispatches_async(self, items) -> bool:
        if len(items) > 1:
            return self.apply_batch_async_fn is not None
        return len(items) == 1 and self.apply_async_fn is not None

    def _dispatch(self, items) -> Optional[_Outstanding]:
        """Start the apply of this round's evaluated plans: the
        outstanding apply when raft is asynchronous, else apply and
        answer them in line (None)."""
        from ..utils.metrics import global_metrics as _m
        if not items:
            return None
        if len(items) > 1 and self.apply_batch_async_fn is not None:
            try:
                index, finish = self.apply_batch_async_fn(
                    [(pl, res) for _p, pl, res in items])
            except Exception as e:
                for p, _pl, _res in items:
                    p.future.respond(None, f"plan apply error: {e}")
                return None
            _m.incr_counter("plan.group_commits")
            _m.incr_counter("plan.raft_applies")
            _m.add_sample("plan.group_commit_size", float(len(items)))
            return _Outstanding(items, finish)
        if self.apply_async_fn is not None and len(items) == 1:
            p, plan, result = items[0]
            index, finish = self.apply_async_fn(plan, result)
            _m.incr_counter("plan.raft_applies")
            return _Outstanding(items, finish)
        # legacy synchronous path (no async apply wired)
        for p, plan, result in items:
            with _m.timed("plan.apply"):
                index = self.apply_fn(plan, result)
            result.alloc_index = index
            self._account_and_respond(p, plan, result)
        return None

    def _finalize(self, out: _Outstanding):
        """Wait out a dispatched apply and respond every member future —
        exactly once, never raising: every failure path error-responds
        instead (PlanFuture.respond is first-wins, so a partial
        _account_and_respond that already delivered the result cannot
        be overwritten by the trailing error)."""
        from ..utils.metrics import global_metrics as _m
        with out.lock:
            if out.done:
                return None
            out.done = True
        try:
            with _m.timed("plan.apply"):
                index = out.finish()
        except Exception as e:
            for pending, _plan, _result in out.items:
                pending.future.respond(None, f"plan apply error: {e}")
            return None
        for pending, plan, result in out.items:
            result.alloc_index = index
            try:
                self._account_and_respond(pending, plan, result)
            except Exception as e:
                pending.future.respond(None, f"plan apply error: {e}")
        return None

    def _account_and_respond(self, pending, plan: Plan,
                             result: PlanResult) -> None:
        from ..utils.metrics import global_metrics as _m
        from ..utils.tracing import global_tracer as _tr
        if result.refresh_index:
            _m.incr_counter("plan.partial_commit")
        _m.incr_counter("plan.node_allocations",
                        sum(len(v) for v in result.node_allocation.values()))
        _tr.event(plan.eval_id, "plan.apply",
                  n_alloc=sum(len(v)
                              for v in result.node_allocation.values()),
                  n_stop=sum(len(v) for v in result.node_update.values()),
                  n_preempt=sum(len(v)
                                for v in result.node_preemptions.values()),
                  partial=bool(result.refresh_index),
                  alloc_index=result.alloc_index)
        # preempted allocs need follow-up evals for their jobs
        if self.create_evals and plan.node_preemptions:
            preempted_jobs = {}
            for allocs in plan.node_preemptions.values():
                for a in allocs:
                    preempted_jobs[(a.namespace, a.job_id)] = a
            evals = []
            for (ns, job_id), a in preempted_jobs.items():
                evals.append(Evaluation(
                    namespace=ns, job_id=job_id,
                    type=a.job.type if a.job else "service",
                    priority=a.job.priority if a.job else 50,
                    triggered_by=EVAL_TRIGGER_PREEMPTION))
            self.create_evals(evals)
        pending.future.respond(result, None)
