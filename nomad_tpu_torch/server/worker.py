"""Scheduler worker: dequeue evals, invoke the scheduler, submit plans.

Reference: nomad/worker.go — run loop :105, dequeueEvaluation :142,
snapshotMinIndex wait :228, invokeScheduler :244, SubmitPlan :277 with
refresh-on-partial-commit :309. The worker is also the scheduler's
Planner (scheduler/scheduler.go:106).

The counterpart of `nomad_tpu.server.worker`.  Each worker's solver runs
on the server's device (`Server(device=...)`: `cuda` unless the caller
asks for the CPU).  `mesh_supervisor` (an
`parallel.sharded.ElasticMeshSupervisor`, or None) is the elastic mesh's
recovery trigger: a node-update eval reports its node's status to it
before the eval is solved.
"""
from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, List, Optional, Tuple

from ..scheduler.base import new_scheduler
from ..structs import Evaluation, Plan, PlanResult

if TYPE_CHECKING:
    from ..scheduler.fleet import SolveCoordinator

DEQUEUE_TIMEOUT_S = 0.2

_log = logging.getLogger(__name__)


class Worker(threading.Thread):
    def __init__(self, server, sched_types: List[str], index: int = 0):
        super().__init__(daemon=True)
        self.server = server
        self.sched_types = list(sched_types)
        #: worker index doubles as the broker home shard: worker i
        #: drains shard i % S first, so at N == S workers each shard has
        #: a dedicated drainer and dequeues never contend on one lock
        self.index = index
        self._shutdown = threading.Event()
        self.paused = threading.Event()
        self._solver = None
        self._solver_lock = threading.Lock()
        #: the elastic mesh's recovery trigger (note_node_event), if any
        self.mesh_supervisor = None

    def fleet_solver(self):
        """One Solver per worker, store-attached: its tensorizer's
        computed-class memo is shared across the fused batch, and its
        resident cluster world advances by changesets (plan-apply feed
        below + the store change log) instead of re-packing the world
        per eval.  It solves on the server's device, with the serving
        tier's eviction-plane width (`evict_e`) when the tier sets one
        (else the world reads `NOMAD_TPU_EVICT_E`).  Locked: the
        coordinator's drain leader reaches in from another worker's
        thread."""
        with self._solver_lock:
            if self._solver is None:
                from ..solver.solve import Solver
                serving = getattr(self.server, "serving", None)
                kw = ({} if getattr(serving, "evict_e", None) is None
                      else {"evict_e": serving.evict_e})
                self._solver = Solver(device=self.server.device,
                                      store=self.server.store, **kw)
            return self._solver

    def shutdown(self) -> None:
        self._shutdown.set()

    def run(self) -> None:
        import time as _t

        from ..utils.metrics import global_metrics as _m
        while not self._shutdown.is_set():
            broker = self.server.broker
            serving = getattr(self.server, "serving", None)
            if self.paused.is_set() and \
                    broker.ready_count() <= self._max_batch():
                # Soft pause (leader CPU hygiene, reference:
                # leader.go:206-212): unlike the reference there are no
                # follower workers to absorb load in this architecture,
                # so a paused worker still wakes while the broker backs
                # up beyond one batch and returns to idle once drained.
                self._shutdown.wait(0.05)
                continue
            target = self._target_batch(serving, broker)
            batch = broker.dequeue_batch(
                self.sched_types, target, DEQUEUE_TIMEOUT_S,
                home=self.index)
            if not batch:
                # idle tick: readmit shed work once the queue drains
                self._readmit_tick(serving)
                continue
            if len(batch) > 1:
                # hold every member's redelivery deadline for the
                # duration of the fused work (see process_fleet, which
                # re-pauses idempotently): an express-lane solve or a
                # slow fused batch must not trigger spurious nack
                # redelivery for the members still waiting their turn
                broker.pause_nack_batch(
                    [(ev.id, token) for ev, token in batch])
            if serving is not None:
                # brownout: degrade the solve wave budget while the
                # queue is saturated (leftovers retry via the normal
                # blocked/requeue path)
                self.fleet_solver().set_degraded(
                    serving.admission.brownout_active())
            t0 = _t.monotonic()
            fused = False
            try:
                fused = self._run_batch(serving, batch)
            except Exception as exc:
                # a poisoned eval must not kill the worker; the nack path
                # redelivers it until the delivery limit parks it — but
                # the failure must be visible: a storm of
                # silent nacks looks exactly like a healthy idle worker
                _log.warning("batch of %d eval(s) failed: %s",
                             len(batch), exc)
                _m.incr_counter("worker.batch_error")
                for ev, token in batch:
                    self.server.broker.nack(ev.id, token)
            if serving is not None:
                wall = _t.monotonic() - t0
                if not fused:
                    # fused rounds feed the sizing model their DEVICE
                    # stage from fleet_finish (note_device_solve): under
                    # pipelining the round wall double-counts the
                    # previous round's occupancy and would over-drain
                    # the close rule
                    serving.solve_model.observe(len(batch), wall)
                # SLO burn-rate accounting + the first explicit-bucket
                # histogram users: batch solve latency on
                # the latency bounds, batch size on pow2 count bounds
                serving.observe_batch(len(batch), wall)
                _m.observe_hist("worker.solve_latency_s", wall)
                _m.observe_hist("worker.batch_size", float(len(batch)),
                                buckets=(1, 2, 4, 8, 16, 32, 64, 128,
                                         256, 512))
                _m.set_gauge("serving.last_target_batch", float(target))
                _m.set_gauge(
                    "serving.brownout",
                    1.0 if serving.admission.brownout_active() else 0.0)
                self._readmit_tick(serving)

    def _max_batch(self) -> int:
        serving = getattr(self.server, "serving", None)
        if serving is not None and serving.adaptive:
            return serving.max_batch
        return self.server.batch_size

    def _target_batch(self, serving, broker) -> int:
        """Adaptive micro-batch sizing (serving tier): queue depth +
        oldest ready age + the EWMA solve-time model pick the largest
        batch that keeps age + predicted solve inside the SLO budget.
        Falls back to the fixed batch_size when the tier is disabled."""
        if serving is None or not serving.adaptive:
            return self.server.batch_size
        return serving.batch_controller.target_batch(
            broker.ready_count(), broker.oldest_ready_age())

    def _run_batch(self, serving, batch) -> bool:
        """Run one dequeued batch; returns True when the fused
        (coordinator / process_fleet) path handled the bulk lane, i.e.
        the sizing model was already fed device time by fleet_finish."""
        from ..utils.tracing import global_tracer as _tr
        if len(batch) == 1:
            _tr.event(batch[0][0].id, "worker.batch", batch_size=1,
                      lane="single")
            self._process(*batch[0])
            return False
        express, bulk = [], []
        bypass = serving.bypass_priority if serving is not None else None
        for ev, token in batch:
            if bypass is not None and ev.priority >= bypass:
                express.append((ev, token))
            else:
                bulk.append((ev, token))
        for ev, _tok in express:
            _tr.event(ev.id, "worker.batch", batch_size=len(batch),
                      lane="express")
        for ev, _tok in bulk:
            _tr.event(ev.id, "worker.batch", batch_size=len(batch),
                      lane="bulk" if len(bulk) > 1 else "single")
        # bypass lane: interactive/high-priority evals solve singly
        # FIRST, ahead of the fused bulk solve
        for ev, token in express:
            self._process(ev, token)
        if len(bulk) == 1:
            self._process(*bulk[0])
            return False
        elif bulk:
            coordinator: Optional[SolveCoordinator] = getattr(
                self.server, "solve_coordinator", None)
            if coordinator is not None:
                # cross-worker fusion: park on the coordinator so this
                # batch rides one combined device wave with whatever the
                # other workers dequeued (errors re-raise here and the
                # run-loop nack path owns our evals)
                coordinator.submit(self, bulk)
            else:
                from ..scheduler.fleet import process_fleet
                process_fleet(self.server, self, bulk)
            return True
        return False

    def _readmit_tick(self, serving) -> None:
        """Pop admission-shed evals back into the broker once the queue
        has drained below the low watermark (restore-on-drain)."""
        if serving is None:
            return
        quota = serving.admission.readmit_quota(
            self.server.broker.ready_count(),
            batch=serving.max_batch)
        if quota <= 0:
            return
        for ev in self.server.blocked_evals.pop_shed(quota):
            self.server.broker.enqueue(ev)

    def _process(self, ev: Evaluation, token: str) -> None:
        import time as _t

        from ..utils.metrics import global_metrics as _m
        server = self.server
        _m.incr_counter("worker.dequeue_eval")
        # the raft catch-up + solve + plan wait can exceed the nack
        # timeout; hold the timer while we own the eval
        server.broker.pause_nack_timeout(ev.id, token)
        # wait for local state to reach the eval's creation point
        # (reference metric: nomad.worker.wait_for_index)
        from ..utils.tracing import global_tracer as _tr
        wait_index = max(ev.modify_index, ev.snapshot_index)
        t0 = _t.monotonic()
        with _tr.stage(ev.id, "worker.wait_index", index=wait_index):
            server.store.wait_for_index(wait_index, timeout=5.0)
        _m.measure_since("worker.wait_for_index", t0)
        if self.mesh_supervisor is not None and ev.node_id:
            from ..structs import EVAL_TRIGGER_NODE_UPDATE
            if ev.triggered_by == EVAL_TRIGGER_NODE_UPDATE:
                # a mesh-host node going down fails its shard BEFORE this
                # eval solves, so the solve runs at degraded width; its
                # return to ready triggers the rejoin
                node = server.store.snapshot().node_by_id(ev.node_id)
                if node is not None:
                    self.mesh_supervisor.note_node_event(ev.node_id,
                                                         node.status)
        _invoke_t0 = _t.monotonic()
        try:
            from ..structs import JOB_TYPE_CORE
            if ev.type == JOB_TYPE_CORE:
                # administrative GC runs against a snapshot and reaps
                # through the server (worker.go:258, core_sched.go:46)
                from ..scheduler.core import CoreScheduler
                CoreScheduler(server, server.store.snapshot()).process(ev)
                err = None
            else:
                sched = new_scheduler(ev.type, server.store, self,
                                      solver=self.fleet_solver())
                err = sched.process(ev)
        except Exception as e:
            # record the failure on the eval so a parked (delivery-limited)
            # eval isn't restored as pending after a leader restart
            import copy
            from ..structs import EVAL_STATUS_FAILED
            failed = copy.copy(ev)
            failed.status = EVAL_STATUS_FAILED
            failed.status_description = f"scheduler error: {e}"
            server.upsert_evals([failed])
            server.broker.nack(ev.id, token)
            return
        finally:
            # reference metric: nomad.worker.invoke_scheduler_<type>
            _m.measure_since(f"worker.invoke_scheduler_{ev.type}",
                             _invoke_t0)
        if err is not None:
            server.broker.nack(ev.id, token)
        else:
            server.broker.ack(ev.id, token)

    # ---------------------------------------------------- Planner interface
    def submit_plan(self, plan: Plan
                    ) -> Tuple[Optional[PlanResult], Optional[object]]:
        import time as _t

        from ..utils.metrics import global_metrics as _m
        from ..utils.tracing import global_tracer as _tr
        t0 = _t.monotonic()
        sp = _tr.stage(plan.eval_id, "plan.submit",
                       n_alloc=sum(len(v) for v in
                                   plan.node_allocation.values()),
                       n_stop=sum(len(v) for v in
                                  plan.node_update.values()))
        pending = self.server.plan_queue.enqueue(plan)
        if pending is None:
            sp.end(outcome="queue_disabled")
            return None, None
        # no deadline, as Nomad's Worker.SubmitPlan: the applier answers
        # every plan it takes, with an error when it stops or loses
        # leadership (a plan whose apply outlasted a deadline would fail
        # its eval while the plan still stands)
        result, err = pending.future.wait()
        # reference metric: nomad.worker.submit_plan (p50/p99 plan-submit
        # latency — the BASELINE.md headline latency metric)
        _m.measure_since("worker.submit_plan", t0)
        if err is not None or result is None:
            sp.end(outcome=f"error: {err}" if err else "no result")
            return None, None
        sp.end(outcome="applied", alloc_index=result.alloc_index,
               refresh_index=result.refresh_index)
        # feed the applied changeset into the solver's resident world:
        # the next eval's solve starts from already-advanced tensors
        # (the change-log sync then dedups these same writes)
        if self._solver is not None:
            self._solver.note_plan_result(plan, result)
        if result.refresh_index:
            # partial commit: catch up past the conflicting writes and hand
            # the scheduler a fresh snapshot to retry against
            self.server.store.wait_for_index(result.refresh_index,
                                             timeout=5.0)
            return result, self.server.store.snapshot()
        return result, None

    def update_eval(self, ev: Evaluation) -> None:
        self.server.upsert_evals([ev])

    def create_eval(self, ev: Evaluation) -> None:
        self.server.upsert_evals([ev])

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.blocked_evals.block(ev)
