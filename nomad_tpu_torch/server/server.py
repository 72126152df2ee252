"""Server: replicated state + broker + workers + plan applier.

This is the control-plane container (reference: nomad/server.go Server +
the FSM apply paths in nomad/fsm.go). Every write is proposed as a typed
entry through a raft node (`raft/`) and applied to the state
store by the FSM on commit — identically on leader and followers. The
default deployment is a bootstrapped single-node cluster (immediate
commits, optionally durable via data_dir); multi-server clusters share a
transport and elect a leader, and only the leader runs the broker,
workers, heartbeater, watchers and plan applier
(reference: leader.go:197 establishLeadership / :1018 revokeLeadership).

The counterpart of `nomad_tpu.server.server`, with one addition: the
`device` argument, handed to every worker's solver (`None` means `cuda`,
which raises at the first solve where no GPU is present; the tests pass
"cpu").  Multi-server clusters ride the in-process transport or the
TCP one (`rpc.endpoints.serve_cluster`), and `attach_gossip` wires
gossip membership to the autopilot's dead-server cleanup.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from ..raft import NotLeaderError, RaftConfig, RaftNode, StateFSM
from ..utils.codec import to_wire

from ..state.store import StateStore
from ..structs import (ALLOC_CLIENT_FAILED, CORE_JOB_PRIORITY,
                       EVAL_STATUS_PENDING,
                       EVAL_TRIGGER_DEPLOYMENT_PROMOTION,
                       EVAL_TRIGGER_DEPLOYMENT_WATCHER,
                       EVAL_TRIGGER_NODE_DRAIN,
                       EVAL_TRIGGER_JOB_DEREGISTER,
                       EVAL_TRIGGER_JOB_REGISTER, EVAL_TRIGGER_NODE_UPDATE,
                       EVAL_TRIGGER_RETRY_FAILED_ALLOC, JOB_TYPE_CORE,
                       JOB_TYPE_SERVICE, NODE_STATUS_DOWN, NODE_STATUS_READY,
                       SCHEDULERS, Allocation, Evaluation, Job, Node, Plan,
                       PlanResult)
from ..utils.ids import generate_uuid
from ..utils.timetable import TimeTable
from .blocked_evals import BlockedEvals
from .eval_broker import EvalBroker
from .heartbeat import NodeHeartbeater
from .periodic import PeriodicDispatcher
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

_log = logging.getLogger(__name__)


class JobValidationError(ValueError):
    """A job failed structural validation at registration (maps to
    HTTP 400, distinct from the check-and-set index conflict's 409)."""


class Server:
    def __init__(self, num_workers: Optional[int] = None,
                 enabled_schedulers: Optional[List[str]] = None,
                 batch_size: int = 8,
                 min_heartbeat_ttl_s: float = 10.0,
                 heartbeat_grace_s: float = 10.0,
                 failover_heartbeat_ttl_s: float = 300.0,
                 gc_interval_s: float = 300.0,
                 job_gc_threshold_s: float = 4 * 3600.0,
                 eval_gc_threshold_s: float = 3600.0,
                 node_gc_threshold_s: float = 24 * 3600.0,
                 deployment_gc_threshold_s: float = 3600.0,
                 raft_config: Optional[RaftConfig] = None,
                 raft_transport=None,
                 serving_config: Optional[dict] = None,
                 device=None):
        #: where every worker's solver runs (`cuda` when None)
        self.device = device
        #: gossip membership for the autopilot (`attach_gossip`)
        self.gossip = None
        self.store = StateStore()
        self.fsm = StateFSM(self.store)
        if raft_config is None:
            raft_config = RaftConfig(node_id="server-1", peers=[])
        if raft_transport is None:
            from ..raft import InProcTransport
            raft_transport = InProcTransport()
        self.raft = RaftNode(raft_config, self.fsm, raft_transport,
                             on_leader=self._establish_leadership,
                             on_follower=self._revoke_leadership)
        self._multi = len(raft_config.peers) > 1
        # serving tier: adaptive micro-batching + admission
        # control shared by every worker and the eval-ingress path;
        # `serving_config` (agent `server { serving { ... } }` stanza)
        # overrides the defaults.  {"adaptive": False} pins
        # the fixed batch_size dequeue (the pre-serving behavior) while
        # keeping admission bounded.  Built before the broker: the tier
        # owns the scale-out knobs (shards/workers/group commit).
        from .serving import ServingTier
        self.serving = ServingTier(overrides=serving_config)
        self.broker = EvalBroker(shards=self.serving.broker_shards)
        self.blocked_evals = BlockedEvals(self.broker)
        self.plan_queue = PlanQueue()
        self.batch_size = batch_size
        # telemetry tick state: last counter snapshots for
        # per-beat rate series + the most recent fleet health report
        # (`last_health`; assigned whole — readers on another thread
        # see either the old or the new dict)
        self._telemetry_state: Dict[str, float] = {}
        self._telemetry_lock = threading.Lock()
        self._last_health: Optional[dict] = None
        self.planner = PlanApplier(self.plan_queue, self.store,
                                   self._apply_plan, self._create_evals,
                                   apply_async_fn=self._apply_plan_async,
                                   apply_batch_async_fn=(
                                       self._apply_plan_batch_async),
                                   group_commit=self.serving.group_commit)
        self.enabled_schedulers = enabled_schedulers or [
            s for s in SCHEDULERS if s != JOB_TYPE_CORE]
        # every worker must also drain the core queue or GC evals pile up
        # forever (reference: server.go setupWorkers forces JobTypeCore into
        # each worker's enabled set)
        worker_types = list(self.enabled_schedulers)
        if JOB_TYPE_CORE not in worker_types:
            worker_types.append(JOB_TYPE_CORE)
        if num_workers is None:
            num_workers = self.serving.num_workers
        self.workers = [Worker(self, worker_types, index=i)
                        for i in range(num_workers)]
        # cross-worker fused solves: bulk batches from every
        # worker coalesce into one device wave; express lane stays
        # single-solve inside the worker
        self.solve_coordinator = None
        if self.serving.coordinator and num_workers > 1:
            from ..scheduler.fleet import SolveCoordinator
            self.solve_coordinator = SolveCoordinator(
                self, pipeline=self.serving.pipeline)
        self.heartbeater = NodeHeartbeater(
            self._on_heartbeat_expired,
            min_heartbeat_ttl_s=min_heartbeat_ttl_s,
            heartbeat_grace_s=heartbeat_grace_s,
            failover_heartbeat_ttl_s=failover_heartbeat_ttl_s)
        self.periodic = PeriodicDispatcher(self)
        from .deployment_watcher import DeploymentWatcher
        self.deployment_watcher = DeploymentWatcher(self)
        from .drainer import NodeDrainer
        self.drainer = NodeDrainer(self)
        self.time_table = TimeTable()
        self.gc_interval_s = gc_interval_s
        self.job_gc_threshold_s = job_gc_threshold_s
        self.eval_gc_threshold_s = eval_gc_threshold_s
        self.node_gc_threshold_s = node_gc_threshold_s
        self.deployment_gc_threshold_s = deployment_gc_threshold_s
        self._gc_timer: Optional[threading.Thread] = None
        self._metrics_timer: Optional[threading.Thread] = None
        self._started = False
        self._stop_reapers = threading.Event()
        self._dup_reaper: Optional[threading.Thread] = None
        self._cas_lock = threading.Lock()
        if not self._multi:
            # single-node deployments can accept writes immediately
            # (pre-raft callers constructed a Server and wrote to it
            # without start()); leader services still wait for start()
            self.raft.bootstrap_single(defer_events=True)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Join the raft cluster. Single-node deployments bootstrap and
        become leader synchronously (existing callers see the same
        behavior as before); multi-node members run the election and
        leader services follow leadership transitions."""
        if self._multi:
            self.raft.start()
        else:
            self.raft.fire_pending_role_events()

    def is_leader(self) -> bool:
        return self.raft.is_leader()

    def _establish_leadership(self) -> None:
        """Enable leader-only services + workers
        (reference: leader.go:197 establishLeadership).  First a raft
        barrier, as Nomad's leader runs (leader.go:229): entries of
        earlier terms (an old leader's last plans) are applied before
        the store is read, or a restored eval is scheduled again on a
        store that lacks its own placements (duplicate allocs once
        they apply).  A leader that loses its term meanwhile
        establishes nothing; its follower event follows."""
        while True:
            try:
                self.raft.barrier()
                break
            except NotLeaderError:
                return
            except TimeoutError:
                continue          # still leader: wait out the commit
        self.broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self.planner.start()
        # a worker is a thread and starts once: a server that leads
        # again after losing leadership gets fresh workers (the
        # reference starts the stopped ones again, and that raises in
        # the raft thread's leadership callback)
        self.workers = [w if w.ident is None
                        else Worker(self, w.sched_types, index=w.index)
                        for w in self.workers]
        for w in self.workers:
            w.start()
        # Reserve leader CPU for raft + plan application by pausing a
        # fraction of the scheduling workers (reference: leader.go:206-212
        # pauses len(s.workers)/4*3 while leader).  Pausing directly caps
        # dequeue parallelism, which defeats the sharded broker — so the
        # fraction is a serving knob: -1 (auto) pauses none once the
        # broker is sharded (shard homes need their workers) and keeps
        # the reference 3/4 otherwise; at least one worker always runs
        # so scheduling can't stall.
        frac = self.serving.worker_pause_fraction
        if frac < 0.0:
            n_pause = 0 if self.serving.broker_shards > 1 \
                else len(self.workers) // 4 * 3
        else:
            n_pause = int(len(self.workers) * min(frac, 1.0))
        if n_pause >= len(self.workers):
            n_pause = len(self.workers) - 1
        for w in self.workers[:max(0, n_pause)]:
            w.paused.set()
        self._stop_reapers.clear()
        self._dup_reaper = threading.Thread(
            target=self._reap_dup_blocked_evals, daemon=True)
        self._dup_reaper.start()
        # grant known live nodes the failover TTL before expecting fresh
        # heartbeats (leader.go:296 initializeHeartbeatTimers)
        self.heartbeater.set_enabled(True)
        self.heartbeater.initialize(
            n.id for n in self.store.nodes() if not n.terminal_status())
        self.deployment_watcher.set_enabled(True)
        self.drainer.set_enabled(True)
        # periodic jobs resume their schedules (leader.go restorePeriodicDispatcher)
        self.periodic.set_enabled(True)
        for job in self.store.jobs():
            if job.is_periodic():
                self.periodic.add(job)
        self._gc_timer = threading.Thread(target=self._schedule_periodic_gc,
                                          daemon=True)
        self._gc_timer.start()
        # broker gauges must not freeze while every worker is paused or
        # draining (the worker loop was their only exporter): a leader
        # timer re-exports them on a fixed beat, idempotently — gauges
        # are plain sets, so the two exporters never conflict
        self._metrics_timer = threading.Thread(
            target=self._export_metrics_loop, daemon=True)
        self._metrics_timer.start()
        self._started = True
        self._restore_evals()

    def stop(self) -> None:
        self._revoke_leadership()
        # join workers so no straggler proposes after stop() returns (a
        # mid-eval worker would otherwise race the caller's view of the
        # final state)
        for w in self.workers:
            if w.is_alive():
                w.join(timeout=5.0)
        self.raft.stop()

    def _revoke_leadership(self) -> None:
        self.heartbeater.set_enabled(False)
        self.deployment_watcher.set_enabled(False)
        self.drainer.set_enabled(False)
        self.periodic.set_enabled(False)
        self._stop_reapers.set()
        for w in self.workers:
            w.paused.clear()
            w.shutdown()
        self.planner.stop()
        self.plan_queue.set_enabled(False)
        self.broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self._started = False

    def _reap_dup_blocked_evals(self) -> None:
        """Cancel blocked evals displaced by a newer eval for the same job
        (reference: leader.go:625 reapDupBlockedEvaluations)."""
        import copy
        from ..structs import EVAL_STATUS_CANCELLED
        ticks = 0
        while not self._stop_reapers.is_set():
            ticks += 1
            if ticks % 10 == 0:
                self._autopilot_reconcile()
            dups = self.blocked_evals.get_duplicates(timeout=0.2)
            if not dups:
                continue
            cancelled = []
            for ev in dups:
                e2 = copy.copy(ev)
                e2.status = EVAL_STATUS_CANCELLED
                e2.status_description = \
                    "cancelled due to duplicate blocked evaluation"
                cancelled.append(e2)
            self.upsert_evals(cancelled)

    def _restore_evals(self) -> None:
        """Re-enqueue non-terminal evals from state (leader.go:245).

        Blocked evals are RE-ENQUEUED rather than re-blocked: the
        missed-unblock protection (blocked_evals.py) keys off an
        in-memory map of capacity-change indexes that an incoming
        leader doesn't have, so a blocked eval whose capacity arrived
        before the leadership change would otherwise wait forever.  One
        fresh scheduling pass either places it or re-blocks it against
        live capacity state."""
        import copy
        from ..structs import EVAL_STATUS_PENDING
        for ev in list(self.store.evals()):
            if ev.should_enqueue():
                self.broker.enqueue(ev)
            elif ev.should_block():
                redo = copy.copy(ev)
                redo.status = EVAL_STATUS_PENDING
                self.broker.enqueue(redo)

    def _schedule_periodic_gc(self) -> None:
        """Leader timer enqueueing core GC evals (leader.go:513
        schedulePeriodic; the evals are broker-only, not persisted, to
        avoid duplication across restarts)."""
        from ..scheduler.core import (CORE_JOB_DEPLOYMENT_GC,
                                      CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC,
                                      CORE_JOB_NODE_GC)
        while not self._stop_reapers.wait(self.gc_interval_s):
            for kind in (CORE_JOB_EVAL_GC, CORE_JOB_NODE_GC,
                         CORE_JOB_JOB_GC, CORE_JOB_DEPLOYMENT_GC):
                self.broker.enqueue(self._core_job_eval(kind))

    #: server-side broker-gauge export beat (seconds)
    METRICS_EXPORT_INTERVAL_S = 1.0

    #: fleet health sample cadence, in export beats (the host-twin
    #: reduction walks every node plane; 1 Hz would be wasteful on
    #: large fleets, 5 s tracks churn fine)
    HEALTH_SAMPLE_EVERY = 5

    def _export_metrics_loop(self) -> None:
        beats = 0
        while not self._stop_reapers.wait(self.METRICS_EXPORT_INTERVAL_S):
            self.broker.export_metrics()
            beats += 1
            try:
                self._telemetry_tick(beats)
            except Exception:
                # telemetry must never kill the export beat — the
                # broker gauges above are load-bearing for operators
                from ..utils.metrics import global_metrics as _m
                _m.incr_counter("telemetry.tick_error")

    def _telemetry_tick(self, beats: int) -> None:
        """Feed the multi-resolution series store on the export beat:
        broker depth/age, admission rates (counter deltas per beat),
        event-log rate, and — every HEALTH_SAMPLE_EVERY beats — a fleet
        health sample over the worker solver's resident world, kept for
        `last_health`."""
        from ..telemetry.series import global_series as _s
        from ..utils.metrics import global_metrics as _m
        from ..utils.tracing import global_mesh_events as _ev
        st = self._telemetry_state
        _s.record("broker.ready_depth", float(self.broker.ready_count()))
        _s.record("broker.oldest_age_s",
                  float(self.broker.oldest_ready_age()))
        adm = self.serving.admission.stats()

        def _rate(key: str) -> Optional[float]:
            cur = float(adm.get(key, 0))
            prev = st.get("adm_" + key)
            st["adm_" + key] = cur
            return None if prev is None else cur - prev

        offered, admitted, shed = (_rate("offered"), _rate("admitted"),
                                   _rate("shed"))
        if offered is not None:
            _s.record("serving.offered_rate", offered)
        if admitted is not None:
            _s.record("serving.admitted_rate", admitted)
        if shed is not None:
            _s.record("serving.shed_rate", shed)
        _s.record("serving.brownout",
                  1.0 if self.serving.admission.brownout_active() else 0.0)
        seq = _ev.last_seq
        prev = st.get("mesh_seq")
        if prev is not None:
            _s.record("mesh.event_rate", float(seq - prev))
        st["mesh_seq"] = seq
        if beats % self.HEALTH_SAMPLE_EVERY != 0 or not self.workers:
            return
        solver = self.workers[0]._solver   # sample only an EXISTING
        if solver is None:                 # solver; never build one here
            return
        hc = solver.health_counters()
        if hc is None:
            return
        report = hc.report()
        report["sampled_at"] = _time.time()
        with self._telemetry_lock:
            self._last_health = report
        _m.set_gauge("health.nodes_busy", float(hc.nodes_busy))
        _m.set_gauge("health.nodes_stranded", float(hc.nodes_stranded))
        _m.set_gauge("health.fragmentation_index",
                     hc.fragmentation_index())
        _m.set_gauge("health.spread_violations",
                     float(hc.spread_violations()))
        _m.set_gauge("health.ev_slots", float(hc.ev_slots))
        _s.record("health.nodes_busy", float(hc.nodes_busy))
        _s.record("health.fragmentation_index",
                  hc.fragmentation_index())
        _s.record("health.utilization",
                  float(report["utilization"]))

    def last_health(self) -> Optional[dict]:
        """Most recent fleet health report from the telemetry tick
        (None until a resident world exists to sample)."""
        with self._telemetry_lock:
            return self._last_health

    def _core_job_eval(self, kind: str) -> Evaluation:
        index = self.store.latest_index()
        return Evaluation(
            namespace="-", type=JOB_TYPE_CORE, job_id=f"{kind}:{index}",
            priority=CORE_JOB_PRIORITY, status=EVAL_STATUS_PENDING,
            triggered_by="scheduled")

    def force_gc(self) -> Evaluation:
        """Run every GC pass with the threshold maxed (core_sched.go:67)."""
        from ..scheduler.core import CORE_JOB_FORCE_GC
        ev = self._core_job_eval(CORE_JOB_FORCE_GC)
        self.broker.enqueue(ev)
        return ev

    # -------------------------------------------------------- write paths
    def _propose(self, etype: str, payload) -> int:
        """Raft-apply one typed entry; returns its log index (== the
        store modify index the FSM wrote it at)."""
        index = self.raft.propose(etype, payload)
        self.time_table.witness(index)
        return index

    def register_node(self, node: Node) -> int:
        existing = self.store.node_by_id(node.id)
        index = self._propose("node_upsert", {"node": to_wire(node)})
        # new capacity unblocks waiters keyed by the node's class
        if node.ready():
            self.blocked_evals.unblock(node.computed_class, index)
        if existing is None and node.ready():
            self._create_node_evals_for_system_jobs(node, index)
        self.heartbeater.reset(node.id)
        return index

    def node_heartbeat(self, node_id: str) -> Optional[float]:
        """Client liveness ping; returns the TTL before the next expected
        heartbeat, or None for unknown nodes (the client must re-register).
        A down node that resumes heartbeating is restored to ready — in the
        reference the heartbeat IS Node.UpdateStatus(ready)
        (node_endpoint.go:373 + heartbeat.go:90)."""
        node = self.store.node_by_id(node_id)
        if node is None:
            return None
        if node.status == NODE_STATUS_DOWN:
            self.update_node_status(node_id, NODE_STATUS_READY)
        return self.heartbeater.reset(node_id)

    def _on_heartbeat_expired(self, node_id: str) -> None:
        """A node missed its TTL: mark it down, which fans out reschedule
        evals (reference: heartbeat.go:135 invalidateHeartbeat)."""
        node = self.store.node_by_id(node_id)
        if node is None or node.status == NODE_STATUS_DOWN:
            return
        self.update_node_status(node_id, NODE_STATUS_DOWN)

    def update_node_status(self, node_id: str, status: str) -> int:
        index = self._propose("node_status",
                              {"node_id": node_id, "status": status})
        node = self.store.node_by_id(node_id)
        if node is None:
            return index
        if status == NODE_STATUS_DOWN:
            self.heartbeater.clear(node_id)
            self._create_node_evals(node, index)
        elif status == NODE_STATUS_READY:
            self.blocked_evals.unblock(node.computed_class, index)
            self._create_node_evals_for_system_jobs(node, index)
            self.heartbeater.reset(node_id)
        return index

    def update_node_drain(self, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> int:
        # stamp the absolute force deadline at request time
        # (reference: node_endpoint.go UpdateDrain)
        if drain_strategy is not None and drain_strategy.deadline_s > 0 \
                and not drain_strategy.force_deadline:
            drain_strategy.force_deadline = \
                _time.time() + drain_strategy.deadline_s
        index = self._propose("node_drain", {
            "node_id": node_id,
            "drain_strategy": to_wire(drain_strategy)
            if drain_strategy is not None else None,
            "mark_eligible": mark_eligible})
        node = self.store.node_by_id(node_id)
        if node is not None:
            self._create_node_evals(node, index)
        return index

    def drain_allocs(self, alloc_ids: List[str]) -> int:
        """Mark allocs for migration and evaluate their jobs — the
        drainer's only write (reference: drainer.go drainAllocs ->
        Allocs.UpdateDesiredTransition)."""
        from ..structs import DesiredTransition
        index = self._propose("alloc_transition", {
            "alloc_ids": list(alloc_ids),
            "transition": to_wire(DesiredTransition(migrate=True))})
        evals: List[Evaluation] = []
        seen = set()
        for aid in alloc_ids:
            a = self.store.alloc_by_id(aid)
            if a is None:
                continue
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = a.job or self.store.job_by_id(*key)
            evals.append(Evaluation(
                namespace=a.namespace, job_id=a.job_id,
                type=job.type if job else JOB_TYPE_SERVICE,
                priority=job.priority if job else 50,
                triggered_by=EVAL_TRIGGER_NODE_DRAIN,
                status=EVAL_STATUS_PENDING))
        self._create_evals(evals)
        return index

    def update_node_eligibility(self, node_id: str,
                                eligibility: str) -> int:
        """Node.UpdateEligibility analog (node_endpoint.go)."""
        index = self._propose("node_eligibility", {
            "node_id": node_id, "eligibility": eligibility})
        node = self.store.node_by_id(node_id)
        if node is not None and node.ready():
            self.blocked_evals.unblock(node.computed_class, index)
        return index

    def stop_alloc(self, alloc_id: str) -> Optional[Evaluation]:
        """Alloc.Stop analog: mark the alloc for migration and evaluate
        its job (alloc_endpoint.go AllocSpecificRequest stop)."""
        from ..structs import DesiredTransition
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            return None
        self._propose("alloc_transition", {
            "alloc_ids": [alloc_id],
            "transition": to_wire(DesiredTransition(migrate=True))})
        job = alloc.job or self.store.job_by_id(alloc.namespace,
                                                alloc.job_id)
        ev = Evaluation(
            namespace=alloc.namespace, job_id=alloc.job_id,
            type=job.type if job else JOB_TYPE_SERVICE,
            priority=job.priority if job else 50,
            triggered_by="alloc-stop", status=EVAL_STATUS_PENDING)
        self._create_evals([ev])
        return ev

    def register_job(self, job: Job, enforce_index: bool = False,
                     check_index: int = 0) -> Optional[Evaluation]:
        job.canonicalize()
        # validate server-side so every path (HTTP, RPC, direct) is
        # covered (reference: job_endpoint.go Job.Register → Validate
        # runs in the RPC, not just the agent)
        errs = job.validate()
        if errs:
            raise JobValidationError(
                "job validation failed: " + "; ".join(errs))
        # _cas_lock keeps the check-and-set registration atomic across
        # concurrent registrars (reference: job_endpoint.go Job.Register
        # EnforceIndex runs inside the raft apply's serialization)
        with self._cas_lock:
            if enforce_index:
                existing = self.store.job_by_id(job.namespace, job.id)
                current = existing.job_modify_index if existing else 0
                if current != check_index:
                    raise ValueError(
                        f"job modify index mismatch: have {current}, "
                        f"want {check_index}")
            self._propose("job_upsert", {"job": to_wire(job)})
        # the FSM applied a decoded copy; re-read for the stamped indexes
        stored = self.store.job_by_id(job.namespace, job.id) or job
        # periodic parents and parameterized jobs are templates: tracked by
        # their dispatchers, never evaluated directly (job_endpoint.go:308)
        if stored.is_periodic():
            self.periodic.add(stored)
            return None
        if stored.is_parameterized():
            return None
        ev = Evaluation(
            namespace=stored.namespace, priority=stored.priority,
            type=stored.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=stored.id,
            job_modify_index=stored.modify_index,
            status=EVAL_STATUS_PENDING)
        self._create_evals([ev])
        return ev

    def deregister_job(self, namespace: str, job_id: str,
                       purge: bool = False) -> Optional[Evaluation]:
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        if purge:
            self._propose("job_delete", {"namespace": namespace,
                                         "job_id": job_id})
        else:
            import copy
            j2 = copy.copy(job)
            j2.stop = True
            self._propose("job_upsert", {"job": to_wire(j2)})
        self.blocked_evals.untrack(namespace, job_id)
        self.periodic.remove(namespace, job_id)
        if job.is_periodic() or job.is_parameterized():
            return None
        ev = Evaluation(
            namespace=namespace, priority=job.priority, type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_DEREGISTER, job_id=job_id,
            status=EVAL_STATUS_PENDING)
        self._create_evals([ev])
        return ev

    def get_client_allocs(self, node_id: str, min_index: int,
                          timeout: float):
        """Blocking query for a node's allocations (reference:
        node_endpoint.go:924 Node.GetClientAllocs — index-filtered pull
        the client long-polls). Returns (allocs, index)."""
        deadline = _time.monotonic() + timeout
        while True:
            # capture the store head BEFORE the table check: a write landing
            # between the two reads then wakes wait_for_change immediately
            head = self.store.latest_index()
            index = self.store.table_index("allocs")
            if index > min_index:
                return self.store.allocs_by_node(node_id), index
            remain = deadline - _time.monotonic()
            if remain <= 0:
                return self.store.allocs_by_node(node_id), max(index,
                                                               min_index)
            # wait for any write past the head, then recheck the allocs
            # table index (other tables' writes wake us early)
            self.store.wait_for_change(head, remain)

    def update_allocs_from_client(self, updates: List[Allocation]) -> int:
        """Client status sync (reference: node_endpoint.go:1063
        Node.UpdateAlloc -> fsm.go:749)."""
        index = self._propose("allocs_client", {
            "updates": [to_wire(u) for u in updates]})
        evals: List[Evaluation] = []
        unblock_nodes = set()
        for upd in updates:
            alloc = self.store.alloc_by_id(upd.id)
            if alloc is None:
                continue
            if alloc.client_terminal_status():
                unblock_nodes.add(alloc.node_id)
            # failed allocs trigger a reschedule eval
            if upd.client_status == ALLOC_CLIENT_FAILED and alloc.job:
                tg = alloc.job.lookup_task_group(alloc.task_group)
                policy = tg.reschedule_policy if tg else None
                if policy and (policy.unlimited or policy.attempts > 0):
                    evals.append(Evaluation(
                        namespace=alloc.namespace, type=alloc.job.type,
                        priority=alloc.job.priority, job_id=alloc.job_id,
                        triggered_by=EVAL_TRIGGER_RETRY_FAILED_ALLOC,
                        status=EVAL_STATUS_PENDING))
        if evals:
            self._create_evals(evals)
        for nid in unblock_nodes:
            node = self.store.node_by_id(nid)
            if node is not None:
                self.blocked_evals.unblock(node.computed_class, index)
        return index

    # ----------------------------------------------------- eval plumbing
    def _create_evals(self, evals: List[Evaluation]) -> None:
        """Raft-apply eval upserts, then route to broker / blocked list
        (reference: fsm.go:680 handleUpsertedEval)."""
        if not evals:
            return
        from ..utils.tracing import global_tracer as _tr
        head = self.store.latest_index() + 1
        for ev in evals:
            if not ev.create_time:
                ev.create_time = _time.time()
            ev.modify_time = _time.time()
            ev.snapshot_index = ev.snapshot_index or head
        self._propose("evals_upsert",
                      {"evals": [to_wire(e) for e in evals]})
        # enqueue the FSM's stored copies (they carry the apply indexes)
        for ev in evals:
            stored = self.store.eval_by_id(ev.id) or ev
            if stored.should_enqueue():
                # flight-recorder root: the eval id IS the
                # trace id; every later lifecycle stage chains on this
                _tr.event(stored.id, "create", parent="",
                          job_id=stored.job_id,
                          namespace=stored.namespace,
                          priority=stored.priority, type=stored.type,
                          triggered_by=stored.triggered_by)
                # serving-tier admission gate: bounded broker
                # ingress with priority-aware shedding.  Shed evals park
                # in blocked_evals' shed lane — still persisted PENDING
                # in state, never dropped — and readmit on drain (the
                # worker's readmit tick).  Broker-internal re-enqueues
                # (nack redelivery, blocked promotion, delayed evals)
                # are not ingress and bypass this gate.
                admitted, cause = (
                    self.serving.admission.offer_ex(
                        stored, self.broker.ready_count())
                    if self.serving is not None else (True, ""))
                if not admitted:
                    _tr.event(stored.id, "admit", admitted=False,
                              shed_cause=cause)
                    self.blocked_evals.shed(stored)
                else:
                    _tr.event(stored.id, "admit", admitted=True)
                    self.broker.enqueue(stored)
            elif stored.should_block():
                self.blocked_evals.block(stored)

    def upsert_evals(self, evals: List[Evaluation]) -> None:
        self._create_evals(evals)

    def _create_node_evals(self, node: Node, index: int) -> None:
        """One eval per job with allocs on the node, plus system jobs
        (reference: node_endpoint.go:1348 createNodeEvals)."""
        evals: List[Evaluation] = []
        seen = set()
        for a in self.store.allocs_by_node(node.id):
            key = (a.namespace, a.job_id)
            if key in seen or a.terminal_status():
                continue
            seen.add(key)
            job = a.job or self.store.job_by_id(*key)
            evals.append(Evaluation(
                namespace=a.namespace, job_id=a.job_id,
                type=job.type if job else JOB_TYPE_SERVICE,
                priority=job.priority if job else 50,
                triggered_by=EVAL_TRIGGER_NODE_UPDATE, node_id=node.id,
                node_modify_index=node.modify_index,
                status=EVAL_STATUS_PENDING))
        self._create_evals(evals)

    def _create_node_evals_for_system_jobs(self, node: Node,
                                           index: int) -> None:
        evals = []
        for job in self.store.jobs():
            if job.is_system() and not job.stopped():
                evals.append(Evaluation(
                    namespace=job.namespace, job_id=job.id, type=job.type,
                    priority=job.priority,
                    triggered_by=EVAL_TRIGGER_NODE_UPDATE, node_id=node.id,
                    status=EVAL_STATUS_PENDING))
        self._create_evals(evals)

    # -------------------------------------------------------- deployments
    def apply_deployment_status_update(self, update,
                                       mark_stable=None) -> int:
        """Raft-apply a deployment status change; optionally mark the
        job version stable in the same apply (reference:
        fsm.go applyDeploymentStatusUpdate)."""
        return self._propose("deployment_status", {
            "updates": [to_wire(update)],
            "mark_stable": list(mark_stable) if mark_stable else None})

    def promote_deployment(self, dep_id: str,
                           all_groups: bool = True,
                           groups=None) -> Optional[Evaluation]:
        """Promote canaries (reference: deployments_watcher.go
        PromoteDeployment -> fsm applyDeploymentPromotion): flips the
        groups' promoted bit and evaluates the job so the reconciler
        replaces the old version."""
        dep = self.store.deployment_by_id(dep_id)
        if dep is None or not dep.active():
            return None
        # reference PromoteDeployment rejects unhealthy canaries — the
        # promotion replaces the known-good version cluster-wide
        unhealthy = self._unhealthy_canary_groups(
            dep, None if all_groups else groups)
        if unhealthy:
            raise ValueError(
                f"canaries not healthy in group(s): {', '.join(unhealthy)}")
        self._propose("deployment_promote", {
            "dep_id": dep_id, "groups": None if all_groups else groups})
        job = self.store.job_by_id(dep.namespace, dep.job_id)
        if job is None:
            return None
        ev = Evaluation(
            namespace=dep.namespace, job_id=dep.job_id, type=job.type,
            priority=job.priority, deployment_id=dep_id,
            triggered_by=EVAL_TRIGGER_DEPLOYMENT_PROMOTION,
            status=EVAL_STATUS_PENDING)
        self._create_evals([ev])
        return ev

    def _unhealthy_canary_groups(self, dep, groups=None) -> List[str]:
        out = []
        for name, state in dep.task_groups.items():
            if state.desired_canaries <= 0 or state.promoted:
                continue
            if groups is not None and name not in groups:
                continue
            healthy = 0
            for aid in state.placed_canaries:
                a = self.store.alloc_by_id(aid)
                if (a is not None and a.deployment_status is not None
                        and a.deployment_status.is_healthy()):
                    healthy += 1
            if healthy < state.desired_canaries:
                out.append(name)
        return out

    def fail_deployment(self, dep_id: str) -> Optional[Evaluation]:
        """Manual fail (reference: Deployment.Fail RPC)."""
        from ..structs import (DEPLOYMENT_STATUS_FAILED,
                               DeploymentStatusUpdate)
        dep = self.store.deployment_by_id(dep_id)
        if dep is None or not dep.active():
            return None
        self.apply_deployment_status_update(DeploymentStatusUpdate(
            deployment_id=dep_id, status=DEPLOYMENT_STATUS_FAILED,
            status_description="Deployment marked as failed"))
        job = self.store.job_by_id(dep.namespace, dep.job_id)
        if job is None:
            return None
        ev = Evaluation(
            namespace=dep.namespace, job_id=dep.job_id, type=job.type,
            priority=job.priority, deployment_id=dep_id,
            triggered_by=EVAL_TRIGGER_DEPLOYMENT_WATCHER,
            status=EVAL_STATUS_PENDING)
        self._create_evals([ev])
        return ev

    def revert_job(self, stable_job: Job) -> Optional[Evaluation]:
        """Re-register a historical job version as the newest one
        (reference: Job.Revert — copies the old version forward)."""
        import copy as _copy
        j = _copy.deepcopy(stable_job)
        j.create_index = j.modify_index = j.job_modify_index = 0
        return self.register_job(j)

    def revert_job_version(self, namespace: str, job_id: str,
                           version: int,
                           enforce_prior_version: Optional[int] = None
                           ) -> Tuple[int, Optional[Evaluation]]:
        """Manual revert to a retained version (reference:
        nomad/job_endpoint.go Job.Revert — validates the target exists,
        optionally CAS-checks the current version, then registers the
        old version forward as a NEW version)."""
        cur = self.store.job_by_id(namespace, job_id)
        if cur is None:
            raise ValueError(f"unknown job {job_id!r}")
        if enforce_prior_version is not None \
                and cur.version != enforce_prior_version:
            raise ValueError(
                f"current version is {cur.version}, "
                f"not {enforce_prior_version}")
        if version == cur.version:
            raise ValueError(
                f"cannot revert to the current version ({version})")
        target = self.store.job_by_id_and_version(namespace, job_id,
                                                  version)
        if target is None:
            raise ValueError(f"job {job_id!r} has no version {version}")
        ev = self.revert_job(target)
        new = self.store.job_by_id(namespace, job_id)
        return (new.version if new else 0), ev

    def set_job_stability(self, namespace: str, job_id: str,
                          version: int, stable: bool) -> None:
        """Manually mark a job version (un)stable (reference:
        Job.Stable — the auto-revert target set by hand)."""
        if self.store.job_by_id_and_version(namespace, job_id,
                                            version) is None:
            raise ValueError(f"job {job_id!r} has no version {version}")
        self._propose("job_stability", {
            "namespace": namespace, "job_id": job_id,
            "version": version, "stable": bool(stable)})

    # reference: structs.DispatchPayloadSizeLimit (16 KiB)
    DISPATCH_PAYLOAD_LIMIT = 16 * 1024

    def dispatch_job(self, namespace: str, job_id: str,
                     payload: bytes = b"",
                     meta: Optional[Dict[str, str]] = None
                     ) -> Tuple[Job, Optional[Evaluation]]:
        """Instantiate a parameterized job (reference:
        nomad/job_endpoint.go Job.Dispatch): validate payload presence
        against the template's constraint and the dispatch meta against
        the declared keys, then register a child carrying the payload
        (delivered to the task dir by the task runner's
        dispatch_payload hook)."""
        import copy as _copy
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"unknown job {job_id!r}")
        if not job.is_parameterized():
            raise ValueError(f"job {job_id!r} is not parameterized")
        cfg = job.parameterized
        payload = bytes(payload or b"")
        if cfg.payload == "required" and not payload:
            raise ValueError("job requires a dispatch payload")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("job forbids a dispatch payload")
        if len(payload) > self.DISPATCH_PAYLOAD_LIMIT:
            raise ValueError(
                f"payload exceeds {self.DISPATCH_PAYLOAD_LIMIT} bytes")
        meta = dict(meta or {})
        missing = [k for k in cfg.meta_required if k not in meta]
        if missing:
            raise ValueError(f"missing required dispatch meta: "
                             f"{sorted(missing)}")
        allowed = set(cfg.meta_required) | set(cfg.meta_optional)
        extra = [k for k in meta if k not in allowed]
        if extra:
            raise ValueError(f"dispatch meta keys not declared by the "
                             f"job: {sorted(extra)}")
        child = _copy.deepcopy(job)
        child.id = (f"{job.id}/dispatch-{int(_time.time())}-"
                    f"{generate_uuid()[:8]}")
        child.name = child.id
        child.parent_id = job.id
        child.dispatched = True
        child.payload = payload
        child.meta = {**(job.meta or {}), **meta}
        child.create_index = child.modify_index = 0
        child.job_modify_index = 0
        ev = self.register_job(child)
        stored = self.store.job_by_id(namespace, child.id) or child
        return stored, ev

    # --------------------------------------------------- raft membership
    def add_server_peer(self, peer_id: str, addr=None,
                        catchup_timeout_s: float = 10.0) -> int:
        """One-at-a-time raft membership add (reference: raft
        AddVoter via nomad/leader.go addRaftPeer on serf join). The new
        server first replicates as a NON-VOTER until it holds the
        leader's committed log (the learner phase), then joins the
        voting config — so a lagging joiner never drags quorum. `addr`
        updates the transport's peer map when it routes by address."""
        if addr is not None and hasattr(self.raft.transport,
                                        "peer_addrs"):
            self.raft.transport.peer_addrs[peer_id] = addr
        peers = list(self.raft.cfg.peers)
        if peer_id in peers:
            return self.store.latest_index()
        self.raft.add_learner(peer_id)
        try:
            deadline = _time.monotonic() + catchup_timeout_s
            while not self.raft.learner_caught_up(peer_id):
                if _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"peer {peer_id} did not catch up in "
                        f"{catchup_timeout_s}s")
                if not self.is_leader():
                    raise NotLeaderError(self.raft.leader_id)
                _time.sleep(0.02)
            # re-read the config: another membership change may have
            # committed during the catch-up wait
            peers = list(self.raft.cfg.peers)
            if peer_id in peers:
                return self.store.latest_index()
            return self.raft.propose_config(peers + [peer_id])
        finally:
            self.raft.remove_learner(peer_id)

    def remove_server_peer(self, peer_id: str) -> int:
        """Membership removal (reference: removeRaftPeer; autopilot's
        dead-server cleanup calls this when gossip marks a server
        failed)."""
        peers = [p for p in self.raft.cfg.peers if p != peer_id]
        if len(peers) == len(self.raft.cfg.peers):
            return self.store.latest_index()
        return self.raft.propose_config(peers)

    def attach_gossip(self, gossip) -> None:
        """Autopilot wiring (reference: nomad/autopilot.go dead-server
        cleanup + serf.go nodeFailed -> removeRaftPeer): when gossip
        declares a SERVER member dead, the leader removes it from the
        raft peer set so quorum shrinks to the live members. The
        edge-triggered on_fail is backed by a periodic leader-side
        reconcile (the reference reconciles from the leader loop), so a
        death that fires while no stable leader exists is still cleaned
        up."""
        self.gossip = gossip
        prev = gossip.on_fail

        def on_fail(member):
            if prev is not None:
                prev(member)
            self._autopilot_reconcile()
        gossip.on_fail = on_fail

    def _autopilot_reconcile(self) -> None:
        gossip = self.gossip
        if gossip is None or not self.is_leader():
            return
        from ..membership.gossip import STATUS_DEAD, STATUS_LEFT
        for peer in list(self.raft.cfg.peers):
            m = gossip.member(peer)
            if m is not None and m.status in (STATUS_DEAD, STATUS_LEFT):
                try:
                    self.remove_server_peer(peer)
                except (ValueError, NotLeaderError, TimeoutError) as e:
                    # a membership change in flight, a lost leadership
                    # or a commit that timed out: the next tick retries
                    _log.info("autopilot: removal of %s deferred: %s",
                              peer, e)
                return    # one at a time; the next tick continues

    # ------------------------------------------------------------ secrets
    def upsert_secret(self, namespace: str, path: str,
                      data: Dict[str, str]) -> int:
        """Native secret KV write (the Vault-analog store; raft-
        replicated like every other table)."""
        return self._propose("secret_upsert", {
            "namespace": namespace, "path": path, "data": dict(data)})

    def delete_secret(self, namespace: str, path: str) -> int:
        return self._propose("secret_delete",
                             {"namespace": namespace, "path": path})

    # --------------------------------------------------------------- ACL
    def bootstrap_acl(self):
        """One-time creation of the initial management token
        (reference: acl_endpoint.go Bootstrap)."""
        from ..acl import ACLToken
        if self.store.acl_bootstrapped():
            # the flag persists even if every management token is later
            # deleted — a re-opened anonymous bootstrap would be a
            # privilege escalation (reference: the raft-persisted
            # bootstrap index, acl_endpoint.go Bootstrap)
            raise ValueError("ACL already bootstrapped")
        token = ACLToken(accessor_id=generate_uuid(),
                         secret_id=generate_uuid(),
                         name="Bootstrap Token", type="management",
                         global_=True)
        self._propose("acl_token_upsert", {"token": to_wire(token),
                                           "bootstrap": True})
        return token

    def upsert_acl_policy(self, policy) -> int:
        return self._propose("acl_policy_upsert",
                             {"policy": to_wire(policy)})

    def delete_acl_policy(self, name: str) -> int:
        return self._propose("acl_policy_delete", {"name": name})

    def upsert_acl_token(self, token) -> int:
        if not token.accessor_id:
            token.accessor_id = generate_uuid()
        if not token.secret_id:
            token.secret_id = generate_uuid()
        return self._propose("acl_token_upsert",
                             {"token": to_wire(token)})

    def delete_acl_token(self, accessor_id: str) -> int:
        return self._propose("acl_token_delete",
                             {"accessor_id": accessor_id})

    def resolve_token(self, secret_id: str):
        """Secret -> compiled ACL (reference: nomad/acl.go ResolveToken;
        the reference caches compiled ACLs in an LRU — policy sets here
        are small enough to compile per call)."""
        from ..acl import compile_acl, management_acl
        token = self.store.acl_token_by_secret(secret_id)
        if token is None:
            return None
        if token.is_management():
            return management_acl()
        policies = [p for p in (self.store.acl_policy_by_name(n)
                                for n in token.policies) if p is not None]
        return compile_acl(policies)

    # -------------------------------------------------------- CSI volumes
    def register_csi_volume(self, vol) -> int:
        """CSIVolume.Register analog (nomad/csi_endpoint.go)."""
        return self._propose("csi_volume_upsert", {"volume": to_wire(vol)})

    def deregister_csi_volume(self, namespace: str, vol_id: str) -> int:
        vol = self.store.csi_volume_by_id(namespace, vol_id)
        if vol is not None and vol.in_use():
            raise ValueError(f"volume {vol_id} is in use")
        return self._propose("csi_volume_delete",
                             {"namespace": namespace, "volume_id": vol_id})

    def claim_csi_volume(self, namespace: str, vol_id: str, mode: str,
                         alloc_id: str, node_id: str) -> int:
        """CSIVolume.Claim analog: validated here (the plan applier is
        the serialization point for placements), applied via raft."""
        vol = self.store.csi_volume_by_id(namespace, vol_id)
        if vol is None:
            raise KeyError(f"volume {vol_id} not found")
        from ..structs import CLAIM_WRITE
        if mode == CLAIM_WRITE and not vol.write_free() \
                and alloc_id not in vol.write_claims:
            raise ValueError(f"volume {vol_id} has no free write claims")
        return self._propose("csi_volume_claim", {
            "namespace": namespace, "volume_id": vol_id, "mode": mode,
            "alloc_id": alloc_id, "node_id": node_id})

    def release_csi_claims(self, alloc_id: str) -> int:
        return self._propose("csi_claims_release", {"alloc_id": alloc_id})

    # ----------------------------------------------------------- GC reaps
    def reap_evals(self, eval_ids: List[str], alloc_ids: List[str]) -> int:
        """Eval.Reap analog: delete evals + allocs in one apply."""
        return self._propose("evals_reap", {"eval_ids": list(eval_ids),
                                            "alloc_ids": list(alloc_ids)})

    def reap_jobs(self, keys: List) -> int:
        """Job.BatchDeregister(purge) analog; keys = (namespace, id)."""
        return self._propose("jobs_reap",
                             {"keys": [list(k) for k in keys]})

    def reap_nodes(self, node_ids: List[str]) -> int:
        index = self._propose("nodes_reap", {"node_ids": list(node_ids)})
        for nid in node_ids:
            self.heartbeater.clear(nid)
        return index

    def reap_deployments(self, dep_ids: List[str]) -> int:
        return self._propose("deployments_reap",
                             {"dep_ids": list(dep_ids)})

    def record_periodic_launch(self, namespace: str, job_id: str,
                               launch: float) -> int:
        return self._propose("periodic_launch", {
            "namespace": namespace, "job_id": job_id, "launch": launch})

    # ------------------------------------------------------- plan applier
    def alloc_migrate_source(self, alloc_id: str):
        """Ephemeral-disk migration source info for a previous alloc
        (reference: Node.GetClientAllocs attaches MigrateTokens —
        structs.GenerateMigrateToken under the OWNING node's secret, so
        that agent verifies reads without a server round trip)."""
        from ..structs.funcs import generate_migrate_token
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            return None
        node = self.store.node_by_id(alloc.node_id)
        if node is None:
            # the owning node is gone: nothing to stream from, and a
            # token minted under an empty secret would be forgeable
            return None
        return {
            "alloc_id": alloc_id,
            "namespace": alloc.namespace,
            # CLIENT-terminal: the old tasks must have actually stopped
            # writing before the data is copied (reference: allocwatcher
            # waits for client-terminal, not desired-stop)
            "terminal": alloc.client_terminal_status(),
            "node_id": alloc.node_id,
            "addr": node.attributes.get("unique.advertise.http", ""),
            "migrate_token": generate_migrate_token(alloc_id,
                                                    node.secret_id),
        }

    def _apply_plan(self, plan: Plan, result: PlanResult) -> int:
        index = self._propose("plan_result", {
            "result": to_wire(result),
            "job": to_wire(plan.job) if plan.job is not None else None})
        self._claim_csi_for_placements(plan, result)
        return index

    def _apply_plan_async(self, plan: Plan, result: PlanResult):
        """Dispatch the plan's raft apply without waiting; returns
        (index, finish_fn) — finish_fn blocks until the entry is
        applied, however long that takes (it raises when leadership is
        lost or raft stops), and then claims CSI volumes.  The applier
        pipelines plan N+1's evaluation under plan N's consensus round
        trip."""
        index, wait = self.raft.propose_async("plan_result", {
            "result": to_wire(result),
            "job": to_wire(plan.job) if plan.job is not None else None})

        def finish() -> int:
            ix = wait()
            self._claim_csi_for_placements(plan, result)
            return ix
        return index, finish

    def _apply_plan_batch_async(self, items):
        """Group commit: K plan results ride ONE raft entry —
        one log append, one fsync — instead of K.  `items` is
        [(plan, result)]; returns (index, finish_fn) like the single
        path.  The FSM applies the K results in submission order under
        the shared commit index, which is the same store state K chained
        single applies would produce."""
        index, wait = self.raft.propose_async("plan_results_batch", {
            "items": [{
                "result": to_wire(result),
                "job": to_wire(plan.job) if plan.job is not None else None,
            } for plan, result in items]})

        def finish() -> int:
            ix = wait()
            for plan, result in items:
                self._claim_csi_for_placements(plan, result)
            return ix
        return index, finish

    def _claim_csi_for_placements(self, plan: Plan,
                                  result: PlanResult) -> None:
        """Claim CSI volumes for newly committed placements (reference:
        the csi_hook's Volume.Claim at alloc start; here the serial plan
        applier is the claim serialization point, so the scheduler's
        write-capacity gate and this claim see consistent state)."""
        from ..structs import CLAIM_READ, CLAIM_WRITE
        job = plan.job
        if job is None:
            return
        tgs = {tg.name: tg for tg in job.task_groups}
        for allocs in result.node_allocation.values():
            for a in allocs:
                tg = tgs.get(a.task_group)
                if tg is None:
                    continue
                for req in tg.volumes.values():
                    if req.type != "csi":
                        continue
                    mode = CLAIM_READ if req.read_only else CLAIM_WRITE
                    try:
                        self.claim_csi_volume(job.namespace, req.source,
                                              mode, a.id, a.node_id)
                    except (KeyError, ValueError):
                        import logging
                        logging.getLogger(__name__).warning(
                            "csi claim failed for alloc %s volume %s",
                            a.id, req.source)
