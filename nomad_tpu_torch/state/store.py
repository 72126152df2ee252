"""In-memory replicated state store with snapshots and blocking watches.

The counterpart of `nomad_tpu.state.store`, the same tables, indexes and
change log (the port's scheduler path applies its plans into it).

Reference: nomad/state/state_store.go (go-memdb MVCC tables) + schema.go.
Rebuild notes: instead of radix-tree MVCC we keep plain dict tables plus
secondary indexes, and give schedulers immutable *snapshots* (shallow table
copies). Entries are treated as immutable once inserted — writers replace
objects, never mutate in place — which is what makes the shallow snapshot
sound (same discipline the reference enforces via memdb).

Every write carries a raft-style log index; per-table indexes power blocking
queries (reference: rpc.go blocking-query min-index machinery).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from ..structs import (Allocation, Deployment, Evaluation, Job,
                       JOB_STATUS_DEAD, JOB_STATUS_PENDING,
                       JOB_STATUS_RUNNING, Node, NODE_SCHED_ELIGIBLE,
                       NODE_SCHED_INELIGIBLE, PlanResult)
from ..structs.consts import EVAL_STATUS_BLOCKED, EVAL_STATUS_PENDING

TABLES = ("nodes", "jobs", "job_versions", "job_summaries", "evals", "allocs",
          "deployments", "periodic_launches", "scheduler_config", "indexes",
          "acl_policies", "acl_tokens", "scaling_policies", "scaling_events",
          "vault_accessors", "csi_volumes", "csi_plugins", "cluster_meta",
          "services", "secrets")


class JobSummary:
    """Per-task-group alloc status counts (reference: structs.JobSummary)."""

    def __init__(self, job_id: str, namespace: str):
        self.job_id = job_id
        self.namespace = namespace
        # tg -> {"queued":n,"complete":n,"failed":n,"running":n,"starting":n,"lost":n}
        self.summary: Dict[str, Dict[str, int]] = {}
        self.children_pending = 0
        self.children_running = 0
        self.children_dead = 0
        self.create_index = 0
        self.modify_index = 0

    def copy(self) -> "JobSummary":
        s = JobSummary(self.job_id, self.namespace)
        s.summary = {k: dict(v) for k, v in self.summary.items()}
        s.children_pending = self.children_pending
        s.children_running = self.children_running
        s.children_dead = self.children_dead
        s.create_index = self.create_index
        s.modify_index = self.modify_index
        return s


class SchedulerConfiguration:
    """Runtime-tunable knobs (reference: structs.SchedulerConfiguration).

    The preemption switches gate the scheduler's host-side preemption
    pass per scheduler type.  `solver_backend` is the reference's field
    (SURVEY §5.6), stored and read back; no scheduler of either package
    branches on it.
    """

    def __init__(self, preemption_system=True, preemption_service=False,
                 preemption_batch=False, solver_backend="tpu"):
        self.preemption_system_enabled = preemption_system
        self.preemption_service_enabled = preemption_service
        self.preemption_batch_enabled = preemption_batch
        self.solver_backend = solver_backend
        self.create_index = 0
        self.modify_index = 0


class StateSnapshot:
    """Immutable point-in-time view handed to schedulers.

    Exposes the same read API as the live store (reference:
    scheduler.State interface, scheduler/scheduler.go:65).
    """

    def __init__(self, tables: Dict[str, dict], indexes: Dict[str, int],
                 index: int):
        self._t = tables
        self._ix = dict(indexes)
        self.index = index

    # -- nodes --
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._t["nodes"].get(node_id)

    def nodes(self) -> Iterable[Node]:
        return self._t["nodes"].values()

    def ready_nodes_in_dcs(self, datacenters: List[str]
                           ) -> Tuple[List[Node], Dict[str, int]]:
        """Reference: scheduler/util.go:233 readyNodesInDCs."""
        dcs = set(datacenters)
        out, by_dc = [], {}
        for n in self._t["nodes"].values():
            if not n.ready():
                continue
            if n.datacenter not in dcs and "*" not in dcs:
                continue
            out.append(n)
            by_dc[n.datacenter] = by_dc.get(n.datacenter, 0) + 1
        return out, by_dc

    # -- csi volumes --
    def csi_volume_by_id(self, namespace: str, vol_id: str):
        return self._t["csi_volumes"].get((namespace, vol_id))

    # -- jobs --
    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._t["jobs"].get((namespace, job_id))

    def jobs(self) -> Iterable[Job]:
        return self._t["jobs"].values()

    def jobs_by_namespace(self, namespace: str) -> List[Job]:
        return [j for (ns, _), j in self._t["jobs"].items() if ns == namespace]

    def job_versions(self, namespace: str, job_id: str) -> List[Job]:
        return list(self._t["job_versions"].get((namespace, job_id), ()))

    def job_by_id_and_version(self, namespace: str, job_id: str,
                              version: int) -> Optional[Job]:
        for j in self._t["job_versions"].get((namespace, job_id), ()):
            if j.version == version:
                return j
        return None

    def job_summary(self, namespace: str, job_id: str) -> Optional[JobSummary]:
        return self._t["job_summaries"].get((namespace, job_id))

    # -- evals --
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._t["evals"].get(eval_id)

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        return [e for e in self._t["evals"].values()
                if e.job_id == job_id and e.namespace == namespace]

    def evals(self) -> Iterable[Evaluation]:
        return self._t["evals"].values()

    # -- allocs --
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._t["allocs"].get(alloc_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        ids = self._t.get("_allocs_by_node", {}).get(node_id, ())
        return self._allocs_of(ids)

    def _allocs_of(self, ids) -> List[Allocation]:
        """The allocs of an index set.  Other threads read the live
        store while the FSM's writer adds to and removes from the set in
        place: the set is copied in one step first (a Python loop over
        it could meet "Set changed size during iteration", as the
        reference's can), and an alloc removed meanwhile is skipped."""
        allocs = self._t["allocs"]
        return [a for a in map(allocs.get, tuple(ids)) if a is not None]

    def allocs_by_node_terminal(self, node_id: str,
                                terminal: bool) -> List[Allocation]:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, namespace: str, job_id: str,
                      anyCreateIndex: bool = True) -> List[Allocation]:
        ids = self._t.get("_allocs_by_job", {}).get((namespace, job_id), ())
        return self._allocs_of(ids)

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        return [a for a in self._t["allocs"].values() if a.eval_id == eval_id]

    def allocs(self) -> Iterable[Allocation]:
        return self._t["allocs"].values()

    def allocs_by_deployment(self, dep_id: str) -> List[Allocation]:
        return [a for a in self._t["allocs"].values()
                if a.deployment_id == dep_id]

    # -- deployments --
    def deployment_by_id(self, dep_id: str) -> Optional[Deployment]:
        return self._t["deployments"].get(dep_id)

    def deployments(self) -> Iterable[Deployment]:
        return self._t["deployments"].values()

    def deployments_by_job(self, namespace: str, job_id: str) -> List[Deployment]:
        return [d for d in self._t["deployments"].values()
                if d.job_id == job_id and d.namespace == namespace]

    def latest_deployment_by_job(self, namespace: str,
                                 job_id: str) -> Optional[Deployment]:
        deps = self.deployments_by_job(namespace, job_id)
        if not deps:
            return None
        return max(deps, key=lambda d: d.create_index)

    # -- config / meta --
    def scheduler_config(self) -> SchedulerConfiguration:
        return self._t["scheduler_config"].get("config") or SchedulerConfiguration()

    def table_index(self, table: str) -> int:
        return self._ix.get(table, 0)


class ChangeLog:
    """Bounded append-only log of cluster-state-relevant writes (node
    and alloc table mutations), keyed by raft index.  The solver's
    device-resident cluster state (solver/solve.py ResidentWorld) pulls
    `since(last, snapshot_index)` to build exact incremental deltas
    instead of re-walking the whole world per eval; a consumer that
    fell behind the ring gets None and must full-repack.

    Appends are monotonically non-decreasing in index (raft apply
    order), so `since` is a pair of bisects, not a scan."""

    __slots__ = ("cap", "_entries", "_indexes", "floor")

    def __init__(self, cap: int = 131072):
        self.cap = cap
        self._entries: List[tuple] = []     # (index, kind, key)
        self._indexes: List[int] = []       # parallel, for bisect
        self.floor = 0              # highest index ever evicted

    def append(self, index: int, kind: str, key) -> None:
        self._entries.append((index, kind, key))
        self._indexes.append(index)
        if len(self._entries) > 2 * self.cap:
            cut = len(self._entries) - self.cap
            self.floor = max(self.floor, self._indexes[cut - 1])
            del self._entries[:cut]
            del self._indexes[:cut]

    def since(self, min_index: int, max_index: int):
        """Entries with min_index < index <= max_index, or None when the
        window reaches below the ring's floor (consumer must rebuild)."""
        import bisect
        if min_index < self.floor:
            return None
        lo = bisect.bisect_right(self._indexes, min_index)
        hi = bisect.bisect_right(self._indexes, max_index)
        return self._entries[lo:hi]


class StateStore(StateSnapshot):
    """The live, writable store. Reads are inherited from StateSnapshot."""

    def __init__(self) -> None:
        tables: Dict[str, dict] = {name: {} for name in TABLES}
        tables["_allocs_by_node"] = {}
        tables["_allocs_by_job"] = {}
        super().__init__(tables, {}, 0)
        self._lock = threading.RLock()
        self._watch = threading.Condition(self._lock)
        self.changelog = ChangeLog()

    def changes_since(self, min_index: int, max_index: int):
        """Node/alloc change entries in (min_index, max_index], or None
        if the log was truncated past min_index (see ChangeLog)."""
        with self._lock:
            return self.changelog.since(min_index, max_index)

    # -- snapshot & watch --
    def snapshot(self) -> StateSnapshot:
        with self._lock:
            copied = {}
            for name, table in self._t.items():
                if name in ("_allocs_by_node", "_allocs_by_job"):
                    copied[name] = {k: set(v) for k, v in table.items()}
                else:
                    copied[name] = dict(table)
            return StateSnapshot(copied, self._ix, self.index)

    def latest_index(self) -> int:
        with self._lock:
            return self.index

    def wait_for_index(self, index: int, timeout: float = 5.0) -> int:
        """Block until the store reaches `index` (reference: worker.go:228
        snapshotMinIndex). Returns the current index."""
        deadline = None
        with self._watch:
            while self.index < index:
                import time
                if deadline is None:
                    deadline = time.monotonic() + timeout
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._watch.wait(remain)
            return self.index

    def wait_for_change(self, min_index: int, timeout: float) -> int:
        """Blocking-query primitive: wait until store index > min_index."""
        import time
        deadline = time.monotonic() + timeout
        with self._watch:
            while self.index <= min_index:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                self._watch.wait(remain)
            return self.index

    def _bump_locked(self, table: str, index: int) -> None:
        self.index = max(self.index, index)
        self._ix[table] = max(self._ix.get(table, 0), index)
        self._watch.notify_all()

    # -- nodes --
    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            existing = self._t["nodes"].get(node.id)
            if existing is not None:
                node.create_index = existing.create_index
            else:
                node.create_index = index
            node.modify_index = index
            if not node.computed_class:
                node.compute_class()
            self._t["nodes"][node.id] = node
            self.changelog.append(index, "node", node.id)
            self._bump_locked("nodes", index)

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            self._t["nodes"].pop(node_id, None)
            self.changelog.append(index, "node", node_id)
            self._bump_locked("nodes", index)

    def update_node_status(self, index: int, node_id: str, status: str,
                           updated_at: float = 0.0) -> None:
        with self._lock:
            n = self._t["nodes"].get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy as _copy
            n2 = _copy.copy(n)
            n2.status = status
            n2.status_updated_at = updated_at
            n2.modify_index = index
            self._t["nodes"][node_id] = n2
            self.changelog.append(index, "node", node_id)
            self._bump_locked("nodes", index)

    def update_node_eligibility(self, index: int, node_id: str,
                                eligibility: str) -> None:
        with self._lock:
            n = self._t["nodes"].get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy as _copy
            n2 = _copy.copy(n)
            n2.scheduling_eligibility = eligibility
            n2.modify_index = index
            self._t["nodes"][node_id] = n2
            self.changelog.append(index, "node", node_id)
            self._bump_locked("nodes", index)

    def update_node_drain(self, index: int, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> None:
        with self._lock:
            n = self._t["nodes"].get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy as _copy
            n2 = _copy.copy(n)
            n2.drain_strategy = drain_strategy
            n2.drain = drain_strategy is not None
            if drain_strategy is not None:
                n2.scheduling_eligibility = NODE_SCHED_INELIGIBLE
            elif mark_eligible:
                n2.scheduling_eligibility = NODE_SCHED_ELIGIBLE
            n2.modify_index = index
            self._t["nodes"][node_id] = n2
            self.changelog.append(index, "node", node_id)
            self._bump_locked("nodes", index)

    # -- jobs --
    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            key = (job.namespace, job.id)
            existing = self._t["jobs"].get(key)
            if existing is not None:
                job.create_index = existing.create_index
                job.job_modify_index = index
                if self._job_spec_changed(existing, job):
                    job.version = existing.version + 1
                else:
                    job.version = existing.version
            else:
                job.create_index = index
                job.job_modify_index = index
                job.version = 0
            job.modify_index = index
            self._t["jobs"][key] = job
            versions = list(self._t["job_versions"].get(key, ()))
            if not versions or versions[0].version != job.version:
                versions.insert(0, job)
                from ..structs.consts import MAX_RETAINED_JOB_VERSIONS
                del versions[MAX_RETAINED_JOB_VERSIONS:]
            else:
                versions[0] = job
            self._t["job_versions"][key] = versions
            self._ensure_summary_locked(index, job)
            self._bump_locked("jobs", index)

    @staticmethod
    def _job_spec_changed(old: Job, new: Job) -> bool:
        """Did the user-facing spec change? (reference: Job.SpecChanged)"""
        import copy as _copy
        a, b = _copy.copy(old), _copy.copy(new)
        for j in (a, b):
            j.version = 0
            j.status = ""
            j.status_description = ""
            j.stable = False
            j.create_index = j.modify_index = j.job_modify_index = 0
            j.submit_time = 0.0
        return a != b

    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            key = (namespace, job_id)
            self._t["jobs"].pop(key, None)
            self._t["job_versions"].pop(key, None)
            self._t["job_summaries"].pop(key, None)
            self._t["periodic_launches"].pop(key, None)
            self._bump_locked("jobs", index)

    def update_job_stability(self, index: int, namespace: str, job_id: str,
                             version: int, stable: bool) -> None:
        with self._lock:
            self._update_job_stability_locked(index, namespace, job_id,
                                              version, stable)

    def _update_job_stability_locked(self, index: int, namespace: str,
                                     job_id: str, version: int,
                                     stable: bool) -> None:
        key = (namespace, job_id)
        for tbl in ("jobs",):
            j = self._t[tbl].get(key)
            if j is not None and j.version == version:
                import copy as _copy
                j2 = _copy.copy(j)
                j2.stable = stable
                j2.modify_index = index
                self._t[tbl][key] = j2
        versions = list(self._t["job_versions"].get(key, ()))
        for i, jv in enumerate(versions):
            if jv.version == version:
                import copy as _copy
                j2 = _copy.copy(jv)
                j2.stable = stable
                versions[i] = j2
        self._t["job_versions"][key] = versions
        self._bump_locked("jobs", index)

    def _mark_stable_locked(self, index: int, namespace: str,
                            job_id: str, version: int) -> None:
        self._update_job_stability_locked(index, namespace, job_id,
                                          version, True)

    def _ensure_summary_locked(self, index: int, job: Job) -> None:
        key = (job.namespace, job.id)
        summary = self._t["job_summaries"].get(key)
        if summary is None:
            summary = JobSummary(job.id, job.namespace)
            summary.create_index = index
        else:
            summary = summary.copy()
        for tg in job.task_groups:
            summary.summary.setdefault(tg.name, {
                "queued": 0, "complete": 0, "failed": 0,
                "running": 0, "starting": 0, "lost": 0})
        summary.modify_index = index
        self._t["job_summaries"][key] = summary

    def update_job_summary_queued(self, index: int, namespace: str,
                                  job_id: str, queued: Dict[str, int]) -> None:
        with self._lock:
            key = (namespace, job_id)
            summary = self._t["job_summaries"].get(key)
            if summary is None:
                return
            summary = summary.copy()
            for tg, n in queued.items():
                summary.summary.setdefault(tg, {
                    "queued": 0, "complete": 0, "failed": 0,
                    "running": 0, "starting": 0, "lost": 0})["queued"] = n
            summary.modify_index = index
            self._t["job_summaries"][key] = summary
            self._bump_locked("job_summaries", index)

    # -- evals --
    def upsert_evals(self, index: int, evals: List[Evaluation]) -> None:
        with self._lock:
            for e in evals:
                existing = self._t["evals"].get(e.id)
                if existing is not None:
                    e.create_index = existing.create_index
                else:
                    e.create_index = index
                e.modify_index = index
                self._t["evals"][e.id] = e
                self._refresh_job_status_locked(index, e.namespace, e.job_id)
            self._bump_locked("evals", index)

    def delete_eval(self, index: int, eval_ids: List[str],
                    alloc_ids: List[str] = ()) -> None:
        with self._lock:
            for eid in eval_ids:
                self._t["evals"].pop(eid, None)
            for aid in alloc_ids:
                self._remove_alloc_locked(aid, index)
            self._bump_locked("evals", index)
            if alloc_ids:
                self._bump_locked("allocs", index)

    def _refresh_job_status_locked(self, index: int, namespace: str,
                            job_id: str) -> None:
        """Keep Job.status in sync as evals/allocs flow (simplified
        reference: state_store.go setJobStatus/getJobStatus — called from
        eval upserts, plan application and client alloc updates)."""
        key = (namespace, job_id)
        job = self._t["jobs"].get(key)
        if job is None:
            return
        has_live_alloc = any(
            not self._t["allocs"][a].terminal_status()
            for a in self._t["_allocs_by_job"].get(key, ())
            if a in self._t["allocs"])
        has_open_eval = any(
            e.job_id == job_id and e.namespace == namespace
            and e.status in (EVAL_STATUS_PENDING, EVAL_STATUS_BLOCKED)
            for e in self._t["evals"].values())
        new_status = JOB_STATUS_DEAD
        if job.stopped():
            new_status = JOB_STATUS_DEAD
        elif has_live_alloc:
            new_status = JOB_STATUS_RUNNING
        elif has_open_eval or job.is_periodic() or job.is_parameterized():
            new_status = JOB_STATUS_PENDING
        if new_status != job.status:
            import copy as _copy
            j2 = _copy.copy(job)
            j2.status = new_status
            j2.modify_index = index
            self._t["jobs"][key] = j2

    # -- allocs --
    def upsert_allocs(self, index: int, allocs: List[Allocation]) -> None:
        with self._lock:
            for a in allocs:
                self._upsert_alloc_locked(index, a)
            # sorted: set order varies with PYTHONHASHSEED across
            # replica processes (nomadlint FSM103)
            for key in sorted({(a.namespace, a.job_id) for a in allocs}):
                self._refresh_job_status_locked(index, *key)
            self._bump_locked("allocs", index)

    def _upsert_alloc_locked(self, index: int, a: Allocation) -> None:
        existing = self._t["allocs"].get(a.id)
        if existing is not None:
            a.create_index = existing.create_index
            # server-side upserts keep client-reported state unless newer
            if not a.task_states and existing.task_states:
                a.task_states = existing.task_states
            if a.client_status == "" and existing.client_status:
                a.client_status = existing.client_status
        else:
            a.create_index = index
        a.modify_index = index
        self._update_deployment_with_alloc_locked(index, a, existing)
        self._update_summary_with_alloc_locked(index, a, existing)
        self._t["allocs"][a.id] = a
        self.changelog.append(index, "alloc", a.id)
        self._t["_allocs_by_node"].setdefault(a.node_id, set()).add(a.id)
        self._t["_allocs_by_job"].setdefault(
            (a.namespace, a.job_id), set()).add(a.id)
        # server-side terminal transitions (lost nodes, evictions) must
        # drop the alloc's service registrations too — the dead client
        # will never send the update that would
        self._sync_services_locked(index, a)

    _SUMMARY_BUCKETS = {"pending": "starting", "running": "running",
                        "complete": "complete", "failed": "failed",
                        "lost": "lost"}

    def _update_summary_with_alloc_locked(self, index: int, a: Allocation,
                                          existing) -> None:
        """Move the alloc between its job summary's status buckets
        (reference: state_store.go updateSummaryWithAlloc)."""
        key = (a.namespace, a.job_id)
        summary = self._t["job_summaries"].get(key)
        if summary is None:
            return
        old = (self._SUMMARY_BUCKETS.get(existing.client_status)
               if existing is not None else None)
        new = self._SUMMARY_BUCKETS.get(a.client_status)
        if old == new:
            return
        s2 = summary.copy()
        tg = s2.summary.setdefault(a.task_group, {
            "queued": 0, "complete": 0, "failed": 0, "running": 0,
            "starting": 0, "lost": 0})
        if old is not None and tg.get(old, 0) > 0:
            tg[old] -= 1
        if new is not None:
            tg[new] = tg.get(new, 0) + 1
        s2.modify_index = index
        self._t["job_summaries"][key] = s2
        self._bump_locked("job_summaries", index)

    def _update_deployment_with_alloc_locked(self, index: int, a: Allocation,
                                             existing) -> None:
        """Track per-task-group deployment progress as allocs are written
        (reference: state_store.go:4317 updateDeploymentWithAlloc) —
        placements bump placed_allocs/placed_canaries; health transitions
        move healthy/unhealthy counters."""
        if not a.deployment_id:
            return
        dep = self._t["deployments"].get(a.deployment_id)
        if dep is None or a.task_group not in dep.task_groups:
            return
        placed = healthy = unhealthy = 0
        ex_set = (existing is not None and existing.deployment_status is not None
                  and existing.deployment_status.healthy is not None)
        new_set = (a.deployment_status is not None
                   and a.deployment_status.healthy is not None)
        if existing is None or existing.deployment_id != a.deployment_id:
            placed += 1
        elif not ex_set and new_set:
            if a.deployment_status.healthy:
                healthy += 1
            else:
                unhealthy += 1
        elif ex_set and new_set:
            if (existing.deployment_status.healthy
                    and not a.deployment_status.healthy):
                healthy -= 1
                unhealthy += 1
        is_canary = (a.deployment_status is not None
                     and a.deployment_status.canary)
        if placed == 0 and healthy == 0 and unhealthy == 0 and not is_canary:
            return
        if a.deployment_status is not None and (healthy != 0
                                                or unhealthy != 0):
            a.deployment_status.modify_index = index
        d2 = dep.copy()
        d2.modify_index = index
        state = d2.task_groups[a.task_group]
        state.placed_allocs += placed
        state.healthy_allocs += healthy
        state.unhealthy_allocs += unhealthy
        if is_canary and a.id not in state.placed_canaries:
            state.placed_canaries.append(a.id)
        self._t["deployments"][d2.id] = d2

    def _remove_alloc_locked(self, alloc_id: str, index: int = 0) -> None:
        a = self._t["allocs"].pop(alloc_id, None)
        if a is None:
            return
        self.changelog.append(index or self.index, "alloc", alloc_id)
        s = self._t["_allocs_by_node"].get(a.node_id)
        if s:
            s.discard(alloc_id)
        s = self._t["_allocs_by_job"].get((a.namespace, a.job_id))
        if s:
            s.discard(alloc_id)
        # a reaped alloc releases its CSI claims even if it never
        # reported client-terminal (lost node, forced GC) — otherwise
        # the volume is stuck in-use forever
        self._release_csi_claims_locked(index or self.index, alloc_id)
        self._drop_services_locked(index or self.index, alloc_id)

    def update_allocs_from_client(self, index: int,
                                  updates: List[Allocation]) -> None:
        """Apply client status updates (reference: fsm.go:749
        applyAllocClientUpdate — merges client fields into stored alloc)."""
        with self._lock:
            for upd in updates:
                existing = self._t["allocs"].get(upd.id)
                if existing is None:
                    continue
                import copy as _copy
                a = _copy.copy(existing)
                a.client_status = upd.client_status
                a.client_description = upd.client_description
                a.task_states = dict(upd.task_states)
                a.deployment_status = upd.deployment_status
                a.modify_index = index
                a.modify_time = upd.modify_time or a.modify_time
                self._update_deployment_with_alloc_locked(index, a, existing)
                self._update_summary_with_alloc_locked(index, a, existing)
                if (a.client_terminal_status()
                        and not existing.client_terminal_status()):
                    # terminal allocs release their CSI volume claims
                    # (reference: csi_hook postrun -> Volume.Unpublish)
                    self._release_csi_claims_locked(index, a.id)
                self._t["allocs"][a.id] = a
                self.changelog.append(index, "alloc", a.id)
                self._sync_services_locked(index, a)
            # sorted for replica determinism (nomadlint FSM103)
            for key in sorted({(u.namespace, u.job_id) for u in updates}):
                self._refresh_job_status_locked(index, *key)
            self._bump_locked("allocs", index)

    # -- native service discovery (derived from task liveness) --
    def _sync_services_locked(self, index: int, alloc) -> None:
        """Recompute the alloc's registrations from its task states
        (reference: the consul service hook register/deregister on task
        start/stop; here the catalog is native, FSM-deterministic).
        Idempotent: the table index only bumps when the registration set
        actually changes, so blocking-query watchers don't wake on
        unrelated alloc updates."""
        from ..structs.services import ServiceRegistration
        from ..structs import TASK_STATE_RUNNING
        job = alloc.job or self._t["jobs"].get(
            (alloc.namespace, alloc.job_id))
        current = {k: r for k, r in self._t["services"].items()
                   if r.alloc_id == alloc.id}
        desired = {}
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if (tg is not None and not alloc.client_terminal_status()
                and not alloc.server_terminal_status()):
            node = self._t["nodes"].get(alloc.node_id)
            address = ""
            if node is not None and node.node_resources.networks:
                address = node.node_resources.networks[0].ip
            for task in tg.tasks:
                st = alloc.task_states.get(task.name)
                if st is None or st.state != TASK_STATE_RUNNING:
                    continue
                tr = alloc.allocated_resources.tasks.get(task.name)
                for svc in task.services:
                    port = 0
                    if tr is not None and svc.port_label:
                        for net in tr.networks:
                            for p in (list(net.reserved_ports)
                                      + list(net.dynamic_ports)):
                                if p.label == svc.port_label:
                                    port = p.value
                    rid = f"{alloc.id}-{task.name}-{svc.name}"
                    healthy = all(
                        st.checks.get(
                            f"{svc.name}/{c.name or c.type}", False)
                        for c in svc.checks) if svc.checks else True
                    desired[rid] = ServiceRegistration(
                        id=rid, service_name=svc.name,
                        namespace=alloc.namespace,
                        job_id=alloc.job_id, alloc_id=alloc.id,
                        node_id=alloc.node_id, task=task.name,
                        address=address, port=port,
                        tags=list(svc.tags), healthy=healthy,
                        create_index=index, modify_index=index)
        same = (current.keys() == desired.keys() and all(
            (current[k].address, current[k].port, current[k].tags,
             current[k].healthy)
            == (desired[k].address, desired[k].port, desired[k].tags,
                desired[k].healthy)
            for k in desired))
        if same:
            return
        # sorted: the table dict's residual insertion order must not
        # depend on set-difference order (nomadlint FSM103)
        for k in sorted(current.keys() - desired.keys()):
            del self._t["services"][k]
        for k, reg in desired.items():
            old = current.get(k)
            if old is not None:
                reg.create_index = old.create_index
            self._t["services"][k] = reg
        self._bump_locked("services", index)

    def _drop_services_locked(self, index: int, alloc_id: str,
                              bump: bool = True) -> bool:
        doomed = [k for k, r in self._t["services"].items()
                  if r.alloc_id == alloc_id]
        for k in doomed:
            del self._t["services"][k]
        if doomed and bump:
            self._bump_locked("services", index)
        return bool(doomed)

    def service_names(self, namespace: str = "default"):
        with self._lock:
            out = {}
            for r in self._t["services"].values():
                if r.namespace != namespace:
                    continue
                out.setdefault(r.service_name, set()).update(r.tags)
            return [{"ServiceName": name, "Tags": sorted(tags)}
                    for name, tags in sorted(out.items())]

    def services_by_name(self, namespace: str, name: str):
        with self._lock:
            return sorted((r for r in self._t["services"].values()
                           if r.namespace == namespace
                           and r.service_name == name),
                          key=lambda r: r.id)

    # -- secrets (native KV; the Vault-analog secret store) --
    def upsert_secret(self, index: int, namespace: str, path: str,
                      data: Dict[str, str]) -> None:
        with self._lock:
            self._t["secrets"][(namespace, path)] = dict(data)
            self._bump_locked("secrets", index)

    def delete_secret(self, index: int, namespace: str,
                      path: str) -> None:
        with self._lock:
            self._t["secrets"].pop((namespace, path), None)
            self._bump_locked("secrets", index)

    def secret_by_path(self, namespace: str, path: str):
        with self._lock:
            d = self._t["secrets"].get((namespace, path))
            return dict(d) if d is not None else None

    def secret_paths(self, namespace: str = "default"):
        with self._lock:
            return sorted(p for (ns, p) in self._t["secrets"]
                          if ns == namespace)

    # -- ACL (reference: state_store.go ACLPolicy/ACLToken tables) --
    def set_acl_bootstrapped(self, index: int) -> None:
        with self._lock:
            self._t["cluster_meta"]["acl_bootstrapped"] = True
            self._bump_locked("cluster_meta", index)

    def acl_bootstrapped(self) -> bool:
        with self._lock:
            return bool(self._t["cluster_meta"].get("acl_bootstrapped"))

    def upsert_acl_policy(self, index: int, policy) -> None:
        with self._lock:
            import copy as _copy
            p = _copy.copy(policy)
            existing = self._t["acl_policies"].get(p.name)
            p.create_index = existing.create_index if existing else index
            p.modify_index = index
            self._t["acl_policies"][p.name] = p
            self._bump_locked("acl_policies", index)

    def delete_acl_policy(self, index: int, name: str) -> None:
        with self._lock:
            self._t["acl_policies"].pop(name, None)
            self._bump_locked("acl_policies", index)

    def acl_policy_by_name(self, name: str):
        with self._lock:
            return self._t["acl_policies"].get(name)

    def acl_policies(self):
        with self._lock:
            return sorted(self._t["acl_policies"].values(),
                          key=lambda p: p.name)

    def upsert_acl_token(self, index: int, token) -> None:
        with self._lock:
            import copy as _copy
            t = _copy.copy(token)
            existing = self._t["acl_tokens"].get(t.accessor_id)
            t.create_index = existing.create_index if existing else index
            t.modify_index = index
            self._t["acl_tokens"][t.accessor_id] = t
            self._bump_locked("acl_tokens", index)

    def delete_acl_token(self, index: int, accessor_id: str) -> None:
        with self._lock:
            self._t["acl_tokens"].pop(accessor_id, None)
            self._bump_locked("acl_tokens", index)

    def acl_token_by_accessor(self, accessor_id: str):
        with self._lock:
            return self._t["acl_tokens"].get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        with self._lock:
            for t in self._t["acl_tokens"].values():
                if t.secret_id == secret_id:
                    return t
            return None

    def acl_tokens(self):
        with self._lock:
            return sorted(self._t["acl_tokens"].values(),
                          key=lambda t: t.accessor_id)

    # -- CSI volumes (reference: state_store.go CSIVolumeRegister/Claim) --
    def upsert_csi_volume(self, index: int, vol) -> None:
        with self._lock:
            import copy as _copy
            v = _copy.copy(vol)
            existing = self._t["csi_volumes"].get((v.namespace, v.id))
            if existing is not None:
                # re-registration must not wipe live claims (a cleared
                # write_claims would re-admit a second writer on a
                # single-writer volume)
                v.read_claims = dict(existing.read_claims)
                v.write_claims = dict(existing.write_claims)
                v.create_index = existing.create_index
            v.modify_index = index
            self._t["csi_volumes"][(v.namespace, v.id)] = v
            self._bump_locked("csi_volumes", index)

    def delete_csi_volume(self, index: int, namespace: str,
                          vol_id: str) -> None:
        with self._lock:
            v = self._t["csi_volumes"].get((namespace, vol_id))
            if v is not None and v.in_use():
                raise ValueError(f"volume {vol_id} is in use")
            self._t["csi_volumes"].pop((namespace, vol_id), None)
            self._bump_locked("csi_volumes", index)

    def csi_volume_by_id(self, namespace: str, vol_id: str):
        with self._lock:
            return self._t["csi_volumes"].get((namespace, vol_id))

    def csi_volumes(self, namespace: Optional[str] = None):
        with self._lock:
            return [v for (ns, _vid), v in
                    sorted(self._t["csi_volumes"].items())
                    if namespace is None or ns == namespace]

    def claim_csi_volume(self, index: int, namespace: str, vol_id: str,
                         mode: str, alloc_id: str, node_id: str) -> None:
        with self._lock:
            v = self._t["csi_volumes"].get((namespace, vol_id))
            if v is None:
                raise KeyError(f"volume {vol_id} not found")
            import copy as _copy
            v2 = _copy.copy(v)
            v2.read_claims = dict(v.read_claims)
            v2.write_claims = dict(v.write_claims)
            v2.claim(mode, alloc_id, node_id)
            v2.modify_index = index
            self._t["csi_volumes"][(namespace, vol_id)] = v2
            self._bump_locked("csi_volumes", index)

    def release_csi_claims(self, index: int, alloc_id: str) -> None:
        with self._lock:
            self._release_csi_claims_locked(index, alloc_id)

    def _release_csi_claims_locked(self, index: int,
                                   alloc_id: str) -> None:
        changed = False
        import copy as _copy
        for key, v in list(self._t["csi_volumes"].items()):
            if alloc_id in v.read_claims or alloc_id in v.write_claims:
                v2 = _copy.copy(v)
                v2.read_claims = dict(v.read_claims)
                v2.write_claims = dict(v.write_claims)
                v2.release(alloc_id)
                v2.modify_index = index
                self._t["csi_volumes"][key] = v2
                changed = True
        if changed:
            self._bump_locked("csi_volumes", index)

    def update_alloc_desired_transition(self, index: int, alloc_ids: List[str],
                                        transition) -> None:
        with self._lock:
            for aid in alloc_ids:
                existing = self._t["allocs"].get(aid)
                if existing is None:
                    continue
                import copy as _copy
                a = _copy.copy(existing)
                a.desired_transition = transition
                a.modify_index = index
                self._t["allocs"][aid] = a
            self._bump_locked("allocs", index)

    # -- plan results (the single commit path; reference fsm.go:918) --
    def upsert_plan_results(self, index: int, result: PlanResult,
                            job: Optional[Job] = None) -> None:
        with self._lock:
            # deployment first so _update_deployment_with_alloc_locked sees
            # it when the plan's own placements land (reference order,
            # state_store.go:253-263)
            if result.deployment is not None:
                self._upsert_deployment_locked(index, result.deployment)
            for du in result.deployment_updates:
                self._apply_deployment_update_locked(index, du)
            for allocs in result.node_update.values():
                for a in allocs:
                    existing = self._t["allocs"].get(a.id)
                    if existing is not None and a.job is None:
                        a.job = existing.job
                    self._upsert_alloc_locked(index, a)
            for allocs in result.node_allocation.values():
                for a in allocs:
                    if a.job is None:
                        a.job = job
                    self._upsert_alloc_locked(index, a)
            for allocs in result.node_preemptions.values():
                for a in allocs:
                    existing = self._t["allocs"].get(a.id)
                    if existing is not None and a.job is None:
                        a.job = existing.job
                    self._upsert_alloc_locked(index, a)
            touched = set()
            for m in (result.node_update, result.node_allocation,
                      result.node_preemptions):
                for allocs in m.values():
                    touched.update((a.namespace, a.job_id) for a in allocs)
            # sorted for replica determinism (nomadlint FSM103)
            for key in sorted(touched):
                self._refresh_job_status_locked(index, *key)
            self._bump_locked("allocs", index)

    # -- deployments --
    def upsert_deployment(self, index: int, dep: Deployment) -> None:
        with self._lock:
            self._upsert_deployment_locked(index, dep)
            self._bump_locked("deployments", index)

    def _upsert_deployment_locked(self, index: int, dep: Deployment) -> None:
        existing = self._t["deployments"].get(dep.id)
        if existing is not None:
            dep.create_index = existing.create_index
        else:
            dep.create_index = index
        dep.modify_index = index
        self._t["deployments"][dep.id] = dep

    def _apply_deployment_update_locked(self, index: int, du) -> None:
        dep = self._t["deployments"].get(du.deployment_id)
        if dep is None:
            return
        d2 = dep.copy()
        d2.status = du.status
        d2.status_description = du.status_description
        d2.modify_index = index
        self._t["deployments"][du.deployment_id] = d2
        # a deployment going SUCCESSFUL marks its job version stable in
        # the SAME apply, no matter which path flipped it — the watcher
        # or a reconciler plan (reference: state_store.go
        # updateDeploymentStatusImpl -> updateJobStabilityImpl; the
        # watcher racing the plan applier must not lose the stability
        # bit)
        from ..structs import DEPLOYMENT_STATUS_SUCCESSFUL
        if (du.status == DEPLOYMENT_STATUS_SUCCESSFUL
                and dep.status != DEPLOYMENT_STATUS_SUCCESSFUL):
            self._mark_stable_locked(index, dep.namespace, dep.job_id,
                                     dep.job_version)

    def upsert_deployment_updates(self, index: int, updates) -> None:
        """Standalone deployment status updates (reference:
        fsm.go applyDeploymentStatusUpdate)."""
        with self._lock:
            for du in updates:
                self._apply_deployment_update_locked(index, du)
            self._bump_locked("deployments", index)

    def update_deployment_promotion(self, index: int, dep_id: str,
                                    groups=None) -> None:
        """Flip promoted for canary groups (reference:
        state_store.go UpdateDeploymentPromotion). groups=None promotes
        every canary group."""
        with self._lock:
            dep = self._t["deployments"].get(dep_id)
            if dep is None:
                raise KeyError(f"deployment {dep_id} not found")
            d2 = dep.copy()
            for name, state in d2.task_groups.items():
                if state.desired_canaries <= 0:
                    continue
                if groups is not None and name not in groups:
                    continue
                state.promoted = True
            d2.status_description = "Deployment is running"
            d2.modify_index = index
            self._t["deployments"][dep_id] = d2
            self._bump_locked("deployments", index)

    def delete_deployment(self, index: int, dep_ids: List[str]) -> None:
        with self._lock:
            for did in dep_ids:
                self._t["deployments"].pop(did, None)
            self._bump_locked("deployments", index)

    # -- scheduler config --
    def set_scheduler_config(self, index: int,
                             cfg: SchedulerConfiguration) -> None:
        with self._lock:
            cfg.modify_index = index
            self._t["scheduler_config"]["config"] = cfg
            self._bump_locked("scheduler_config", index)

    # -- periodic launches --
    def upsert_periodic_launch(self, index: int, namespace: str, job_id: str,
                               launch_time: float) -> None:
        with self._lock:
            self._t["periodic_launches"][(namespace, job_id)] = launch_time
            self._bump_locked("periodic_launches", index)

    def periodic_launch(self, namespace: str, job_id: str) -> Optional[float]:
        with self._lock:    # guarded table; lockless read is racy
            return self._t["periodic_launches"].get((namespace, job_id))
