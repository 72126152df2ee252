"""Core "scheduler": administrative GC driven by core evals.

Reference: nomad/core_sched.go — Process :46, jobGC :84, evalGC :222,
nodeGC :425, deploymentGC :536, forceGC :67, allocGCEligible :648.
Core evals are enqueued by the leader's periodic timers (leader.go:513
schedulePeriodic) and by explicit force-GC; they carry the GC kind in
job_id. Time cutoffs map to indexes through the server's TimeTable.

The counterpart of `nomad_tpu.scheduler.core`.
"""
from __future__ import annotations

import time as _time
from typing import List, Optional, Tuple

from ..structs import (ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING,
                       ALLOC_DESIRED_STOP, JOB_STATUS_DEAD, JOB_TYPE_BATCH,
                       Allocation, Evaluation, Job)

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_FORCE_GC = "force-gc"

_MAX_INDEX = 2**62


def alloc_gc_eligible(a: Allocation, job: Optional[Job], gc_time: float,
                      threshold_index: int) -> bool:
    """reference: core_sched.go:648 allocGCEligible."""
    if not a.terminal_status() or a.modify_index > threshold_index:
        return False
    if a.client_status == ALLOC_CLIENT_RUNNING:
        return False
    if job is None or job.stop or job.status == JOB_STATUS_DEAD:
        return True
    if a.desired_status == ALLOC_DESIRED_STOP:
        return True
    if a.client_status != ALLOC_CLIENT_FAILED:
        return True
    tg = job.lookup_task_group(a.task_group)
    policy = tg.reschedule_policy if tg else None
    if policy is None or (not policy.unlimited and policy.attempts == 0):
        return True
    if a.next_allocation:
        # reschedule information has been carried forward
        return True
    if policy.unlimited:
        return False
    events = (a.reschedule_tracker.events
              if a.reschedule_tracker else [])
    if not events:
        return False
    # don't GC while the latest attempt is inside the policy interval
    return gc_time - events[-1].reschedule_time > policy.interval_s


class CoreScheduler:
    """Processes JOB_TYPE_CORE evals against a state snapshot, issuing
    reaps through the server's write paths (the leader-RPC analog)."""

    def __init__(self, server, snapshot):
        self.server = server
        self.snap = snapshot

    def process(self, ev: Evaluation) -> None:
        kind = ev.job_id.split(":")[0]
        if kind == CORE_JOB_EVAL_GC:
            self.eval_gc(ev)
        elif kind == CORE_JOB_NODE_GC:
            self.node_gc(ev)
        elif kind == CORE_JOB_JOB_GC:
            self.job_gc(ev)
        elif kind == CORE_JOB_DEPLOYMENT_GC:
            self.deployment_gc(ev)
        elif kind == CORE_JOB_FORCE_GC:
            self.force_gc(ev)
        else:
            raise ValueError(f"core scheduler cannot handle job {ev.job_id!r}")

    def force_gc(self, ev: Evaluation) -> None:
        self.job_gc(ev)
        self.eval_gc(ev)
        self.deployment_gc(ev)
        # node GC last so the alloc tables are already cleared
        self.node_gc(ev)

    # ------------------------------------------------------------ cutoffs
    def _threshold(self, ev: Evaluation, threshold_s: float) -> int:
        if ev.job_id.split(":")[0] == CORE_JOB_FORCE_GC:
            return _MAX_INDEX
        cutoff = _time.time() - threshold_s
        return self.server.time_table.nearest_index(cutoff)

    # ------------------------------------------------------------- passes
    def eval_gc(self, ev: Evaluation) -> None:
        threshold = self._threshold(ev, self.server.eval_gc_threshold_s)
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for e in list(self.snap.evals()):
            gc, allocs = self._gc_eval(e, threshold, allow_batch=False)
            if gc:
                gc_evals.append(e.id)
            gc_allocs.extend(allocs)
        if gc_evals or gc_allocs:
            self.server.reap_evals(gc_evals, gc_allocs)

    def _gc_eval(self, e: Evaluation, threshold: int,
                 allow_batch: bool) -> Tuple[bool, List[str]]:
        """reference: core_sched.go:280 gcEval."""
        if not e.terminal_status() or e.modify_index > threshold:
            return False, []
        job = self.snap.job_by_id(e.namespace, e.job_id)
        allocs = self.snap.allocs_by_eval(e.id)
        if e.type == JOB_TYPE_BATCH:
            # a running batch job's terminal allocs must survive GC or the
            # scheduler would re-run them (core_sched.go:305)
            collect = (job is None
                       or (job.status == JOB_STATUS_DEAD
                           and (job.stop or allow_batch)))
            if not collect:
                old = [a.id for a in allocs
                       if a.job is not None and job is not None
                       and a.job.create_index < job.create_index
                       and a.terminal_status()]
                return False, old
        now = _time.time()
        gc_ids = []
        gc_ok = True
        for a in allocs:
            if alloc_gc_eligible(a, job, now, threshold):
                gc_ids.append(a.id)
            else:
                gc_ok = False
        return gc_ok, gc_ids

    def job_gc(self, ev: Evaluation) -> None:
        threshold = self._threshold(ev, self.server.job_gc_threshold_s)
        gc_jobs: List[Job] = []
        gc_evals: List[str] = []
        gc_allocs: List[str] = []
        for job in list(self.snap.jobs()):
            if not self._job_gc_eligible(job) or job.create_index > threshold:
                continue
            evals = self.snap.evals_by_job(job.namespace, job.id)
            all_gc = True
            job_evals: List[str] = []
            job_allocs: List[str] = []
            for e in evals:
                gc, allocs = self._gc_eval(e, threshold, allow_batch=True)
                if gc:
                    job_evals.append(e.id)
                    job_allocs.extend(allocs)
                else:
                    all_gc = False
                    break
            if all_gc:
                gc_jobs.append(job)
                gc_evals.extend(job_evals)
                gc_allocs.extend(job_allocs)
        if gc_evals or gc_allocs:
            self.server.reap_evals(gc_evals, gc_allocs)
        if gc_jobs:
            self.server.reap_jobs([(j.namespace, j.id) for j in gc_jobs])

    @staticmethod
    def _job_gc_eligible(job: Job) -> bool:
        """reference: state/schema.go:244 jobIsGCable — periodic and
        parameterized templates are GC'd on stop alone; other jobs must be
        dead AND either explicitly stopped or batch-typed (a dead-but-not-
        stopped service job keeps its definition)."""
        periodic_enabled = job.periodic is not None and job.periodic.enabled
        if job.is_parameterized() or periodic_enabled:
            return job.stop
        return (job.status == JOB_STATUS_DEAD
                and (job.stop or job.type == JOB_TYPE_BATCH))

    def node_gc(self, ev: Evaluation) -> None:
        threshold = self._threshold(ev, self.server.node_gc_threshold_s)
        gc_nodes: List[str] = []
        for node in list(self.snap.nodes()):
            if not node.terminal_status() or node.modify_index > threshold:
                continue
            allocs = self.snap.allocs_by_node(node.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            gc_nodes.append(node.id)
        if gc_nodes:
            self.server.reap_nodes(gc_nodes)

    def deployment_gc(self, ev: Evaluation) -> None:
        threshold = self._threshold(ev, self.server.deployment_gc_threshold_s)
        gc_deps: List[str] = []
        for dep in list(self.snap.deployments()):
            if dep.active() or dep.modify_index > threshold:
                continue
            allocs = self.snap.allocs_by_deployment(dep.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            gc_deps.append(dep.id)
        if gc_deps:
            self.server.reap_deployments(gc_deps)
