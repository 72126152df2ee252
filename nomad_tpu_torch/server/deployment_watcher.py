"""Leader-side deployment watcher (reference: nomad/deploymentwatcher/ —
Watcher deployments_watcher.go:60, per-deployment deployment_watcher.go,
health batching batcher.go).

Consumes the health counters the state store tracks as client updates
land, and reacts:
  - progress (new healthy allocs)  -> next-batch eval (rolling update)
  - all canaries healthy           -> auto-promote (or wait for manual)
  - any unhealthy alloc            -> fail; auto-revert to the latest
                                      stable job version if configured
  - progress deadline exceeded     -> fail (+ auto-revert)
  - all groups fully healthy       -> successful + mark job version stable

One watcher thread covers all deployments (the reference runs one
goroutine per deployment; the reaction logic is identical). Per-
deployment bookkeeping (last-seen counters, progress deadlines) is
leader-local in-memory state, as in the reference.

The counterpart of `nomad_tpu.server.deployment_watcher`.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, Optional

from ..structs import (DEPLOYMENT_DESC_FAILED_ALLOCS,
                       DEPLOYMENT_DESC_PROGRESS_DEADLINE,
                       DEPLOYMENT_DESC_SUCCESSFUL,
                       DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_RUNNING,
                       DEPLOYMENT_STATUS_SUCCESSFUL,
                       EVAL_STATUS_PENDING, EVAL_TRIGGER_DEPLOYMENT_WATCHER,
                       Deployment, DeploymentStatusUpdate, Evaluation)

_log = logging.getLogger(__name__)

DESC_AUTO_REVERT_SUFFIX = " - rolling back to job version {}"


class _DepState:
    __slots__ = ("healthy", "unhealthy", "placed", "promoted",
                 "progress_deadline")

    def __init__(self):
        self.healthy = -1
        self.unhealthy = 0
        self.placed = 0
        self.promoted = False
        self.progress_deadline = 0.0


class DeploymentWatcher:
    def __init__(self, server, poll_interval_s: float = 0.05):
        self.server = server
        self.poll_interval_s = poll_interval_s
        self._state: Dict[str, _DepState] = {}
        self._enabled = False
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def set_enabled(self, enabled: bool) -> None:
        thread = None
        with self._cv:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                # thread handle guarded by _cv
                self._thread = threading.Thread(target=self._watch,
                                                daemon=True)
                self._thread.start()
            else:
                self._state.clear()
                thread, self._thread = self._thread, None
                self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=1.0)

    # ------------------------------------------------------------- loop
    def _watch(self) -> None:
        store = self.server.store
        while True:
            with self._cv:
                if not self._enabled:
                    return
            try:
                for dep in list(store.deployments()):
                    if dep.active():
                        self._check(dep)
                    else:
                        with self._cv:
                            self._state.pop(dep.id, None)
            except Exception:
                _log.exception("deployment watcher pass failed")
            # block until new writes (health updates bump the store) or a
            # short tick for deadline checks
            store.wait_for_change(store.latest_index(),
                                  self.poll_interval_s * 4)

    # ------------------------------------------------------------ checks
    def _dep_state(self, dep_id: str) -> "_DepState":
        with self._cv:   # _state is cleared by set_enabled(False)
            st = self._state.get(dep_id)
            if st is None:
                st = self._state[dep_id] = _DepState()
            return st

    def _check(self, dep: Deployment) -> None:
        now = _time.time()
        st = self._dep_state(dep.id)
        healthy = sum(s.healthy_allocs for s in dep.task_groups.values())
        unhealthy = sum(s.unhealthy_allocs
                        for s in dep.task_groups.values())
        placed = sum(s.placed_allocs for s in dep.task_groups.values())

        # 1. failure: any alloc reported unhealthy
        if unhealthy > 0:
            self._fail(dep, DEPLOYMENT_DESC_FAILED_ALLOCS)
            return

        # 2. progress deadline (reference: deployment_watcher.go
        # watch's deadline timer; reset whenever progress is made)
        deadline_s = max((s.progress_deadline_s
                          for s in dep.task_groups.values()), default=0.0) \
            or self._job_progress_deadline(dep)
        if st.progress_deadline == 0.0 or healthy > max(st.healthy, 0):
            st.progress_deadline = now + deadline_s if deadline_s else 0.0
        if st.progress_deadline and now > st.progress_deadline:
            self._fail(dep, DEPLOYMENT_DESC_PROGRESS_DEADLINE)
            return

        # 3. canary auto-promotion
        if dep.requires_promotion():
            if dep.has_auto_promote() and self._canaries_healthy(dep):
                try:
                    self.server.promote_deployment(dep.id, all_groups=True)
                except ValueError:
                    pass               # canary health regressed; re-check
            st.healthy, st.unhealthy, st.placed = healthy, unhealthy, placed
            return

        # 4. complete: every group fully healthy
        complete = all(s.healthy_allocs >= s.desired_total
                       for s in dep.task_groups.values())
        if complete and dep.status == DEPLOYMENT_STATUS_RUNNING:
            self._succeed(dep)
            return

        # 5. progress: new healthy allocs unblock the next rolling batch.
        # The baseline is 0, not the first observation — health reported
        # before our first scan still counts as progress, otherwise the
        # rollout stalls until the progress deadline kills it
        if healthy > max(st.healthy, 0):
            self._create_eval(dep, EVAL_TRIGGER_DEPLOYMENT_WATCHER)
        st.healthy, st.unhealthy, st.placed = healthy, unhealthy, placed

    def _job_progress_deadline(self, dep: Deployment) -> float:
        job = self.server.store.job_by_id(dep.namespace, dep.job_id)
        if job is None:
            return 600.0
        out = 0.0
        for tg in job.task_groups:
            if tg.update is not None:
                out = max(out, tg.update.progress_deadline_s)
        return out or 600.0

    def _canaries_healthy(self, dep: Deployment) -> bool:
        # single source of truth with manual promotion's validation
        return not self.server._unhealthy_canary_groups(dep)

    # ----------------------------------------------------------- actions
    def _create_eval(self, dep: Deployment, trigger: str) -> None:
        job = self.server.store.job_by_id(dep.namespace, dep.job_id)
        if job is None or job.stopped():
            return
        self.server.upsert_evals([Evaluation(
            namespace=dep.namespace, job_id=dep.job_id, type=job.type,
            priority=job.priority, triggered_by=trigger,
            deployment_id=dep.id, status=EVAL_STATUS_PENDING)])

    def _succeed(self, dep: Deployment) -> None:
        self.server.apply_deployment_status_update(
            DeploymentStatusUpdate(
                deployment_id=dep.id,
                status=DEPLOYMENT_STATUS_SUCCESSFUL,
                status_description=DEPLOYMENT_DESC_SUCCESSFUL),
            mark_stable=(dep.namespace, dep.job_id, dep.job_version))
        with self._cv:
            self._state.pop(dep.id, None)

    def _fail(self, dep: Deployment, desc: str) -> None:
        """Fail the deployment; auto-revert to the latest stable job
        version when the update stanza asks for it
        (reference: deployment_watcher.go FailDeployment + the
        auto-revert path in watchers' handleAllocUpdate)."""
        rollback_job = None
        if any(s.auto_revert for s in dep.task_groups.values()):
            rollback_job = self._latest_stable_job(dep)
        # same-spec guard (reference: deployment_watcher.go:357
        # FailDeployment rollback skips when the stable spec equals the
        # current one) — otherwise a failed re-revert loops forever
        if rollback_job is not None:
            current = self.server.store.job_by_id(dep.namespace,
                                                  dep.job_id)
            from ..state.store import StateStore
            if current is not None and \
                    not StateStore._job_spec_changed(current, rollback_job):
                rollback_job = None
        if rollback_job is not None:
            desc += DESC_AUTO_REVERT_SUFFIX.format(rollback_job.version)
        self.server.apply_deployment_status_update(DeploymentStatusUpdate(
            deployment_id=dep.id, status=DEPLOYMENT_STATUS_FAILED,
            status_description=desc))
        with self._cv:
            self._state.pop(dep.id, None)
        if rollback_job is not None:
            self.server.revert_job(rollback_job)
        else:
            self._create_eval(dep, EVAL_TRIGGER_DEPLOYMENT_WATCHER)

    def _latest_stable_job(self, dep: Deployment):
        """Newest job version marked stable, older than the deploying one
        (reference: state JobVersionsByID + latestStableVersion)."""
        versions = self.server.store.job_versions(dep.namespace, dep.job_id)
        stable = [j for j in versions
                  if j.stable and j.version != dep.job_version]
        if not stable:
            return None
        return max(stable, key=lambda j: j.version)
