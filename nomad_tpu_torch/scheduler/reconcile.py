"""The allocation reconciler: pure diff of job spec vs cluster state.

Given (job, existing allocs, tainted nodes, active deployment) produce the
sets {place, stop, inplace, destructive, migrate} plus deployment
creation/updates and delayed-reschedule follow-up evals. No I/O, no device
code — this is the behavior-dense heart of service/batch scheduling.

Reference semantics: scheduler/reconcile.go (`allocReconciler` :39,
`Compute` :184, `computeGroup` :306, canary handling :566, `computeLimit`
:618, `computePlacements` :662, `computeStop` :699, `computeUpdates` :810,
delayed-reschedule batching :833).
"""
from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import (ALLOC_CLIENT_LOST, ALLOC_LOST,
                       ALLOC_MIGRATING, ALLOC_NOT_NEEDED, ALLOC_RESCHEDULED,
                       ALLOC_UPDATING,
                       DEPLOYMENT_DESC_AUTO_PROMOTION,
                       DEPLOYMENT_DESC_NEEDS_PROMOTION,
                       DEPLOYMENT_DESC_NEWER_JOB, DEPLOYMENT_DESC_STOPPED_JOB,
                       DEPLOYMENT_STATUS_CANCELLED,
                       DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_PAUSED,
                       DEPLOYMENT_STATUS_SUCCESSFUL,
                       DEPLOYMENT_DESC_SUCCESSFUL,
                       EVAL_STATUS_PENDING, EVAL_TRIGGER_FAILED_FOLLOW_UP,
                       Allocation, Deployment, DeploymentState,
                       DeploymentStatusUpdate, Evaluation, Job, Node,
                       TaskGroup)
from . import reconcile_util as rutil
from .reconcile_util import AllocSet

# Follow-up evals for delayed reschedules within this window share one eval.
BATCHED_FAILED_ALLOC_WINDOW_S = 5.0


@dataclass
class AllocPlaceResult:
    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    canary: bool = False


@dataclass
class AllocDestructiveResult:
    place_name: str
    place_task_group: TaskGroup
    stop_alloc: Allocation
    stop_status_description: str


@dataclass
class AllocStopResult:
    alloc: Allocation
    client_status: str = ""
    status_description: str = ""


@dataclass
class DesiredUpdates:
    """Per-task-group change accounting (surfaced by `plan` dry runs)."""
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0


@dataclass
class ReconcileResults:
    place: List[AllocPlaceResult] = field(default_factory=list)
    destructive_update: List[AllocDestructiveResult] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    stop: List[AllocStopResult] = field(default_factory=list)
    attribute_updates: Dict[str, Allocation] = field(default_factory=dict)
    deployment: Optional[Deployment] = None           # newly created
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    desired_tg_updates: Dict[str, DesiredUpdates] = field(default_factory=dict)
    desired_followup_evals: Dict[str, List[Evaluation]] = field(default_factory=dict)

    def changes(self) -> int:
        return (len(self.place) + len(self.inplace_update)
                + len(self.destructive_update) + len(self.stop))


# (existing alloc, new job, new tg) -> (ignore, destructive, inplace alloc)
AllocUpdateFn = Callable[[Allocation, Job, TaskGroup],
                         Tuple[bool, bool, Optional[Allocation]]]


class Reconciler:
    def __init__(self, alloc_update_fn: AllocUpdateFn, batch: bool,
                 job_id: str, job: Optional[Job],
                 deployment: Optional[Deployment],
                 existing_allocs: List[Allocation],
                 tainted_nodes: Dict[str, Optional[Node]],
                 eval_id: str, now: Optional[float] = None):
        self.alloc_update_fn = alloc_update_fn
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.deployment = deployment.copy() if deployment else None
        self.old_deployment: Optional[Deployment] = None
        self.existing_allocs = existing_allocs
        self.tainted_nodes = tainted_nodes
        self.eval_id = eval_id
        self.now = now if now is not None else _time.time()
        self.deployment_paused = False
        self.deployment_failed = False
        self.result = ReconcileResults()

    # ------------------------------------------------------------------ API
    def compute(self) -> ReconcileResults:
        matrix: Dict[str, AllocSet] = {}
        for a in self.existing_allocs:
            matrix.setdefault(a.task_group, {})[a.id] = a
        # groups in the job with no existing allocs still need placements
        if self.job is not None and not self.job.stopped():
            for tg in self.job.task_groups:
                matrix.setdefault(tg.name, {})

        self._cancel_deployments()

        if self.job is None or self.job.stopped():
            self._handle_stop(matrix)
            return self.result

        if self.deployment is not None:
            self.deployment_paused = (
                self.deployment.status == DEPLOYMENT_STATUS_PAUSED)
            self.deployment_failed = (
                self.deployment.status == DEPLOYMENT_STATUS_FAILED)

        complete = True
        for group, allocs in matrix.items():
            complete &= self._compute_group(group, allocs)

        # a finished deployment flips to successful
        if self.deployment is not None and complete:
            self.result.deployment_updates.append(DeploymentStatusUpdate(
                deployment_id=self.deployment.id,
                status=DEPLOYMENT_STATUS_SUCCESSFUL,
                status_description=DEPLOYMENT_DESC_SUCCESSFUL))

        # a created deployment advertises whether it awaits promotion
        d = self.result.deployment
        if d is not None and d.requires_promotion():
            d.status_description = (DEPLOYMENT_DESC_AUTO_PROMOTION
                                    if d.has_auto_promote()
                                    else DEPLOYMENT_DESC_NEEDS_PROMOTION)
        return self.result

    # ------------------------------------------------------- deployment mgmt
    def _cancel_deployments(self) -> None:
        if self.deployment is None:
            return
        d = self.deployment
        stopped = self.job is None or self.job.stopped()
        if stopped:
            if d.active():
                self.result.deployment_updates.append(DeploymentStatusUpdate(
                    deployment_id=d.id, status=DEPLOYMENT_STATUS_CANCELLED,
                    status_description=DEPLOYMENT_DESC_STOPPED_JOB))
            self.old_deployment = d
            self.deployment = None
            return
        # deployment for an older version of the job: cancel it
        if self.job is not None and (
                d.job_create_index != self.job.create_index
                or d.job_version != self.job.version):
            if d.active():
                self.result.deployment_updates.append(DeploymentStatusUpdate(
                    deployment_id=d.id, status=DEPLOYMENT_STATUS_CANCELLED,
                    status_description=DEPLOYMENT_DESC_NEWER_JOB))
            self.old_deployment = d
            self.deployment = None
            return
        # a finished-successful deployment is history; failed/cancelled ones
        # stay current so they keep gating placements
        if d.status == DEPLOYMENT_STATUS_SUCCESSFUL:
            self.old_deployment = d
            self.deployment = None

    # ---------------------------------------------------------- stopped job
    def _handle_stop(self, matrix: Dict[str, AllocSet]) -> None:
        for group, allocs in matrix.items():
            du = self.result.desired_tg_updates.setdefault(
                group, DesiredUpdates())
            remaining = rutil.filter_non_terminal(allocs)
            untainted, migrate, lost = rutil.filter_by_tainted(
                remaining, self.tainted_nodes)
            du.stop += len(remaining)
            self._mark_stop(untainted, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)

    def _mark_stop(self, allocs: AllocSet, client_status: str,
                   desc: str) -> None:
        for a in rutil.name_order(allocs):
            self.result.stop.append(AllocStopResult(
                alloc=a, client_status=client_status,
                status_description=desc))

    # ------------------------------------------------------------ per group
    def _compute_group(self, group: str, all_allocs: AllocSet) -> bool:
        du = self.result.desired_tg_updates.setdefault(group, DesiredUpdates())
        tg = self.job.lookup_task_group(group)

        # group removed from the job: stop everything
        if tg is None:
            untainted, migrate, lost = rutil.filter_by_tainted(
                all_allocs, self.tainted_nodes)
            remaining = rutil.filter_non_terminal(untainted)
            self._mark_stop(remaining, "", ALLOC_NOT_NEEDED)
            self._mark_stop(migrate, "", ALLOC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)
            du.stop += len(remaining) + len(migrate) + len(lost)
            return True

        # deployment state for this group
        existing_deployment = False
        dstate: Optional[DeploymentState] = None
        if self.deployment is not None:
            dstate = self.deployment.task_groups.get(group)
            existing_deployment = dstate is not None
        if dstate is None:
            dstate = DeploymentState()
            if tg.update is not None:
                dstate.auto_revert = tg.update.auto_revert
                dstate.auto_promote = tg.update.auto_promote
                dstate.progress_deadline_s = tg.update.progress_deadline_s

        all_allocs, old_ignore = self._filter_old_terminal(all_allocs)
        du.ignore += len(old_ignore)

        canaries, all_allocs = self._handle_group_canaries(all_allocs, du)

        untainted, migrate, lost = rutil.filter_by_tainted(
            all_allocs, self.tainted_nodes)

        untainted, resched_now, resched_later = rutil.filter_by_rescheduleable(
            untainted, self.batch, self.now, self.eval_id, self.deployment)

        self._handle_delayed_reschedules(resched_later, all_allocs, group)

        name_index = rutil.AllocNameIndex(
            self.job_id, group, tg.count,
            rutil.union(untainted, migrate, resched_now))

        canary_state = (dstate is not None and dstate.desired_canaries != 0
                        and not dstate.promoted)
        stop = self._compute_stop(tg, name_index, untainted, migrate, lost,
                                  canaries, canary_state)
        du.stop += len(stop)
        untainted = rutil.difference(untainted, stop)

        ignore, inplace, destructive = self._compute_updates(tg, untainted)
        du.ignore += len(ignore)
        du.in_place_update += len(inplace)
        if not existing_deployment:
            dstate.desired_total += len(destructive) + len(inplace)

        if canary_state:
            untainted = rutil.difference(untainted, canaries)

        # create canaries when a destructive change needs them
        strategy = tg.update
        canaries_promoted = dstate is not None and dstate.promoted
        require_canary = (len(destructive) != 0 and strategy is not None
                          and len(canaries) < strategy.canary
                          and not canaries_promoted)
        if (require_canary and not self.deployment_paused
                and not self.deployment_failed):
            number = strategy.canary - len(canaries)
            du.canary += number
            if not existing_deployment:
                dstate.desired_canaries = strategy.canary
            for name in name_index.next_canaries(number, canaries,
                                                 destructive):
                self.result.place.append(AllocPlaceResult(
                    name=name, task_group=tg, canary=True))

        canary_state = (dstate is not None and dstate.desired_canaries != 0
                        and not dstate.promoted)
        limit = self._compute_limit(tg, untainted, destructive, migrate,
                                    canary_state)

        place = self._compute_placements(tg, name_index, untainted, migrate,
                                         resched_now)
        if not existing_deployment:
            dstate.desired_total += len(place)

        place_ready = (not self.deployment_paused
                       and not self.deployment_failed and not canary_state)
        if place_ready:
            du.place += len(place)
            self.result.place.extend(place)
            # the failed allocs being replaced right now are stopped
            self._mark_stop(resched_now, "", ALLOC_RESCHEDULED)
            du.stop += len(resched_now)
            # placements consume the rolling-update budget first
            limit -= min(len(place), limit)
        else:
            # even a gated deployment replaces lost capacity and failed
            # allocs (unless the failure is part of the failed deployment)
            if lost:
                allowed = min(len(lost), len(place))
                du.place += allowed
                self.result.place.extend(place[:allowed])
            if resched_now:
                for p in place:
                    prev = p.previous_alloc
                    if not p.reschedule:
                        continue
                    if (self.deployment_failed and prev is not None
                            and self.deployment is not None
                            and prev.deployment_id == self.deployment.id):
                        continue
                    self.result.place.append(p)
                    du.place += 1
                    self.result.stop.append(AllocStopResult(
                        alloc=prev, status_description=ALLOC_RESCHEDULED))
                    du.stop += 1

        if place_ready:
            n = min(len(destructive), limit)
            du.destructive_update += n
            du.ignore += len(destructive) - n
            for a in rutil.name_order(destructive)[:n]:
                self.result.destructive_update.append(AllocDestructiveResult(
                    place_name=a.name, place_task_group=tg, stop_alloc=a,
                    stop_status_description=ALLOC_UPDATING))
        else:
            du.ignore += len(destructive)

        # migrations always happen: stop on the old node, place on a new one
        du.migrate += len(migrate)
        for a in rutil.name_order(migrate):
            self.result.stop.append(AllocStopResult(
                alloc=a, status_description=ALLOC_MIGRATING))
            self.result.place.append(AllocPlaceResult(
                name=a.name, task_group=tg, previous_alloc=a))

        # create a deployment only on first run or a spec change — not for
        # routine reschedules/lost replacements of the current version
        updating_spec = bool(destructive) or bool(self.result.inplace_update)
        had_running = any(
            a.job is not None and a.job.version == self.job.version
            and a.job.create_index == self.job.create_index
            for a in all_allocs.values())
        if (not existing_deployment and strategy is not None
                and strategy.rolling() and dstate.desired_total != 0
                and (not had_running or updating_spec)
                and not self.job.is_batch()):
            if self.deployment is None:
                self.deployment = Deployment(
                    namespace=self.job.namespace, job_id=self.job.id,
                    job_version=self.job.version,
                    job_modify_index=self.job.modify_index,
                    job_create_index=self.job.create_index)
                self.result.deployment = self.deployment
            self.deployment.task_groups[group] = dstate

        deployment_complete = (
            not destructive and not inplace and not place and not migrate
            and not resched_now and not resched_later and not require_canary)
        # and every deployment alloc must be healthy (auto-revert depends on
        # the deployment staying non-successful until then)
        if deployment_complete and self.deployment is not None:
            ds = self.deployment.task_groups.get(group)
            if ds is not None:
                if (ds.healthy_allocs < max(ds.desired_total,
                                            ds.desired_canaries)
                        or (ds.desired_canaries > 0 and not ds.promoted)):
                    deployment_complete = False
        return deployment_complete

    # ------------------------------------------------------------- helpers
    def _filter_old_terminal(self, s: AllocSet) -> Tuple[AllocSet, AllocSet]:
        """Drop terminal allocs from previous job versions (batch only —
        service jobs account for them via name reuse)."""
        if not self.batch:
            return s, {}
        keep, ignore = {}, {}
        for k, a in s.items():
            older = a.job is not None and (
                a.job.version < self.job.version
                or a.job.create_index < self.job.create_index)
            if older and a.terminal_status():
                ignore[k] = a
            else:
                keep[k] = a
        return keep, ignore

    def _handle_group_canaries(self, all_allocs: AllocSet, du: DesiredUpdates
                               ) -> Tuple[AllocSet, AllocSet]:
        """Stop canaries from old/failed deployments; return the current
        deployment's live canaries."""
        stop_ids: List[str] = []
        if self.old_deployment is not None:
            for state in self.old_deployment.task_groups.values():
                if not state.promoted:
                    stop_ids.extend(state.placed_canaries)
        if (self.deployment is not None
                and self.deployment.status == DEPLOYMENT_STATUS_FAILED):
            for state in self.deployment.task_groups.values():
                if not state.promoted:
                    stop_ids.extend(state.placed_canaries)
        stop_set = rutil.from_keys(all_allocs, stop_ids)
        stop_set = rutil.filter_non_terminal(stop_set)
        self._mark_stop(stop_set, "", ALLOC_NOT_NEEDED)
        du.stop += len(stop_set)
        all_allocs = rutil.difference(all_allocs, stop_set)

        canaries: AllocSet = {}
        if self.deployment is not None:
            ids: List[str] = []
            for state in self.deployment.task_groups.values():
                ids.extend(state.placed_canaries)
            canaries = rutil.from_keys(all_allocs, ids)
            untainted, migrate, lost = rutil.filter_by_tainted(
                canaries, self.tainted_nodes)
            self._mark_stop(migrate, "", ALLOC_MIGRATING)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)
            canaries = untainted
            all_allocs = rutil.difference(all_allocs, migrate, lost)
        return canaries, all_allocs

    def _compute_stop(self, tg: TaskGroup, name_index: rutil.AllocNameIndex,
                      untainted: AllocSet, migrate: AllocSet, lost: AllocSet,
                      canaries: AllocSet, canary_state: bool) -> AllocSet:
        stop: AllocSet = dict(lost)
        self._mark_stop(lost, ALLOC_CLIENT_LOST, ALLOC_LOST)

        if canary_state:
            untainted = rutil.difference(untainted, canaries)

        remove = len(untainted) + len(migrate) - tg.count
        if remove <= 0:
            return stop

        # don't stop running allocs when terminal ones already satisfy count
        untainted = rutil.filter_non_terminal(untainted)

        # after promotion, prefer stopping the old allocs that share a
        # canary's name
        if not canary_state and canaries:
            cnames = rutil.name_set(canaries)
            for a in rutil.name_order(rutil.difference(untainted, canaries)):
                if a.name in cnames:
                    stop[a.id] = a
                    self.result.stop.append(AllocStopResult(
                        alloc=a, status_description=ALLOC_NOT_NEEDED))
                    del untainted[a.id]
                    remove -= 1
                    if remove == 0:
                        return stop

        # prefer stopping migrating allocs over running ones
        if migrate:
            mnames = rutil.AllocNameIndex(self.job_id, tg.name, tg.count,
                                          migrate)
            remove_names = mnames.highest(remove)
            for a in rutil.name_order(migrate):
                if a.name not in remove_names:
                    continue
                stop[a.id] = a
                self.result.stop.append(AllocStopResult(
                    alloc=a, status_description=ALLOC_NOT_NEEDED))
                del migrate[a.id]
                remove -= 1
                if remove == 0:
                    return stop

        # stop the highest name indexes
        remove_names = name_index.highest(remove)
        for a in rutil.name_order(untainted):
            if a.name in remove_names:
                stop[a.id] = a
                self.result.stop.append(AllocStopResult(
                    alloc=a, status_description=ALLOC_NOT_NEEDED))
                name_index.unset_index(a.index())
                del untainted[a.id]
                remove -= 1
                if remove == 0:
                    return stop

        # fallback: names didn't parse / duplicates — stop arbitrarily
        for a in rutil.name_order(untainted):
            stop[a.id] = a
            self.result.stop.append(AllocStopResult(
                alloc=a, status_description=ALLOC_NOT_NEEDED))
            name_index.unset_index(a.index())
            del untainted[a.id]
            remove -= 1
            if remove == 0:
                return stop
        return stop

    def _compute_updates(self, tg: TaskGroup, untainted: AllocSet
                         ) -> Tuple[AllocSet, AllocSet, AllocSet]:
        """Classify untainted allocs as (ignore, inplace, destructive)."""
        ignore: AllocSet = {}
        inplace: AllocSet = {}
        destructive: AllocSet = {}
        # classification is entirely the update fn's call (reference:
        # computeUpdates defers to allocUpdateFn; the same-version
        # short-circuit lives in util.go:846 genericAllocUpdateFn)
        for k, a in untainted.items():
            ig, destroy, updated = self.alloc_update_fn(a, self.job, tg)
            if ig:
                ignore[k] = a
            elif destroy:
                destructive[k] = a
            else:
                inplace[k] = a
                if updated is not None:
                    self.result.inplace_update.append(updated)
        return ignore, inplace, destructive

    def _compute_limit(self, tg: TaskGroup, untainted: AllocSet,
                       destructive: AllocSet, migrate: AllocSet,
                       canary_state: bool) -> int:
        if tg.update is None or len(destructive) + len(migrate) == 0:
            return tg.count
        if self.deployment_paused or self.deployment_failed:
            return 0
        if canary_state:
            return 0
        limit = tg.update.max_parallel
        if self.deployment is not None:
            part_of, _ = rutil.filter_by_deployment(untainted,
                                                    self.deployment.id)
            for a in part_of.values():
                if a.deployment_status is not None:
                    if a.deployment_status.is_unhealthy():
                        return 0
                    if not a.deployment_status.is_healthy():
                        limit -= 1
                else:
                    limit -= 1
        return max(0, limit)

    def _compute_placements(self, tg: TaskGroup,
                            name_index: rutil.AllocNameIndex,
                            untainted: AllocSet, migrate: AllocSet,
                            reschedule: AllocSet) -> List[AllocPlaceResult]:
        place: List[AllocPlaceResult] = []
        for a in rutil.name_order(reschedule):
            canary = (a.deployment_status is not None
                      and a.deployment_status.canary)
            place.append(AllocPlaceResult(
                name=a.name, task_group=tg, previous_alloc=a,
                reschedule=True, canary=canary))
        existing = len(untainted) + len(migrate) + len(reschedule)
        if existing < tg.count:
            for name in name_index.next(tg.count - existing):
                place.append(AllocPlaceResult(name=name, task_group=tg))
        return place

    def _handle_delayed_reschedules(
            self, resched_later: List[Tuple[Allocation, float]],
            all_allocs: AllocSet, group: str) -> None:
        """Batch delayed reschedules into follow-up evals: allocs whose
        eligible times fall within a 5 s window share one wait-until eval;
        each alloc is annotated with its follow-up eval id."""
        if not resched_later:
            return
        resched_later.sort(key=lambda t: t[1])
        evals: List[Evaluation] = []
        batches: List[List[Allocation]] = []
        batch_start = -math.inf
        for a, when in resched_later:
            if when - batch_start > BATCHED_FAILED_ALLOC_WINDOW_S:
                batch_start = when
                ev = Evaluation(
                    namespace=self.job.namespace, priority=self.job.priority,
                    type=self.job.type,
                    triggered_by=EVAL_TRIGGER_FAILED_FOLLOW_UP,
                    job_id=self.job.id, status=EVAL_STATUS_PENDING,
                    wait_until=when)
                evals.append(ev)
                batches.append([])
            batches[-1].append(a)
        self.result.desired_followup_evals.setdefault(group, []).extend(evals)
        for ev, members in zip(evals, batches):
            for a in members:
                updated = _shallow_copy_alloc(a)
                updated.follow_up_eval_id = ev.id
                self.result.attribute_updates[updated.id] = updated


def _shallow_copy_alloc(a: Allocation) -> Allocation:
    import copy
    return copy.copy(a)
