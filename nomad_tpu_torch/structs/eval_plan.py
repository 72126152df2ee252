"""Evaluation, Plan and Deployment: the units of scheduling work and output.

Reference: nomad/structs/structs.go `Evaluation` :8995, `Plan` :9288,
`PlanResult` :9462, `Deployment` :7734.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .alloc import Allocation
from .consts import (ALLOC_DESIRED_EVICT, ALLOC_DESIRED_STOP,
                     DEPLOYMENT_STATUS_PAUSED, DEPLOYMENT_STATUS_RUNNING,
                     EVAL_STATUS_BLOCKED, EVAL_STATUS_CANCELLED,
                     EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                     EVAL_STATUS_PENDING, EVAL_TRIGGER_FAILED_FOLLOW_UP,
                     EVAL_TRIGGER_QUEUED_ALLOCS, EVAL_TRIGGER_ROLLING_UPDATE)
from .job import Job
from ..utils.ids import generate_uuid


@dataclass
class Evaluation:
    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    priority: int = 50
    type: str = "service"            # scheduler type = job type
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until: float = 0.0          # unix time for delayed evals
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: Dict[str, object] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    annotate_plan: bool = False
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    leader_ack: str = ""             # broker token
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                               EVAL_STATUS_CANCELLED)

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job: Optional[Job]) -> "Plan":
        p = Plan(eval_id=self.id, priority=self.priority, job=job)
        if job is not None:
            p.all_at_once = job.all_at_once
        return p

    def next_rolling_eval(self, wait_s: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace, priority=self.priority, type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE, job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING, previous_eval=self.id,
            wait_until=_time.time() + wait_s)

    def create_blocked_eval(self, class_eligibility: Dict[str, bool],
                            escaped: bool, quota_reached: str) -> "Evaluation":
        """Reference: Evaluation.CreateBlockedEval."""
        return Evaluation(
            namespace=self.namespace, priority=self.priority, type=self.type,
            triggered_by=EVAL_TRIGGER_QUEUED_ALLOCS, job_id=self.job_id,
            job_modify_index=self.job_modify_index, status=EVAL_STATUS_BLOCKED,
            previous_eval=self.id, class_eligibility=dict(class_eligibility),
            escaped_computed_class=escaped, quota_limit_reached=quota_reached)

    def create_failed_follow_up_eval(self, wait_s: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace, priority=self.priority, type=self.type,
            triggered_by=EVAL_TRIGGER_FAILED_FOLLOW_UP, job_id=self.job_id,
            job_modify_index=self.job_modify_index, status=EVAL_STATUS_PENDING,
            wait_until=_time.time() + wait_s, previous_eval=self.id)


@dataclass
class DeploymentState:
    """Per-task-group deployment progress (reference: structs.DeploymentState)."""
    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: List[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 0.0
    require_progress_by: float = 0.0


@dataclass
class Deployment:
    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = "Deployment is running"
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        return any(s.desired_canaries > 0 and not s.promoted
                   for s in self.task_groups.values())

    def has_auto_promote(self) -> bool:
        states = [s for s in self.task_groups.values() if s.desired_canaries > 0]
        return bool(states) and all(s.auto_promote for s in states)

    def copy(self) -> "Deployment":
        d = Deployment(id=self.id, namespace=self.namespace, job_id=self.job_id,
                       job_version=self.job_version,
                       job_modify_index=self.job_modify_index,
                       job_spec_modify_index=self.job_spec_modify_index,
                       job_create_index=self.job_create_index,
                       status=self.status,
                       status_description=self.status_description,
                       create_index=self.create_index,
                       modify_index=self.modify_index)
        for k, s in self.task_groups.items():
            d.task_groups[k] = DeploymentState(
                auto_revert=s.auto_revert, auto_promote=s.auto_promote,
                promoted=s.promoted, placed_canaries=list(s.placed_canaries),
                desired_canaries=s.desired_canaries,
                desired_total=s.desired_total, placed_allocs=s.placed_allocs,
                healthy_allocs=s.healthy_allocs,
                unhealthy_allocs=s.unhealthy_allocs,
                progress_deadline_s=s.progress_deadline_s,
                require_progress_by=s.require_progress_by)
        return d


@dataclass
class DeploymentStatusUpdate:
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


@dataclass
class Plan:
    """The scheduler's proposed mutations (reference: structs.Plan :9288)."""
    eval_id: str = ""
    eval_token: str = ""
    priority: int = 50
    all_at_once: bool = False
    job: Optional[Job] = None
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    annotations: Optional[dict] = None
    snapshot_index: int = 0

    def append_stopped_alloc(self, alloc: Allocation, desc: str,
                             client_status: str = "") -> None:
        a = _shallow_alloc_copy(alloc)
        a.desired_status = ALLOC_DESIRED_STOP
        a.desired_description = desc
        if client_status:
            a.client_status = client_status
        a.job = None  # normalized: job known from plan
        self.node_update.setdefault(alloc.node_id, []).append(a)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation, preempting_id: str) -> None:
        a = _shallow_alloc_copy(alloc)
        a.desired_status = ALLOC_DESIRED_EVICT
        a.desired_description = f"Preempted by alloc ID {preempting_id}"
        a.preempted_by_allocation = preempting_id
        a.job = None
        self.node_preemptions.setdefault(alloc.node_id, []).append(a)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and self.deployment is None and not self.deployment_updates)

    def normalize_allocations(self) -> None:
        """Strip job snapshots from stopped/preempted allocs (wire size)."""
        for allocs in self.node_update.values():
            for a in allocs:
                a.job = None
        for allocs in self.node_preemptions.values():
            for a in allocs:
                a.job = None


@dataclass
class PlanResult:
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and self.deployment is None and not self.deployment_updates)

    def full_commit(self, plan: Plan):
        """Returns (fully_committed, n_expected, n_actual)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual


def _shallow_alloc_copy(alloc: Allocation) -> Allocation:
    import copy
    a = copy.copy(alloc)
    a.task_states = dict(alloc.task_states)
    return a
