"""Allocation: the unit of placed work, plus its scheduling metadata.

Reference: nomad/structs/structs.go `Allocation` :8071, `AllocMetric` :8672,
RescheduleTracker / RescheduleEvent, DesiredTransition.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .consts import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                     ALLOC_CLIENT_LOST, ALLOC_CLIENT_PENDING,
                     ALLOC_DESIRED_EVICT, ALLOC_DESIRED_STOP,
                     RESCHEDULE_DELAY_EXPONENTIAL, RESCHEDULE_DELAY_FIBONACCI,
                     TASK_STATE_DEAD)
from .job import Job, ReschedulePolicy
from .resources import AllocatedResources, ComparableResources


@dataclass
class TaskEvent:
    type: str = ""
    time: float = 0.0
    message: str = ""
    details: Dict[str, str] = field(default_factory=dict)
    exit_code: int = 0
    signal: int = 0
    restart_reason: str = ""
    failure: bool = False


@dataclass
class TaskState:
    state: str = "pending"
    failed: bool = False
    restarts: int = 0
    last_restart: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    events: List[TaskEvent] = field(default_factory=list)
    # "<service>/<check>" -> passing (client-side check runner results;
    # reference: consul check status consumed by the service catalog)
    checks: Dict[str, bool] = field(default_factory=dict)

    def successful(self) -> bool:
        return self.state == TASK_STATE_DEAD and not self.failed


@dataclass
class RescheduleEvent:
    reschedule_time: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_s: float = 0.0


@dataclass
class RescheduleTracker:
    events: List[RescheduleEvent] = field(default_factory=list)

    def copy(self) -> "RescheduleTracker":
        return RescheduleTracker(events=list(self.events))


@dataclass
class DesiredTransition:
    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp: float = 0.0
    canary: bool = False
    modify_index: int = 0

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass
class AllocMetric:
    """Per-placement explainability (reference: structs.go:8672).

    The TPU solver populates this from its mask/score tensors so `alloc status`
    output matches the reference's debugging surface.
    """
    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)   # per-dc
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    quota_exhausted: List[str] = field(default_factory=list)
    scores: Dict[str, float] = field(default_factory=dict)          # legacy
    score_meta: List[dict] = field(default_factory=list)            # top-K
    allocation_time_ns: int = 0
    coalesced_failures: int = 0

    def exhausted_node(self, node_id: str, node_class: str, dimension: str):
        self.nodes_exhausted += 1
        if node_class:
            self.class_exhausted[node_class] = self.class_exhausted.get(node_class, 0) + 1
        if dimension:
            self.dimension_exhausted[dimension] = self.dimension_exhausted.get(dimension, 0) + 1

    def filter_node(self, node_class: str, constraint: str):
        self.nodes_filtered += 1
        if node_class:
            self.class_filtered[node_class] = self.class_filtered.get(node_class, 0) + 1
        if constraint:
            self.constraint_filtered[constraint] = self.constraint_filtered.get(constraint, 0) + 1

    def copy(self) -> "AllocMetric":
        return AllocMetric(
            nodes_evaluated=self.nodes_evaluated,
            nodes_filtered=self.nodes_filtered,
            nodes_available=dict(self.nodes_available),
            class_filtered=dict(self.class_filtered),
            constraint_filtered=dict(self.constraint_filtered),
            nodes_exhausted=self.nodes_exhausted,
            class_exhausted=dict(self.class_exhausted),
            dimension_exhausted=dict(self.dimension_exhausted),
            quota_exhausted=list(self.quota_exhausted),
            scores=dict(self.scores),
            score_meta=[dict(m) for m in self.score_meta],
            allocation_time_ns=self.allocation_time_ns,
            coalesced_failures=self.coalesced_failures,
        )


@dataclass
class Allocation:
    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""                 # "<job>.<group>[<index>]"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None      # job snapshot at placement time
    task_group: str = ""
    allocated_resources: AllocatedResources = field(default_factory=AllocatedResources)
    metrics: AllocMetric = field(default_factory=AllocMetric)
    desired_status: str = "run"
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_PENDING
    client_description: str = ""
    task_states: Dict[str, TaskState] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[AllocDeploymentStatus] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    previous_allocation: str = ""
    next_allocation: str = ""
    follow_up_eval_id: str = ""
    preempted_by_allocation: str = ""
    preempted_allocations: List[str] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0

    # -- status predicates (reference: Allocation.TerminalStatus etc.) --
    def terminal_status(self) -> bool:
        """Desired or actual status implies no more resource usage."""
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return True
        return self.client_terminal_status()

    def client_terminal_status(self) -> bool:
        return self.client_status in (ALLOC_CLIENT_COMPLETE,
                                      ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST)

    def server_terminal_status(self) -> bool:
        return self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)

    def ran_successfully(self) -> bool:
        if not self.task_states:
            return False
        return all(ts.successful() for ts in self.task_states.values())

    def comparable_resources(self) -> ComparableResources:
        return self.allocated_resources.comparable()

    def index(self) -> int:
        """Parse the name index: "job.group[3]" -> 3."""
        l = self.name.rfind("[")
        r = self.name.rfind("]")
        if l < 0 or r < 0 or r <= l:
            return -1
        try:
            return int(self.name[l + 1:r])
        except ValueError:
            return -1

    def job_namespaced_id(self):
        return (self.namespace, self.job_id)

    # -- rescheduling (reference: Allocation.ShouldReschedule / NextRescheduleTime) --
    def should_reschedule(self, policy: Optional[ReschedulePolicy],
                          fail_time: float) -> bool:
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return False
        if self.client_status != ALLOC_CLIENT_FAILED:
            return False
        return self.reschedule_eligible(policy, fail_time)

    def reschedule_eligible(self, policy: Optional[ReschedulePolicy],
                            fail_time: float) -> bool:
        """Reference: Allocation.RescheduleEligible."""
        if policy is None:
            return False
        if not (policy.attempts > 0 or policy.unlimited):
            return False
        if policy.unlimited:
            return True
        attempted = self.reschedule_attempts_in_interval(policy, fail_time)
        return attempted < policy.attempts

    def reschedule_attempts_in_interval(self, policy: ReschedulePolicy,
                                        fail_time: float) -> int:
        if not self.reschedule_tracker:
            return 0
        window = fail_time - policy.interval_s
        return sum(1 for ev in self.reschedule_tracker.events
                   if ev.reschedule_time > window)

    def next_delay(self, policy: ReschedulePolicy) -> float:
        """Compute the reschedule delay from the recorded event history
        (reference: Allocation.NextDelay — exponential doubles the last
        recorded delay; fibonacci sums the last two, with a ceiling reset
        once two consecutive events sat at max_delay; hitting the clamp
        after a quiet period longer than the delay resets to base)."""
        base = policy.delay_s
        events = self.reschedule_tracker.events if self.reschedule_tracker else []
        if not events:
            return base
        fn = policy.delay_function
        if fn == RESCHEDULE_DELAY_EXPONENTIAL:
            delay = events[-1].delay_s * 2
        elif fn == RESCHEDULE_DELAY_FIBONACCI:
            if len(events) >= 2:
                d1, d2 = events[-1].delay_s, events[-2].delay_s
                # ceiling reset: series restarted at base after hitting max
                if d2 == policy.max_delay_s and d1 == policy.delay_s:
                    delay = d1
                else:
                    delay = d1 + d2
            else:
                delay = base
        else:
            return base
        if policy.max_delay_s > 0 and delay > policy.max_delay_s:
            delay = policy.max_delay_s
            if self.last_event_time() - events[-1].reschedule_time > delay:
                delay = policy.delay_s
        return delay

    def next_reschedule_time(self, policy: Optional[ReschedulePolicy]):
        """Returns (eligible_time, eligible) for a delayed reschedule
        (reference: Allocation.NextRescheduleTime)."""
        if (policy is None
                or self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)
                or self.client_status != ALLOC_CLIENT_FAILED):
            return 0.0, False
        fail_time = self.last_event_time()
        if fail_time <= 0:
            return 0.0, False
        next_delay = self.next_delay(policy)
        eligible = policy.unlimited or (policy.attempts > 0
                                        and self.reschedule_tracker is None)
        if (policy.attempts > 0 and self.reschedule_tracker
                and self.reschedule_tracker.events):
            attempted = self.reschedule_attempts_in_interval(policy, fail_time)
            eligible = (attempted < policy.attempts
                        and next_delay < policy.interval_s)
        return fail_time + next_delay, eligible

    def last_event_time(self) -> float:
        last = 0.0
        for ts in self.task_states.values():
            if ts.finished_at > last:
                last = ts.finished_at
        return last or self.modify_time

    def migrate_disk(self) -> bool:
        if self.job is None:
            return False
        tg = self.job.lookup_task_group(self.task_group)
        return bool(tg and tg.ephemeral_disk.migrate)

    def stub(self) -> dict:
        return {
            "ID": self.id, "EvalID": self.eval_id, "Name": self.name,
            "NodeID": self.node_id, "JobID": self.job_id,
            "TaskGroup": self.task_group,
            "DesiredStatus": self.desired_status,
            "ClientStatus": self.client_status,
            "DeploymentID": self.deployment_id,
            "FollowupEvalID": self.follow_up_eval_id,
            "CreateIndex": self.create_index, "ModifyIndex": self.modify_index,
        }


def alloc_name(job_id: str, group: str, idx: int) -> str:
    return f"{job_id}.{group}[{idx}]"
