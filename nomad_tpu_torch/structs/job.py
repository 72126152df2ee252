"""Job / TaskGroup / Task: the declarative workload spec.

Reference: nomad/structs/structs.go `Job` :3524, `TaskGroup` :5149,
`Task` :5781, `Constraint` :7237, `Affinity` :7359, `Spread` :7447.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .consts import (DEFAULT_NAMESPACE, DEFAULT_REGION, JOB_DEFAULT_PRIORITY,
                     JOB_STATUS_PENDING, JOB_TYPE_BATCH, JOB_TYPE_SERVICE,
                     JOB_TYPE_SYSTEM, RESCHEDULE_DELAY_EXPONENTIAL,
                     RESTART_POLICY_FAIL)
from .resources import NetworkResource, Resources


@dataclass
class Constraint:
    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="

    def key(self):
        return (self.ltarget, self.rtarget, self.operand)

    def __str__(self):
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass
class Affinity:
    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="
    weight: float = 50.0  # in [-100, 100]


@dataclass
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass
class Spread:
    attribute: str = ""
    weight: float = 50.0
    spread_targets: List[SpreadTarget] = field(default_factory=list)


@dataclass
class RestartPolicy:
    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = RESTART_POLICY_FAIL


@dataclass
class ReschedulePolicy:
    """Reference: structs.ReschedulePolicy; defaults per job type."""
    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = RESCHEDULE_DELAY_EXPONENTIAL
    max_delay_s: float = 3600.0
    unlimited: bool = True

    @staticmethod
    def default_service() -> "ReschedulePolicy":
        return ReschedulePolicy(attempts=0, interval_s=0, delay_s=30,
                                delay_function=RESCHEDULE_DELAY_EXPONENTIAL,
                                max_delay_s=3600, unlimited=True)

    @staticmethod
    def default_batch() -> "ReschedulePolicy":
        return ReschedulePolicy(attempts=1, interval_s=24 * 3600, delay_s=5,
                                delay_function="constant", max_delay_s=0,
                                unlimited=False)


@dataclass
class UpdateStrategy:
    """Rolling-update / canary config (reference: structs.UpdateStrategy)."""
    stagger_s: float = 30.0
    max_parallel: int = 0
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def rolling(self) -> bool:
        return self.max_parallel > 0


@dataclass
class MigrateStrategy:
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class PeriodicConfig:
    enabled: bool = True
    spec: str = ""            # cron expression
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    timezone: str = "UTC"


@dataclass
class ParameterizedJobConfig:
    payload: str = "optional"  # optional|required|forbidden
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)


def _path_escapes_sandbox(rel: str) -> bool:
    """True when a user-supplied relative path climbs out of its sandbox
    dir (reference: helper/funcs.go PathEscapesAllocDir — normalize then
    check for a leading '..')."""
    import posixpath
    norm = posixpath.normpath("/" + rel.lstrip("/"))
    # After anchoring at '/', normpath collapses every '..'; a path that
    # still tries to climb shows up as a difference vs the raw join.
    raw = posixpath.normpath(posixpath.join("/sandbox", rel.lstrip("/")))
    return not (raw == "/sandbox" or raw.startswith("/sandbox/")) or norm == "/"


@dataclass
class DispatchPayloadConfig:
    file: str = ""


@dataclass
class ServiceCheck:
    name: str = ""
    type: str = ""            # http|tcp|script|grpc
    path: str = ""
    command: str = ""
    args: List[str] = field(default_factory=list)
    interval_s: float = 10.0
    timeout_s: float = 2.0
    port_label: str = ""


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    tags: List[str] = field(default_factory=list)
    canary_tags: List[str] = field(default_factory=list)
    checks: List[ServiceCheck] = field(default_factory=list)
    address_mode: str = "auto"


@dataclass
class VolumeRequest:
    name: str = ""
    type: str = "host"        # host|csi
    source: str = ""
    read_only: bool = False


@dataclass
class VolumeMount:
    volume: str = ""
    destination: str = ""
    read_only: bool = False


@dataclass
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class Template:
    source_path: str = ""
    dest_path: str = ""
    embedded_tmpl: str = ""
    change_mode: str = "restart"
    change_signal: str = ""


@dataclass
class Artifact:
    getter_source: str = ""
    getter_options: Dict[str, str] = field(default_factory=dict)
    relative_dest: str = ""


@dataclass
class Task:
    name: str = ""
    driver: str = ""
    user: str = ""
    config: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    services: List[Service] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)
    kill_timeout_s: float = 5.0
    kill_signal: str = ""
    leader: bool = False
    shutdown_delay_s: float = 0.0
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    templates: List[Template] = field(default_factory=list)
    artifacts: List[Artifact] = field(default_factory=list)
    dispatch_payload: Optional[DispatchPayloadConfig] = None
    log_config: LogConfig = field(default_factory=LogConfig)
    lifecycle: Optional[dict] = None


@dataclass
class TaskGroup:
    name: str = ""
    count: int = 1
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    tasks: List[Task] = field(default_factory=list)
    networks: List[NetworkResource] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    stop_after_client_disconnect_s: Optional[float] = None
    meta: Dict[str, str] = field(default_factory=dict)

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None


@dataclass
class Job:
    id: str = ""
    name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    region: str = DEFAULT_REGION
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    payload: bytes = b""
    meta: Dict[str, str] = field(default_factory=dict)
    vault_token: str = ""
    status: str = JOB_STATUS_PENDING
    status_description: str = ""
    stable: bool = False
    version: int = 0
    stop: bool = False
    parent_id: str = ""
    dispatched: bool = False
    submit_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    # -- helpers used throughout scheduling --
    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None

    def is_parameterized(self) -> bool:
        return self.parameterized is not None and not self.dispatched

    def is_system(self) -> bool:
        return self.type == JOB_TYPE_SYSTEM

    def is_service(self) -> bool:
        return self.type == JOB_TYPE_SERVICE

    def is_batch(self) -> bool:
        return self.type == JOB_TYPE_BATCH

    def has_update_strategy(self) -> bool:
        return any(tg.update is not None and tg.update.rolling()
                   for tg in self.task_groups)

    def canonicalize(self) -> None:
        """Fill defaults (reference: Job.Canonicalize)."""
        if not self.name:
            self.name = self.id
        if not self.namespace:
            self.namespace = DEFAULT_NAMESPACE
        for tg in self.task_groups:
            if tg.count == 0 and self.type != JOB_TYPE_SYSTEM:
                tg.count = 1
            if tg.reschedule_policy is None:
                if self.type == JOB_TYPE_SERVICE:
                    tg.reschedule_policy = ReschedulePolicy.default_service()
                elif self.type == JOB_TYPE_BATCH:
                    tg.reschedule_policy = ReschedulePolicy.default_batch()
            if tg.update is None and self.update is not None:
                tg.update = self.update

    def validate(self) -> List[str]:
        """Minimal structural validation (reference: Job.Validate)."""
        errs = []
        if not self.id:
            errs.append("missing job ID")
        if " " in self.id:
            errs.append("job ID contains a space")
        if not self.task_groups:
            errs.append("missing job task groups")
        if not self.datacenters:
            errs.append("missing job datacenters")
        if self.type not in (JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM):
            errs.append(f"invalid job type: {self.type}")
        seen = set()
        for tg in self.task_groups:
            if tg.name in seen:
                errs.append(f"duplicate task group {tg.name}")
            seen.add(tg.name)
            if not tg.tasks:
                errs.append(f"task group {tg.name} has no tasks")
            if self.type == JOB_TYPE_SYSTEM and tg.reschedule_policy is not None:
                errs.append("system jobs do not support reschedule policy")
            tseen = set()
            for t in tg.tasks:
                if t.name in tseen:
                    errs.append(f"duplicate task {t.name} in group {tg.name}")
                tseen.add(t.name)
                if not t.driver:
                    errs.append(f"task {t.name} missing driver")
                dp = getattr(t, "dispatch_payload", None)
                if dp and dp.file and _path_escapes_sandbox(dp.file):
                    errs.append(
                        f"task {t.name} dispatch_payload file "
                        f"{dp.file!r} escapes the task directory")
        if self.type == JOB_TYPE_SYSTEM:
            if self.affinities:
                errs.append("system jobs may not have an affinity stanza")
            if self.spreads:
                errs.append("system jobs may not have a spread stanza")
        return errs

    def required_signals(self) -> Dict[str, Dict[str, List[str]]]:
        return {}

    def combined_task_meta(self, tg_name: str, task_name: str) -> Dict[str, str]:
        out = dict(self.meta)
        tg = self.lookup_task_group(tg_name)
        if tg:
            out.update(tg.meta)
            t = tg.lookup_task(task_name)
            if t:
                out.update(t.meta)
        return out
