"""Driver plugin interface (reference: plugins/drivers/driver.go:40-58).

The contract the client's task runner drives:
  fingerprint / start_task / wait_task / stop_task / destroy_task /
  recover_task / inspect_task / signal_task / exec_task.

TaskHandle is the serializable re-attach token (reference:
plugins/drivers/task_handle.go): persisted in the client state DB so a
restarted agent can RecoverTask instead of re-running the workload.

The counterpart of `nomad_tpu.plugins.drivers`.  The interactive exec
stream (`exec_task_streaming`, `ExecStream`) comes with the `exec`
driver (ROADMAP.md Queue 1 item 16b).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .base import BasePlugin, PluginInfo

TASK_STATE_RUNNING = "running"
TASK_STATE_EXITED = "exited"
TASK_STATE_UNKNOWN = "unknown"

HEALTH_UNDETECTED = "undetected"
HEALTH_HEALTHY = "healthy"


@dataclass
class DriverCapabilities:
    """reference: drivers.Capabilities."""
    send_signals: bool = True
    exec: bool = False
    fs_isolation: str = "none"       # none|chroot|image


@dataclass
class DriverFingerprint:
    """reference: drivers.Fingerprint (plugins/drivers/driver.go:214)."""
    attributes: Dict[str, str] = field(default_factory=dict)
    health: str = HEALTH_HEALTHY
    health_description: str = ""


@dataclass
class TaskConfig:
    """What the task runner hands the driver (reference: drivers.TaskConfig).

    `id` is the driver-scoped task id (alloc id + task name), `config` the
    task's jobspec driver config block, and the dir/log paths come from the
    allocdir layout so the driver never invents paths.
    """
    id: str = ""
    name: str = ""
    alloc_id: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    user: str = ""
    cpu_mhz: int = 0
    memory_mb: int = 0
    task_dir: str = ""
    alloc_dir: str = ""
    stdout_path: str = ""
    stderr_path: str = ""
    # size-rotated logging (reference: LogConfig -> logmon rotation);
    # 0 disables rotation
    log_max_files: int = 10
    log_max_file_size_mb: int = 10


@dataclass
class TaskHandle:
    """Serializable re-attach token (reference: task_handle.go)."""
    driver: str = ""
    task_id: str = ""
    version: int = 1
    config: Optional[TaskConfig] = None
    state: str = TASK_STATE_RUNNING
    driver_state: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExitResult:
    """reference: drivers.ExitResult."""
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: str = ""

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


@dataclass
class TaskStatus:
    """reference: drivers.TaskStatus."""
    id: str = ""
    name: str = ""
    state: str = TASK_STATE_UNKNOWN
    started_at: float = 0.0
    completed_at: float = 0.0
    exit_result: Optional[ExitResult] = None
    driver_attributes: Dict[str, str] = field(default_factory=dict)


class DriverError(Exception):
    pass


class TaskNotFoundError(DriverError):
    pass


class DriverPlugin(BasePlugin):
    """The driver contract (reference: plugins/drivers/driver.go:40-58)."""

    name = "?"
    capabilities = DriverCapabilities()

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type="driver")

    def fingerprint(self) -> DriverFingerprint:
        raise NotImplementedError

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        raise NotImplementedError

    def wait_task(self, task_id: str,
                  timeout: Optional[float] = None) -> Optional[ExitResult]:
        """Block until the task exits; None on timeout."""
        raise NotImplementedError

    def stop_task(self, task_id: str, timeout_s: float,
                  signal: str = "") -> None:
        raise NotImplementedError

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        raise NotImplementedError

    def recover_task(self, handle: TaskHandle) -> None:
        """Re-attach to a task from a persisted handle; raises
        TaskNotFoundError if it cannot be recovered."""
        raise NotImplementedError

    def inspect_task(self, task_id: str) -> TaskStatus:
        raise NotImplementedError

    def signal_task(self, task_id: str, signal: str) -> None:
        raise DriverError(f"driver {self.name} does not support signals")

    def exec_task(self, task_id: str, cmd: List[str],
                  timeout_s: float = 30.0) -> Tuple[bytes, int]:
        raise DriverError(f"driver {self.name} does not support exec")


class DriverRegistry:
    """Builtin driver catalog (reference:
    helper/pluginutils/catalog/register.go:15-19 + the client's
    pluginmanager/drivermanager). Owns one plugin instance per driver
    name and aggregates their fingerprints for the node."""

    def __init__(self):
        self._drivers: Dict[str, DriverPlugin] = {}
        self._lock = threading.Lock()

    def register(self, driver: DriverPlugin) -> None:
        with self._lock:
            self._drivers[driver.name] = driver

    def get(self, name: str) -> Optional[DriverPlugin]:
        with self._lock:
            return self._drivers.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._drivers)

    def fingerprints(self) -> Dict[str, DriverFingerprint]:
        with self._lock:
            drivers = dict(self._drivers)
        out = {}
        for name, drv in drivers.items():
            try:
                out[name] = drv.fingerprint()
            except Exception as e:
                out[name] = DriverFingerprint(
                    health="unhealthy", health_description=str(e))
        return out


def default_registry() -> DriverRegistry:
    """Registry with the builtin drivers registered."""
    from ..drivers import register_builtins
    reg = DriverRegistry()
    register_builtins(reg)
    return reg
