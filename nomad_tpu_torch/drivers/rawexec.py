"""raw_exec driver: real subprocesses with no isolation
(reference: drivers/rawexec/driver.go, task config `command` + `args`).

Each task runs under a detached executor process
(nomad_tpu_torch/drivers/executor.py) so the workload survives agent
restarts; RecoverTask re-attaches from the persisted TaskHandle by
verifying {pid, start_ticks} and resuming the exit-file watch.

The counterpart of `nomad_tpu.drivers.rawexec`; it starts this package's
executor (`EXECUTOR_MODULE`).  Exec in a task's context (`exec_task`,
the interactive stream) and the hooks through which the reference's
`exec` driver jails a task (`_task_env`, `_isolation_spec`, `_exec_jail`)
come with alloc exec and that driver (ROADMAP.md Queue 1 item 16b).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from ..plugins.drivers import (TASK_STATE_EXITED, TASK_STATE_RUNNING,
                               DriverCapabilities, DriverError,
                               DriverFingerprint, DriverPlugin, ExitResult,
                               TaskConfig, TaskHandle, TaskNotFoundError,
                               TaskStatus)
from .executor import pid_alive

_START_TIMEOUT_S = 10.0
#: the per-task executor each task runs under (`python -m` this module)
EXECUTOR_MODULE = "nomad_tpu_torch.drivers.executor"


def _signum(name: str, default: int = signal.SIGTERM) -> int:
    if not name:
        return default
    name = name.upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    try:
        return int(getattr(signal, name))
    except AttributeError:
        raise DriverError(f"unknown signal {name!r}")


class _Task:
    def __init__(self, handle: TaskHandle,
                 popen: Optional[subprocess.Popen] = None):
        self.handle = handle
        self.popen = popen            # executor process, when we spawned it
        self.exit_result: Optional[ExitResult] = None
        self.completed_at = 0.0
        self.lock = threading.Lock()


class RawExecDriver(DriverPlugin):
    name = "raw_exec"
    # no exec in the task's context until alloc exec is ported
    capabilities = DriverCapabilities(send_signals=True, exec=False,
                                      fs_isolation="none")

    #: jobspec task-config keys (reference: rawexec taskConfigSpec)
    task_config_keys = ("command", "args")

    def __init__(self):
        self._tasks: Dict[str, _Task] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------- fingerprint
    def fingerprint(self) -> DriverFingerprint:
        return DriverFingerprint(attributes={
            f"driver.{self.name}": "1",
            f"driver.{self.name}.version": "0.1.0",
        })

    # -------------------------------------------------------------- start
    def _validate(self, cfg: TaskConfig) -> Tuple[str, List[str]]:
        conf = cfg.config or {}
        for key in conf:
            if key not in self.task_config_keys:
                raise DriverError(
                    f"raw_exec: unknown task config key {key!r}")
        command = conf.get("command")
        if not command or not isinstance(command, str):
            raise DriverError("raw_exec: task config requires 'command'")
        args = conf.get("args") or []
        if not isinstance(args, list):
            raise DriverError("raw_exec: 'args' must be a list")
        return command, [str(a) for a in args]

    def _paths(self, cfg: TaskConfig) -> Dict[str, str]:
        base = os.path.join(cfg.task_dir, ".executor")
        os.makedirs(base, exist_ok=True)
        return {
            "spec": os.path.join(base, "spec.json"),
            "state": os.path.join(base, "state.json"),
            "exit": os.path.join(base, "exit.json"),
            "log": os.path.join(base, "executor.log"),
        }

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        with self._lock:
            if cfg.id in self._tasks:
                raise DriverError(f"task {cfg.id} already started")
        command, args = self._validate(cfg)
        paths = self._paths(cfg)
        for stale in (paths["state"], paths["exit"]):
            if os.path.exists(stale):
                os.unlink(stale)
        spec = {
            "argv": [command] + args,
            "env": dict(cfg.env),
            "cwd": cfg.task_dir,
            "stdout_path": cfg.stdout_path,
            "stderr_path": cfg.stderr_path,
            "log_max_bytes": cfg.log_max_file_size_mb * 1024 * 1024,
            "log_max_files": cfg.log_max_files,
            "state_file": paths["state"],
            "exit_file": paths["exit"],
        }
        with open(paths["spec"], "w") as f:
            json.dump(spec, f)
        with open(paths["log"], "ab") as elog:
            popen = subprocess.Popen(
                [sys.executable, "-m", EXECUTOR_MODULE, paths["spec"]],
                stdout=elog, stderr=elog, stdin=subprocess.DEVNULL,
                start_new_session=True,      # survives this agent's death
                cwd="/",
                # absolutize: the executor runs with cwd=/ — relative
                # sys.path entries (script dirs, '') would dangle
                env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                     "PYTHONPATH": os.pathsep.join(
                         os.path.abspath(p) for p in sys.path)},
            )
        state = self._await_state(paths, popen)
        handle = TaskHandle(
            driver=self.name, task_id=cfg.id, config=cfg,
            state=TASK_STATE_RUNNING,
            driver_state={
                "pid": state["pid"],
                "start_ticks": state["start_ticks"],
                "executor_pid": state["executor_pid"],
                "started_at": state["started_at"],
                "state_file": paths["state"],
                "exit_file": paths["exit"],
            })
        with self._lock:
            self._tasks[cfg.id] = _Task(handle, popen)
        return handle

    def _await_state(self, paths: Dict[str, str],
                     popen: subprocess.Popen) -> Dict[str, Any]:
        deadline = _time.monotonic() + _START_TIMEOUT_S
        while _time.monotonic() < deadline:
            # the exit record is looked at before the state file: the
            # executor writes its state file before the task can exit, so
            # a task that starts and exits between the two looks leaves
            # both, and only an exit record with no state file is a
            # failed start (the reference looks the other way round and
            # fails such a task)
            exited = os.path.exists(paths["exit"])
            if os.path.exists(paths["state"]):
                try:
                    with open(paths["state"]) as f:
                        return json.load(f)
                except (OSError, json.JSONDecodeError):
                    pass               # mid-write; retry
            elif exited:
                # spawn failed: the executor wrote the error exit record
                with open(paths["exit"]) as f:
                    rec = json.load(f)
                raise DriverError(
                    f"raw_exec: failed to start task: "
                    f"{rec.get('err') or rec}")
            if popen.poll() is not None and not os.path.exists(paths["exit"]):
                tail = ""
                try:
                    with open(paths["log"]) as f:
                        tail = f.read()[-500:]
                except OSError:
                    pass
                raise DriverError(f"raw_exec: executor died at startup: "
                                  f"{tail}")
            _time.sleep(0.01)
        raise DriverError("raw_exec: timed out waiting for executor")

    # --------------------------------------------------------------- wait
    def _get(self, task_id: str) -> _Task:
        with self._lock:
            t = self._tasks.get(task_id)
        if t is None:
            raise TaskNotFoundError(f"task {task_id} not found")
        return t

    def wait_task(self, task_id: str,
                  timeout: Optional[float] = None) -> Optional[ExitResult]:
        t = self._get(task_id)
        deadline = None if timeout is None else _time.monotonic() + timeout
        ds = t.handle.driver_state
        while True:
            with t.lock:
                if t.exit_result is not None:
                    return t.exit_result
            result = self._poll_exit(t)
            if result is not None:
                return result
            if deadline is not None and _time.monotonic() >= deadline:
                return None
            _time.sleep(0.02)

    def _poll_exit(self, t: _Task) -> Optional[ExitResult]:
        ds = t.handle.driver_state
        if t.popen is not None:
            t.popen.poll()              # reap the executor if it finished
        if os.path.exists(ds["exit_file"]):
            try:
                with open(ds["exit_file"]) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                return None            # mid-write
            result = ExitResult(exit_code=int(rec.get("exit_code", 0)),
                                signal=int(rec.get("signal", 0)),
                                err=rec.get("err", ""))
            with t.lock:
                t.exit_result = result
                t.completed_at = float(rec.get("finished_at", _time.time()))
                t.handle.state = TASK_STATE_EXITED
            return result
        if (not pid_alive(ds["pid"], ds.get("start_ticks", 0))
                and not pid_alive(ds.get("executor_pid", 0))):
            # both task and its supervisor vanished without an exit record
            result = ExitResult(exit_code=-1,
                                err="task lost: executor died")
            with t.lock:
                t.exit_result = result
                t.completed_at = _time.time()
                t.handle.state = TASK_STATE_EXITED
            return result
        return None

    # --------------------------------------------------------------- stop
    def stop_task(self, task_id: str, timeout_s: float,
                  signal_name: str = "") -> None:
        t = self._get(task_id)
        ds = t.handle.driver_state
        sig = _signum(signal_name)
        self._kill_group(ds["pid"], sig)
        if self.wait_task(task_id, timeout=max(timeout_s, 0.0)) is None:
            self._kill_group(ds["pid"], signal.SIGKILL)
            self.wait_task(task_id, timeout=5.0)

    @staticmethod
    def _kill_group(pid: int, sig: int) -> None:
        try:
            os.killpg(pid, sig)        # executor starts the task setsid
        except ProcessLookupError:
            pass
        except PermissionError:
            try:
                os.kill(pid, sig)
            except OSError:
                pass

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        t = self._get(task_id)
        with t.lock:
            running = t.exit_result is None
        if running:
            if not force:
                raise DriverError(f"task {task_id} still running")
            self.stop_task(task_id, timeout_s=1.0)
        with self._lock:
            self._tasks.pop(task_id, None)

    # ------------------------------------------------------------ recover
    def recover_task(self, handle: TaskHandle) -> None:
        ds = handle.driver_state or {}
        if not ds.get("pid") or not ds.get("exit_file"):
            raise TaskNotFoundError("handle has no executor state")
        with self._lock:
            if handle.task_id in self._tasks:
                return
            self._tasks[handle.task_id] = _Task(handle, popen=None)
        t = self._get(handle.task_id)
        # settle the state immediately: exited (exit file), running
        # (pid+ticks match), or lost
        self._poll_exit(t)

    # ------------------------------------------------------------ inspect
    def inspect_task(self, task_id: str) -> TaskStatus:
        t = self._get(task_id)
        ds = t.handle.driver_state
        with t.lock:
            result = t.exit_result
            completed = t.completed_at
        return TaskStatus(
            id=task_id,
            name=t.handle.config.name if t.handle.config else "",
            state=TASK_STATE_EXITED if result else TASK_STATE_RUNNING,
            started_at=ds.get("started_at", 0.0),
            completed_at=completed,
            exit_result=result,
            driver_attributes={"pid": str(ds.get("pid", ""))})

    def signal_task(self, task_id: str, signal_name: str) -> None:
        t = self._get(task_id)
        self._kill_group(t.handle.driver_state["pid"], _signum(signal_name))
