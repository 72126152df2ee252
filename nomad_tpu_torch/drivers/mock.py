"""Scriptable mock driver for tests (reference: drivers/mock).

Task config drives the lifecycle:
  start_error      -> start_task raises DriverError(msg)
  run_for          -> seconds to run before exiting (absent = run forever)
  exit_code        -> exit code when run_for elapses (default 0)
  exit_signal      -> signal number instead of exit code
  exit_err_msg     -> driver-level error on exit

Mock tasks are in-memory threads: they do NOT survive the driver
instance, so recover_task raises TaskNotFoundError — exactly the
"workload lost on restart" path the task runner must handle.

The counterpart of `nomad_tpu.drivers.mock`.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Dict, Optional

from ..plugins.drivers import (TASK_STATE_EXITED, TASK_STATE_RUNNING,
                               DriverCapabilities, DriverError,
                               DriverFingerprint, DriverPlugin, ExitResult,
                               TaskConfig, TaskHandle, TaskNotFoundError,
                               TaskStatus)


class _MockTask:
    def __init__(self, cfg: TaskConfig):
        self.cfg = cfg
        self.started_at = _time.time()
        self.completed_at = 0.0
        self.exit_result: Optional[ExitResult] = None
        self.done = threading.Event()
        self.stop = threading.Event()

    def run(self):
        conf = self.cfg.config or {}
        run_for = conf.get("run_for")
        if run_for is None:
            self.stop.wait()
            result = ExitResult()
        else:
            try:
                wait_s = float(run_for)          # unitless = seconds
            except (TypeError, ValueError):
                from ..jobspec.parse import parse_duration_s
                try:
                    wait_s = parse_duration_s(run_for)
                except Exception:
                    # a bad duration fails the task, never wedges it
                    self.exit_result = ExitResult(
                        exit_code=1, err=f"bad run_for: {run_for!r}")
                    self.completed_at = _time.time()
                    self.done.set()
                    return
            finished = self.stop.wait(wait_s)
            if finished:
                result = ExitResult()
            else:
                result = ExitResult(exit_code=int(conf.get("exit_code", 0)),
                                    signal=int(conf.get("exit_signal", 0)),
                                    err=str(conf.get("exit_err_msg", "")))
        self.exit_result = result
        self.completed_at = _time.time()
        self.done.set()


class MockDriver(DriverPlugin):
    name = "mock_driver"
    capabilities = DriverCapabilities(send_signals=True)

    def __init__(self):
        self._tasks: Dict[str, _MockTask] = {}
        self._lock = threading.Lock()

    def fingerprint(self) -> DriverFingerprint:
        return DriverFingerprint(attributes={f"driver.{self.name}": "1"})

    def start_task(self, cfg: TaskConfig) -> TaskHandle:
        conf = cfg.config or {}
        if conf.get("start_error"):
            raise DriverError(str(conf["start_error"]))
        task = _MockTask(cfg)
        with self._lock:
            if cfg.id in self._tasks:
                raise DriverError(f"task {cfg.id} already started")
            self._tasks[cfg.id] = task
        threading.Thread(target=task.run, daemon=True).start()
        return TaskHandle(driver=self.name, task_id=cfg.id, config=cfg,
                          state=TASK_STATE_RUNNING,
                          driver_state={"started_at": task.started_at})

    def _get(self, task_id: str) -> _MockTask:
        with self._lock:
            t = self._tasks.get(task_id)
        if t is None:
            raise TaskNotFoundError(f"task {task_id} not found")
        return t

    def wait_task(self, task_id: str,
                  timeout: Optional[float] = None) -> Optional[ExitResult]:
        t = self._get(task_id)
        if not t.done.wait(timeout):
            return None
        return t.exit_result

    def stop_task(self, task_id: str, timeout_s: float,
                  signal: str = "") -> None:
        t = self._get(task_id)
        t.stop.set()
        t.done.wait(timeout_s + 1.0)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        t = self._get(task_id)
        if not t.done.is_set():
            if not force:
                raise DriverError(f"task {task_id} still running")
            t.stop.set()
            t.done.wait(1.0)
        with self._lock:
            self._tasks.pop(task_id, None)

    def recover_task(self, handle: TaskHandle) -> None:
        with self._lock:
            if handle.task_id in self._tasks:
                return
        raise TaskNotFoundError(
            "mock tasks do not survive driver restarts")

    def inspect_task(self, task_id: str) -> TaskStatus:
        t = self._get(task_id)
        return TaskStatus(
            id=task_id, name=t.cfg.name,
            state=TASK_STATE_EXITED if t.done.is_set() else TASK_STATE_RUNNING,
            started_at=t.started_at, completed_at=t.completed_at,
            exit_result=t.exit_result)

    def signal_task(self, task_id: str, signal: str) -> None:
        self._get(task_id)             # existence check only
