"""Per-task lifecycle runner (reference:
client/allocrunner/taskrunner/task_runner.go — Run :446 restart loop,
runDriver :717, handleKill :843, Restore + driver re-attach :971,:1019;
restart policy in client/allocrunner/taskrunner/restarts/).

One thread per task: prestart (task dir, env build) -> start driver ->
wait -> on exit consult the restart tracker -> restart or finalize.
Every transition persists {TaskHandle, TaskState} to the client state DB
so a restarted agent re-attaches instead of re-running.

The counterpart of `nomad_tpu.client.taskrunner`.
"""
from __future__ import annotations

import copy
import logging
import os
import random
import threading
import time as _time
from typing import Callable, Optional

from ..plugins.drivers import (DriverError, DriverPlugin, ExitResult,
                               TaskConfig, TaskHandle, TaskNotFoundError)
from ..structs import (JOB_TYPE_BATCH, TASK_STATE_DEAD, TASK_STATE_PENDING,
                       TASK_STATE_RUNNING, Allocation, Node, Task, TaskEvent,
                       TaskState)
from .allocdir import AllocDir
from .taskenv import build_task_env, interpolate_config, node_vars

_log = logging.getLogger(__name__)

# task event types (reference: structs.TaskEvent consts)
EVENT_RECEIVED = "Received"
EVENT_SETUP = "Task Setup"
EVENT_STARTED = "Started"
EVENT_TERMINATED = "Terminated"
EVENT_RESTARTING = "Restarting"
EVENT_NOT_RESTARTING = "Not Restarting"
EVENT_KILLING = "Killing"
EVENT_KILLED = "Killed"
EVENT_DRIVER_FAILURE = "Driver Failure"
EVENT_TASK_LOST = "Task Lost"


class RestartTracker:
    """reference: client/allocrunner/taskrunner/restarts/restarts.go.

    Decides {restart, delay} after an exit: batch tasks restart only on
    failure; service/system tasks restart on any exit. Attempts are
    counted per policy interval; exceeding them either fails the task
    (mode=fail) or waits out the interval (mode=delay).
    """

    def __init__(self, policy, job_type: str):
        self.policy = policy
        self.job_type = job_type
        self.count = 0
        self.start = 0.0

    def next(self, result: Optional[ExitResult], killed: bool):
        """Returns (verdict, delay_s); verdict in
        {'restart', 'dead', 'failed'}."""
        if killed:
            return "dead", 0.0
        success = result is not None and result.successful()
        if self.job_type == JOB_TYPE_BATCH and success:
            return "dead", 0.0
        if self.policy is None or self.policy.attempts == 0:
            return ("dead" if success else "failed"), 0.0
        now = _time.time()
        if self.start == 0.0 or now - self.start > self.policy.interval_s:
            self.start = now
            self.count = 0
        self.count += 1
        delay = self.policy.delay_s * (1 + random.uniform(0, 0.25))
        if self.count <= self.policy.attempts:
            return "restart", delay
        if self.policy.mode == "delay":
            # wait out the rest of the interval, then the count resets
            remaining = self.policy.interval_s - (now - self.start)
            return "restart", max(remaining, 0.0) + delay
        return "failed", 0.0


class TaskRunner:
    def __init__(self, alloc: Allocation, task: Task, alloc_dir: AllocDir,
                 driver: DriverPlugin, node: Optional[Node],
                 on_state_change: Callable[["TaskRunner"], None],
                 state_db=None, device_registry=None,
                 secrets_fetcher=None):
        self.alloc = alloc
        self.task = task
        self.alloc_dir = alloc_dir
        self.driver = driver
        self.node = node
        self.on_state_change = on_state_change
        self.state_db = state_db
        self.device_registry = device_registry
        self.secrets_fetcher = secrets_fetcher
        self.task_id = f"{alloc.id}/{task.name}"
        self.state = TaskState(state=TASK_STATE_PENDING)
        self.handle: Optional[TaskHandle] = None
        self._kill = threading.Event()
        self._kill_reason = ""
        self._dead = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        self.restart_tracker = RestartTracker(
            tg.restart_policy if tg else None,
            job.type if job else "service")
        self._restored = False

    # ------------------------------------------------------------- state
    def task_state(self) -> TaskState:
        with self._lock:
            return copy.deepcopy(self.state)

    def _emit(self, etype: str, message: str = "", failed: bool = False,
              exit_code: int = 0) -> None:
        with self._lock:
            self.state.events.append(TaskEvent(
                type=etype, time=_time.time(), message=message,
                failure=failed, exit_code=exit_code))
            if len(self.state.events) > 10:
                del self.state.events[:len(self.state.events) - 10]

    def _set_state(self, state: str, failed: Optional[bool] = None) -> None:
        with self._lock:
            self.state.state = state
            if failed is not None:
                self.state.failed = failed
            if state == TASK_STATE_RUNNING and not self.state.started_at:
                self.state.started_at = _time.time()
            if state == TASK_STATE_DEAD:
                self.state.finished_at = _time.time()
        self._persist()
        self.on_state_change(self)

    # ------------------------------------------------------ service checks
    def _start_checks(self) -> None:
        """Run each service's checks on their intervals (reference: the
        consul agent runs registered checks; here the client runs them
        natively and the results ride task-state sync into the service
        catalog). Threads exit with the task; started at most once per
        runner (restarts reuse the running loops)."""
        with self._lock:
            if getattr(self, "_checks_started", False):
                return
            self._checks_started = True
        for svc in self.task.services:
            for check in svc.checks:
                t = threading.Thread(
                    target=self._check_loop, args=(svc, check),
                    daemon=True,
                    name=f"check-{self.task_id}-{check.name}")
                t.start()

    def _check_loop(self, svc, check) -> None:
        key = f"{svc.name}/{check.name or check.type}"
        # a check-level port_label overrides the service's (reference:
        # the check stanza's own port wins)
        port = self._service_port(check.port_label or svc.port_label)
        while not self._kill.is_set():
            ok = self._run_check(check, port)
            changed = False
            with self._lock:
                if self.state.checks.get(key) != ok:
                    self.state.checks[key] = ok
                    changed = True
            if changed:
                self._persist()
                self.on_state_change(self)
            if self._kill.wait(max(check.interval_s, 0.1)):
                return

    def _service_port(self, label: str):
        tr = self.alloc.allocated_resources.tasks.get(self.task.name)
        if tr is None or not label:
            return None
        for net in tr.networks:
            for p in (list(net.reserved_ports)
                      + list(net.dynamic_ports)):
                if p.label == label:
                    return p.value
        return None

    def _run_check(self, check, port) -> bool:
        import socket as _socket
        import subprocess as _subprocess
        try:
            if check.type == "tcp":
                if port is None:
                    return False
                with _socket.create_connection(
                        ("127.0.0.1", port),
                        timeout=max(check.timeout_s, 0.1)):
                    return True
            if check.type == "http":
                if port is None:
                    return False
                import urllib.request
                url = f"http://127.0.0.1:{port}{check.path or '/'}"
                with urllib.request.urlopen(
                        url, timeout=max(check.timeout_s, 0.1)) as r:
                    return 200 <= r.status < 400
            if check.type == "script":
                out = _subprocess.run(
                    [check.command] + list(check.args),
                    capture_output=True,
                    timeout=max(check.timeout_s, 0.1))
                return out.returncode == 0
        except Exception:               # noqa: BLE001
            return False
        return False                    # unknown check type: fail safe

    def _persist(self) -> None:
        if self.state_db is not None:
            with self._lock:
                handle = copy.deepcopy(self.handle)
                state = copy.deepcopy(self.state)
            self.state_db.put_task_runner_state(
                self.alloc.id, self.task.name, handle, state)

    # --------------------------------------------------------------- run
    def mark_failed(self, reason: str) -> None:
        """Fail the task without running it (alloc-level prerun hook
        failures — reference: alloc_runner.go prerun error path)."""
        self._emit(EVENT_DRIVER_FAILURE, message=reason, failed=True)
        self._set_state(TASK_STATE_DEAD, failed=True)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"taskrunner-{self.task_id}")
        self._thread.start()

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:
            _log.exception("task runner %s crashed", self.task_id)
            self._emit(EVENT_DRIVER_FAILURE, message=str(e), failed=True)
            self._set_state(TASK_STATE_DEAD, failed=True)
        finally:
            self._dead.set()

    def _run(self) -> None:
        if self._restored and self.task_state().state == TASK_STATE_DEAD:
            return                     # restored an already-finished task
        self._emit(EVENT_RECEIVED)
        if not self._restored:
            self._prestart()
        while not self._kill.is_set():
            if self._restored and self.handle is not None:
                # re-attached to a live task: skip straight to wait
                # (checks must resume too — health would otherwise
                # freeze at the last persisted value)
                self._restored = False
                self._start_checks()
            else:
                self._restored = False
                try:
                    self._start_driver()
                except DriverError as e:
                    self._emit(EVENT_DRIVER_FAILURE, message=str(e),
                               failed=True)
                    verdict, delay = self.restart_tracker.next(
                        ExitResult(exit_code=-1, err=str(e)), killed=False)
                    if verdict == "restart" and not self._kill.wait(delay):
                        self._emit(EVENT_RESTARTING,
                                   message="driver failure")
                        continue
                    self._set_state(TASK_STATE_DEAD, failed=True)
                    return
            result = self._wait_driver()
            killed = self._kill.is_set()
            self._emit(EVENT_TERMINATED,
                       message=(result.err if result and result.err
                                else f"exit code {result.exit_code}"
                                if result else "killed"),
                       failed=bool(result and not result.successful()),
                       exit_code=result.exit_code if result else 0)
            self._destroy_driver_task()
            verdict, delay = self.restart_tracker.next(result, killed)
            if verdict == "restart":
                self._emit(EVENT_RESTARTING,
                           message=f"restarting in {delay:.1f}s")
                with self._lock:
                    self.state.restarts += 1
                    self.state.last_restart = _time.time()
                if self._kill.wait(delay):
                    break
                continue
            self._set_state(TASK_STATE_DEAD, failed=(verdict == "failed"))
            return
        # killed
        self._emit(EVENT_KILLED, message=self._kill_reason)
        self._set_state(TASK_STATE_DEAD, failed=False)

    # ----------------------------------------------------------- phases
    def _prestart(self) -> None:
        self._emit(EVENT_SETUP, message="Building Task Directory")
        self.alloc_dir.build()
        self.alloc_dir.build_task_dir(self.task.name)
        self._write_dispatch_payload()
        self._persist()
        self.on_state_change(self)

    def _write_dispatch_payload(self) -> None:
        """Deliver a dispatched job's payload into the task dir
        (reference: taskrunner/dispatch_hook.go — writes the payload to
        local/<dispatch_payload.file> before the task starts)."""
        dp = getattr(self.task, "dispatch_payload", None)
        job = self.alloc.job
        if not dp or not dp.file or job is None or not job.payload:
            return
        local = os.path.join(self.alloc_dir.task_dir(self.task.name), "local")
        dest = os.path.join(local, dp.file.lstrip("/"))
        # Containment check: the jobspec validates this at registration
        # (reference: structs/structs.go DispatchPayloadConfig.Validate →
        # PathEscapesAllocDir), but a payload path must never escape the
        # task dir even if a job bypassed validation (e.g. raw raft
        # restore), so re-check the normalized destination here too.
        localr = os.path.realpath(local)
        destr = os.path.realpath(os.path.dirname(dest))
        if destr != localr and not destr.startswith(localr + os.sep):
            raise RuntimeError(
                f"dispatch_payload file {dp.file!r} escapes the task's "
                "local directory")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # The task itself can plant a symlink (agent writes outside the
        # sandbox) or a FIFO (open blocks forever) at the payload path
        # between runs: drop whatever is there and create fresh —
        # O_EXCL+O_NOFOLLOW closes the unlink→open race.
        dest = os.path.join(destr, os.path.basename(dest))
        try:
            os.unlink(dest)
        except FileNotFoundError:
            pass
        fd = os.open(dest, os.O_WRONLY | os.O_CREAT | os.O_EXCL
                     | os.O_NOFOLLOW, 0o644)
        with os.fdopen(fd, "wb") as f:
            f.write(job.payload)

    def _resolve_secrets(self, env: dict) -> dict:
        """Resolve ${secret.<path>.<key>} references in task env values
        against the server's native secret store (the Vault template
        analog: secrets reach the task as env, never touch server-side
        job state). An unresolvable reference fails the task at setup."""
        import re
        pat = re.compile(r"\$\{secret\.([A-Za-z0-9_\-/]+)\.([A-Za-z0-9_\-]+)\}")
        if self.secrets_fetcher is None:
            return env
        out = {}
        cache: dict = {}
        for k, v in env.items():
            def sub(m):
                path, key = m.group(1), m.group(2)
                if path not in cache:
                    try:
                        cache[path] = self.secrets_fetcher(
                            self.alloc.namespace, path)
                    except Exception as e:     # noqa: BLE001
                        # transport blip (leader election, network):
                        # recoverable — let the restart policy retry
                        # instead of permanently failing the task
                        raise DriverError(
                            f"secret fetch failed: {e}") from e
                data = cache[path]
                if data is None or key not in data:
                    raise RuntimeError(
                        f"unresolvable secret ${{secret.{path}.{key}}}")
                return data[key]
            out[k] = pat.sub(sub, v) if isinstance(v, str) else v
        return out

    def _device_envs(self) -> dict:
        """Reserve this task's assigned device instances through their
        owning plugins; their env recipe joins the task environment
        (reference: devicemanager Reserve at task start, devicehook)."""
        if self.device_registry is None:
            return {}
        tr = self.alloc.allocated_resources.tasks.get(self.task.name)
        if tr is None:
            return {}
        envs: dict = {}
        for ad in tr.devices:
            res = self.device_registry.reserve(
                ad.vendor, ad.type, ad.name, list(ad.device_ids))
            if res is None:
                # launching without the device recipe would hand the
                # task every host device (or crash it later) — fail at
                # setup like the reference devicehook does
                raise RuntimeError(
                    f"no device plugin owns {ad.vendor}/{ad.type}/"
                    f"{ad.name}; cannot reserve {ad.device_ids}")
            envs.update(res.envs)
        return envs

    def _task_config(self) -> TaskConfig:
        task_dir = self.alloc_dir.task_dir(self.task.name)
        env = build_task_env(
            self.alloc, self.task, self.node, task_dir=task_dir,
            alloc_dir=self.alloc_dir.shared,
            secrets_dir=self.alloc_dir.secrets_dir(self.task.name))
        env.update(self._device_envs())
        env = self._resolve_secrets(env)
        vars_ = dict(node_vars(self.node))
        vars_.update({f"env.{k}": v for k, v in env.items()})
        vars_.update(env)
        config = interpolate_config(self.task.config or {}, vars_)
        res = self.task.resources
        return TaskConfig(
            id=self.task_id, name=self.task.name, alloc_id=self.alloc.id,
            env=env, config=config, user=self.task.user,
            cpu_mhz=res.cpu if res else 0,
            memory_mb=res.memory_mb if res else 0,
            task_dir=task_dir, alloc_dir=self.alloc_dir.shared,
            stdout_path=self.alloc_dir.stdout_path(self.task.name),
            stderr_path=self.alloc_dir.stderr_path(self.task.name),
            log_max_files=(self.task.log_config.max_files
                           if self.task.log_config else 10),
            log_max_file_size_mb=(self.task.log_config.max_file_size_mb
                                  if self.task.log_config else 10))

    def _start_driver(self) -> None:
        handle = self.driver.start_task(self._task_config())
        with self._lock:
            self.handle = handle
        self._persist()
        self._emit(EVENT_STARTED)
        self._set_state(TASK_STATE_RUNNING)
        self._start_checks()

    def _wait_driver(self) -> Optional[ExitResult]:
        while not self._kill.is_set():
            result = self.driver.wait_task(self.task_id, timeout=0.2)
            if result is not None:
                return result
        # kill requested: stop through the driver, honoring kill_timeout
        try:
            self.driver.stop_task(self.task_id, self.task.kill_timeout_s,
                                  self.task.kill_signal)
        except TaskNotFoundError:
            return None
        except DriverError as e:
            _log.warning("stop_task %s: %s", self.task_id, e)
        return self.driver.wait_task(self.task_id, timeout=5.0)

    def _destroy_driver_task(self) -> None:
        try:
            self.driver.destroy_task(self.task_id, force=True)
        except (TaskNotFoundError, DriverError):
            pass
        with self._lock:
            self.handle = None
        self._persist()

    # ------------------------------------------------------------ verbs
    def kill(self, reason: str = "", wait: bool = True) -> None:
        self._emit(EVENT_KILLING, message=reason)
        self._kill_reason = reason
        self._kill.set()
        if wait and self._thread is not None:
            self._dead.wait(self.task.kill_timeout_s + 15.0)

    def is_dead(self) -> bool:
        return self._dead.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._dead.wait(timeout)

    # ---------------------------------------------------------- restore
    def restore(self) -> None:
        """Re-attach from the state DB (reference: task_runner.go:971
        Restore + :1019 restoreHandle). On a live handle the run loop
        resumes at wait; a lost task re-enters the restart loop."""
        if self.state_db is None:
            return
        handle, state = self.state_db.get_task_runner_state(
            self.alloc.id, self.task.name)
        if state is not None:
            with self._lock:
                self.state = state
        if state is not None and state.state == TASK_STATE_DEAD:
            # nothing to re-attach; mark runner finished
            self._restored = True
            self._dead.set()
            return
        if handle is None:
            return
        try:
            self.driver.recover_task(handle)
            status = self.driver.inspect_task(handle.task_id)
        except (TaskNotFoundError, DriverError) as e:
            self._emit(EVENT_TASK_LOST,
                       message=f"task not recoverable: {e}", failed=True)
            with self._lock:
                self.handle = None
            self._persist()
            return
        with self._lock:
            self.handle = handle
        self._restored = True
