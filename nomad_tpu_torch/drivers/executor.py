"""Per-task executor process (reference: drivers/shared/executor).

The reference launches every task under an out-of-process executor so the
workload survives agent restarts/upgrades, and the restarted agent
re-attaches to the executor to recover the exit code. This is the same
design: `python -m nomad_tpu_torch.drivers.executor <spec.json>` detaches
into its own session, spawns the task, records {pid, start_ticks} to the
state file (start_ticks defeats pid reuse on re-attach), waits, and
writes the exit result file that a (possibly different) agent process
polls.

Spec file (JSON): argv, env, cwd, stdout_path, stderr_path,
state_file, exit_file, and the log rotation limits.

The counterpart of `nomad_tpu.drivers.executor`, without the `exec`
driver's isolation block (namespaces, chroot, cgroups), which comes with
that driver (ROADMAP.md Queue 1 item 16b).  Its import chain (this
package's `__init__`, `drivers/__init__`, the builtin drivers and the
plugin interface) loads neither torch nor the JAX package: the executor
of each of many tasks started at once must be up well inside the
driver's start timeout.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time


def proc_start_ticks(pid: int) -> int:
    """Kernel start time of `pid` in clock ticks (field 22 of
    /proc/<pid>/stat, after the comm field which may contain spaces)."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        data = f.read().decode("ascii", "replace")
    rest = data[data.rfind(")") + 2:].split()
    return int(rest[19])           # field 22 overall; 20th after state


def pid_alive(pid: int, start_ticks: int = 0) -> bool:
    """Liveness with pid-reuse protection."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    if start_ticks:
        try:
            return proc_start_ticks(pid) == start_ticks
        except (OSError, ValueError):
            return False
    return True


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


class _RotatingWriter:
    """Size-rotated log sink (reference: client/logmon/logging — the
    out-of-proc rotating writer; this executor IS the out-of-proc
    supervisor, so logs both survive agent restarts and stay bounded).
    Current file keeps the task path; older generations shift to
    .1 .. .N and the oldest is dropped."""

    def __init__(self, path: str, max_bytes: int, max_files: int):
        self.path = path
        self.max_bytes = max(max_bytes, 1)
        self.max_files = max(max_files, 1)
        self._fh = open(path, "ab", buffering=0)
        self._size = self._fh.tell()

    def write(self, data: bytes) -> None:
        if self._size + len(data) > self.max_bytes and self._size > 0:
            self._rotate()
        self._fh.write(data)
        self._size += len(data)

    def _rotate(self) -> None:
        self._fh.close()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            try:
                os.replace(src, f"{self.path}.{i}")
            except FileNotFoundError:
                pass
        if self.max_files == 1:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        self._fh = open(self.path, "ab", buffering=0)
        self._size = 0

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


def _pump_until_eof(writers: dict, poll=None, grace: float = 5.0,
                    timeout: float = 1.0) -> None:
    """Thread-free select/os.read pump: drain every readable fd into its
    rotating writer until ALL pipes hit EOF (the task tree closed them).
    A detached grandchild can inherit the pipe and never close it, so
    once `poll()` reports the direct child gone the pump lingers at most
    `grace` seconds — the old daemon-thread join bound.

    Runs on the executor's main thread — no `threading.Thread` (the
    `exec` driver's jail may forbid thread creation inside a fresh
    user+pid namespace).  `os.read` on a select-ready pipe fd returns
    whatever is buffered immediately, so output reaches the log file
    while the task is still running (a BufferedReader `.read(n)` blocks
    for the full n bytes and stalled live log streaming until exit).

    A writer error (disk full, rotation race) must never stall the
    child: the failing sink is downgraded to drain-and-discard so the
    pipe keeps flowing.
    """
    import select
    fds = dict(writers)            # fd -> writer (or None: discard)
    exit_deadline = None
    while fds:
        if poll is not None and exit_deadline is None \
                and poll() is not None:
            exit_deadline = time.monotonic() + grace
        if exit_deadline is not None and time.monotonic() > exit_deadline:
            break
        try:
            ready, _, _ = select.select(list(fds), [], [], timeout)
        except OSError:
            ready = list(fds)      # EBADF etc: probe each fd directly
        for fd in ready:
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                continue
            except OSError:
                chunk = b""
            if not chunk:          # EOF (or dead fd): retire it
                w = fds.pop(fd, None)
                if w is not None:
                    w.close()
                continue
            w = fds.get(fd)
            if w is not None:
                try:
                    w.write(chunk)
                except OSError:
                    try:
                        w.close()
                    except OSError:
                        pass
                    fds[fd] = None      # keep draining, drop the bytes
    for w in fds.values():              # grace-break: flush what's left
        if w is not None:
            w.close()


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)

    # log rotation: when the spec carries limits, task output flows
    # through this supervisor into rotating files; otherwise the child
    # inherits the raw file descriptors (legacy specs)
    log_max_bytes = int(spec.get("log_max_bytes") or 0)
    log_max_files = int(spec.get("log_max_files") or 0)
    rotate = log_max_bytes > 0 and log_max_files > 0
    if rotate:
        stdout = subprocess.PIPE
        stderr = subprocess.PIPE
    else:
        stdout = open(spec["stdout_path"], "ab", buffering=0)
        stderr = open(spec["stderr_path"], "ab", buffering=0)
    try:
        child = subprocess.Popen(
            spec["argv"],
            env=spec.get("env") or None,
            cwd=spec.get("cwd") or None,
            stdout=stdout, stderr=stderr,
            stdin=subprocess.DEVNULL,
            start_new_session=True,   # own pgid: killpg targets the task tree
        )
    except (OSError, KeyError) as e:
        _atomic_write_json(spec["exit_file"], {
            "exit_code": 127, "signal": 0, "err": str(e),
            "finished_at": time.time()})
        return 1

    writers = {}
    if rotate:
        for src, path in ((child.stdout, spec["stdout_path"]),
                          (child.stderr, spec["stderr_path"])):
            try:
                writers[src.fileno()] = _RotatingWriter(
                    path, log_max_bytes, log_max_files)
            except OSError:
                # sink unavailable: drain-and-discard keeps the child
                # unblocked; the task itself must survive
                writers[src.fileno()] = None

    _atomic_write_json(spec["state_file"], {
        "executor_pid": os.getpid(),
        "pid": child.pid,
        "start_ticks": proc_start_ticks(child.pid),
        "started_at": time.time(),
    })

    # the driver signals the task's process group directly; the executor
    # itself ignores SIGINT/SIGTERM so an agent shutdown can't take the
    # workload's supervisor down with it
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)

    if writers:
        _pump_until_eof(writers, poll=child.poll)
    code = child.wait()
    result = {"exit_code": code if code >= 0 else 0,
              "signal": -code if code < 0 else 0,
              "err": "",
              "finished_at": time.time()}
    _atomic_write_json(spec["exit_file"], result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
