"""Agent monitor + runtime profiling primitives.

Reference: command/agent/monitor/monitor.go (live log streaming over
/v1/agent/monitor — a ring of recent lines plus a subscription that
follows new ones) and command/agent/pprof/pprof.go (/v1/agent/pprof/*
— CPU profile, goroutine dump, cmdline).  The Python runtime analogs:
a logging.Handler ring buffer for the monitor, `sys._current_frames`
thread dumps for goroutines, and a sampling profiler (the py-spy
technique: periodic stack snapshots collapsed into counts) for the CPU
profile.

The counterpart of `nomad_tpu.utils.monitor`; the monitor attaches to
this package's logger (`nomad_tpu_torch`).
"""
from __future__ import annotations

import logging
import queue
import sys
import threading
import time
import traceback
from collections import Counter, deque
from typing import Dict, List, Optional

_LEVELS = {"trace": 5, "debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "warning": logging.WARNING,
           "error": logging.ERROR}


class LogMonitor(logging.Handler):
    """Ring buffer of recent agent log lines + live subscriptions."""

    def __init__(self, capacity: int = 512):
        super().__init__(level=logging.DEBUG)
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        self._ring: deque = deque(maxlen=capacity)
        self._subs: List[queue.Queue] = []
        self._lock = threading.Lock()
        self._installed_on: Optional[logging.Logger] = None

    # ------------------------------------------------- logging.Handler
    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:
            return
        with self._lock:
            self._ring.append((record.levelno, line))
            subs = list(self._subs)
        for q_ in subs:
            try:
                q_.put_nowait((record.levelno, line))
            except queue.Full:
                pass                      # slow consumer drops lines

    # ------------------------------------------------------ lifecycle
    def install(self, logger_name: str = "nomad_tpu_torch") -> None:
        """Attach to the package logger (idempotent).  The logger's
        LEVEL is left alone: the monitor observes whatever the
        operator's logging config emits — forcing DEBUG here would also
        flood their root handlers via propagation.  The dev agent sets
        the level explicitly from its `log_level` config."""
        if self._installed_on is not None:
            return
        lg = logging.getLogger(logger_name)
        lg.addHandler(self)
        self._installed_on = lg

    # --------------------------------------------------- subscriptions
    def subscribe(self, backlog: bool = True,
                  min_level: int = logging.DEBUG) -> queue.Queue:
        q_: queue.Queue = queue.Queue(maxsize=1024)
        with self._lock:
            if backlog:
                for levelno, line in self._ring:
                    if levelno >= min_level:
                        try:
                            q_.put_nowait((levelno, line))
                        except queue.Full:
                            break
            self._subs.append(q_)
        return q_

    def unsubscribe(self, q_: queue.Queue) -> None:
        with self._lock:
            try:
                self._subs.remove(q_)
            except ValueError:
                pass


#: the agent-wide monitor (installed by the HTTP agent on start)
global_monitor = LogMonitor()


def parse_level(name: str) -> int:
    return _LEVELS.get((name or "debug").lower(), logging.DEBUG)


# ------------------------------------------------------------- pprof
def thread_dump() -> str:
    """Stack trace of every live thread (the goroutine-dump analog:
    command/agent/pprof `goroutine` profile)."""
    names: Dict[int, str] = {t.ident: t.name
                             for t in threading.enumerate() if t.ident}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"thread {tid} ({names.get(tid, '?')}):")
        out.extend(l.rstrip()
                   for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def sample_profile(seconds: float = 1.0, hz: int = 100) -> str:
    """Sampling CPU profile: snapshot every thread's stack `hz` times a
    second for `seconds`, collapse identical stacks into counts
    (highest first, ;-joined frames innermost-last — the flamegraph
    collapsed format)."""
    me = threading.get_ident()
    interval = 1.0 / max(1, hz)
    counts: Counter = Counter()
    samples = 0
    deadline = time.monotonic() + max(0.01, seconds)
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}"
                             f":{f.f_lineno})")
                f = f.f_back
            counts[";".join(reversed(stack))] += 1
        samples += 1
        time.sleep(interval)
    lines = [f"samples: {samples}  interval: {interval * 1000:.1f}ms"]
    for stack, n in counts.most_common(200):
        lines.append(f"{n}\t{stack}")
    return "\n".join(lines)
