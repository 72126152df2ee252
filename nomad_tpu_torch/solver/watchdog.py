"""Solve watchdog: a deadline on the device solve with a host-twin
failover for an injected fault.  The counterpart of
`nomad_tpu.solver.watchdog`, narrowed.

The device solve and the numpy host twin produce placement-identical
results (tests/test_torch_host_solver.py), so a device solve that a
chaos harness has stalled past the deadline, or poisoned, is answered
without changing any answer: the device call runs on a worker thread
with a deadline; on expiry it is abandoned, the host twin answers, the
device path is quarantined, and it is re-probed after a capped jittered
exponential backoff.  Every transition lands in the mesh event log and
the flight recorder, and counters surface through MetricsRegistry.

The rule of this module, and where it departs from the reference:

  * Off by default.  `SolveWatchdog(deadline_s=None)` reads no
    environment (the reference's `NOMAD_TPU_SOLVE_DEADLINE_S` is not
    read here: a production deadline would be a fallback that hides the
    device), and with the deadline None `run()` calls the device
    function inline and adds nothing.  Only a chaos harness (a test, or
    chip_smoke.py's chaos phase) sets `global_watchdog.deadline_s`, and
    it sets it back to None when it is done.  No Solver, Server or agent
    option turns it on.
  * It fails over only for an injected fault: the deadline expired
    (the "device_solve" site's "sleep" stalls past it), or the device
    function raised `ChaosInjected` (the site's "raise").  Any other
    exception from the device path (a CUDA error, a failed kernel
    build, the wave wrapper's own raise) propagates to the caller
    unchanged, even with the watchdog armed.  The reference fails over
    on any exception; this package never swallows a real device error.
  * Every failover is counted (`watchdog.host_failover`,
    `watchdog.host_quarantine`) and recorded (`watchdog.failover`), and
    the caller gets the route that answered, so the solve's own trace
    says "host_failover" or "host_quarantine".

A device call abandoned at the deadline still runs to its end on its
thread (a thread cannot be cancelled); its result is dropped.
`abandoned()` lists those threads and `join_abandoned()` waits for
them, so a harness can settle the card before it reads launch counts.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from ..chaos.injection import ChaosInjected


class SolveWatchdog:
    """Wraps one device dispatch site.  Thread-safe: concurrent solves
    share the quarantine state under a lock; the device probe after
    backoff is claimed by exactly one caller."""

    def __init__(self, deadline_s: Optional[float] = None,
                 base_backoff_s: float = 0.1,
                 max_backoff_s: float = 5.0,
                 seed: int = 0x5EED,
                 event_log=None, tracer=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self._rng = random.Random(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self.quarantined = False
        self._failures = 0            # consecutive failovers
        self._probe_at = 0.0          # next device re-probe time
        self._probing = False         # a caller holds the probe claim
        self._threads: List[threading.Thread] = []
        if event_log is None:
            from ..utils.tracing import global_mesh_events
            event_log = global_mesh_events
        if tracer is None:
            from ..utils.tracing import global_tracer
            tracer = global_tracer
        if metrics is None:
            from ..utils.metrics import global_metrics
            metrics = global_metrics
        self.event_log = event_log
        self.tracer = tracer
        self.metrics = metrics

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return self.deadline_s is not None

    def reset(self) -> None:
        """Off, healthy, no failures counted (a harness's `finally`)."""
        with self._lock:
            self.deadline_s = None
            self.quarantined = False
            self._failures = 0
            self._probing = False
            self._probe_at = 0.0

    def _claim_probe(self) -> bool:
        """True when this caller should try the device again: either
        healthy, or quarantined with the backoff elapsed (one caller
        wins the probe; the rest stay on the host twin)."""
        with self._lock:
            if not self.quarantined:
                return True
            if self._probing or self._clock() < self._probe_at:
                return False
            self._probing = True
            return True

    def _note_success(self) -> None:
        with self._lock:
            was = self.quarantined
            self.quarantined = False
            self._failures = 0
            self._probing = False
        if was:
            self.metrics.incr_counter("watchdog.recovered")
            self.event_log.record("watchdog.recovered")

    def _release_probe(self) -> None:
        with self._lock:
            self._probing = False

    def _note_expiry(self, label: str, waited_s: float) -> None:
        with self._lock:
            self._failures += 1
            fails = self._failures
            self.quarantined = True
            self._probing = False
            # capped jittered exponential backoff before the next
            # device probe; jitter decorrelates a fleet of workers
            # re-probing a shared device
            delay = min(self.max_backoff_s,
                        self.base_backoff_s * (2 ** (fails - 1)))
            delay *= 0.5 + self._rng.random() / 2.0
            self._probe_at = self._clock() + delay
        self.metrics.incr_counter("watchdog.expired")
        self.metrics.set_gauge("watchdog.consecutive_failures",
                               float(fails))
        self.event_log.record("watchdog.failover", label=label,
                              waited_s=round(waited_s, 4),
                              failures=fails,
                              retry_in_s=round(delay, 4))
        self.tracer.event(label or "solve", "watchdog.failover",
                          waited_s=round(waited_s, 4), failures=fails)

    # -------------------------------------------------------------- run
    def run(self, device_fn: Callable[[], object],
            host_fn: Callable[[], object], label: str = ""):
        """Answer from `device_fn` under the deadline, falling back to
        the placement-identical `host_fn` for an injected fault.
        Returns (result, backend) where backend is "device",
        "host_failover" (this call expired or raised ChaosInjected) or
        "host_quarantine" (an earlier failover, backoff not elapsed).
        Any other exception of `device_fn` is raised here.

        `device_fn` must BLOCK until its result is fetched (dispatch +
        fetch): an unfetched result that only hangs at a later fetch
        would escape the deadline."""
        if not self.enabled:
            return device_fn(), "device"
        if not self._claim_probe():
            self.metrics.incr_counter("watchdog.host_quarantine")
            return host_fn(), "host_quarantine"

        box: dict = {}
        done = threading.Event()

        def _runner():
            try:
                box["result"] = device_fn()
            except BaseException as e:       # noqa: BLE001 — relayed
                box["error"] = e
            done.set()

        t0 = self._clock()
        t = threading.Thread(target=_runner, daemon=True,
                             name="solve-watchdog")
        t.start()
        if done.wait(self.deadline_s):
            err = box.get("error")
            if err is None:
                self._note_success()
                return box["result"], "device"
            if not isinstance(err, ChaosInjected):
                # a real device error is the caller's, never a failover
                self._release_probe()
                self.event_log.record("watchdog.device_error",
                                      label=label, error=repr(err),
                                      failover=False)
                raise err
            # an injected poison: the same failover as an expiry, with
            # its cause recorded
            self.event_log.record("watchdog.device_error", label=label,
                                  error=repr(err), failover=True)
        else:
            with self._lock:
                self._threads.append(t)
        waited = self._clock() - t0
        self._note_expiry(label, waited)
        self.metrics.incr_counter("watchdog.host_failover")
        return host_fn(), "host_failover"

    def abandoned(self) -> List[threading.Thread]:
        """Device calls abandoned at the deadline that still run."""
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            return list(self._threads)

    def join_abandoned(self, timeout: Optional[float] = None) -> int:
        """Wait for the abandoned device calls (each up to `timeout`
        seconds); returns how many still run."""
        for t in self.abandoned():
            t.join(timeout)
        return len(self.abandoned())

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "deadline_s": self.deadline_s,
                    "quarantined": self.quarantined,
                    "consecutive_failures": self._failures,
                    "retry_at": self._probe_at}


#: process-wide watchdog consulted by solve.py's _run_kernel; off
#: unless a chaos harness sets its deadline
global_watchdog = SolveWatchdog()
