"""Multi-window SLO error-budget (burn-rate) accounting.

Classic SRE-workbook alerting shape: an SLO of `objective` (e.g.
99.9% of evals under the p99 latency target) defines an error budget
of `1 - objective`.  The burn rate over a window is

    burn(w) = (bad_fraction over w) / budget

so burn 1.0 consumes exactly the budget over the SLO period, 14.4
exhausts a 30-day budget in ~2 days.  Two windows are tracked:

  * FAST (default 60s, threshold 14): page-grade — a sudden cliff.
  * SLOW (default 600s, threshold 2): ticket-grade — a slow leak.

Alerts flip with hysteresis (clear at half the trip threshold) and
surface both ways the rest of this repo reports: a `slo.burn` mesh
event on trip/clear, and `slo.*` gauges every observation.

The ring holds per-second (good, bad) pairs bounded by the slow
window, so memory is O(slow_window_s).  Clock injected for tests.

The counterpart of `nomad_tpu.telemetry.slo`.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class SloBurnTracker:
    FAST = "fast"
    SLOW = "slow"

    def __init__(self, objective: float = 0.999,
                 fast_window_s: int = 60, fast_burn: float = 14.0,
                 slow_window_s: int = 600, slow_burn: float = 2.0,
                 clock=time.monotonic,
                 events=None, metrics=None, prefix: str = "slo"):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1): {objective}")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("windows must satisfy 0 < fast <= slow")
        self.objective = objective
        self.budget = 1.0 - objective
        self.windows: Tuple[Tuple[str, int, float], ...] = (
            (self.FAST, int(fast_window_s), float(fast_burn)),
            (self.SLOW, int(slow_window_s), float(slow_burn)))
        self._clock = clock
        self._events = events
        self._metrics = metrics
        self._prefix = prefix
        self._lock = threading.Lock()
        # ring of (second, good, bad) triples, newest last, spanning
        # at most slow_window_s distinct seconds
        self._ring: List[List[int]] = []
        self._alerting: Dict[str, bool] = {
            self.FAST: False, self.SLOW: False}

    # ------------------------------------------------------- feeding
    def observe(self, good: int = 0, bad: int = 0,
                now: Optional[float] = None) -> None:
        """Fold a batch of SLO verdicts into the current second and
        re-evaluate both windows."""
        t = int(self._clock() if now is None else now)
        fired: List[Tuple[str, bool, float]] = []
        with self._lock:
            if self._ring and self._ring[-1][0] == t:
                self._ring[-1][1] += int(good)
                self._ring[-1][2] += int(bad)
            else:
                self._ring.append([t, int(good), int(bad)])
            horizon = t - self.windows[-1][1]
            while self._ring and self._ring[0][0] <= horizon:
                self._ring.pop(0)
            for name, w, threshold in self.windows:
                burn = self._burn_locked(t, w)
                on = self._alerting[name]
                if not on and burn >= threshold:
                    self._alerting[name] = True
                    fired.append((name, True, burn))
                elif on and burn < threshold / 2.0:
                    self._alerting[name] = False
                    fired.append((name, False, burn))
                if self._metrics is not None:
                    self._metrics.set_gauge(
                        f"{self._prefix}.burn_{name}", burn)
        if self._metrics is not None:
            self._metrics.set_gauge(
                f"{self._prefix}.alerting",
                1.0 if any(self._alerting.values()) else 0.0)
        for name, on, burn in fired:
            if self._events is not None:
                self._events.record(
                    "slo.burn", window=name,
                    state="trip" if on else "clear",
                    burn_rate=round(burn, 4),
                    objective=self.objective)

    # ------------------------------------------------------- reading
    def _burn_locked(self, t: int, window_s: int) -> float:
        lo = t - window_s
        good = bad = 0
        for sec, g, b in self._ring:
            if sec > lo:
                good += g
                bad += b
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.budget

    def burn_rate(self, window_s: int,
                  now: Optional[float] = None) -> float:
        t = int(self._clock() if now is None else now)
        with self._lock:
            return self._burn_locked(t, window_s)

    def status(self, now: Optional[float] = None) -> Dict:
        t = int(self._clock() if now is None else now)
        with self._lock:
            out = {"objective": self.objective,
                   "budget": self.budget,
                   "windows": {}, "alerting": dict(self._alerting)}
            for name, w, threshold in self.windows:
                out["windows"][name] = {
                    "window_s": w, "threshold": threshold,
                    "burn_rate": self._burn_locked(t, w)}
            return out
