"""In-process metrics registry (reference: armon/go-metrics as wired in
command/agent/command.go:985-1060; the timing points mirror
nomad/worker.go:162,245,282 and nomad/plan_apply.go:185,369,400).

The counterpart of `nomad_tpu.utils.metrics`: counters, gauges, timing
samples (`measure_since`, the MeasureSince analog; `timed` the
context-manager sugar) and explicit-bucket histograms, read back with
`dump`.  Not here yet (ROADMAP.md Queue 1, item 5): the Prometheus
exposition and the per-namespace key cap (`NOMAD_TPU_METRICS_MAX_KEYS`,
`metrics.overflow`).
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from contextlib import contextmanager
from typing import Dict

_RESERVOIR = 2048


class _Summary:
    __slots__ = ("count", "sum", "min", "max", "values")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        # bounded tail reservoir for percentiles (the last N samples —
        # recency-biased, which is what latency dashboards want)
        self.values = deque(maxlen=_RESERVOIR)

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.values.append(v)

    def percentile(self, p: float) -> float:
        if not self.values:
            return 0.0
        vals = sorted(self.values)
        k = min(int(len(vals) * p), len(vals) - 1)
        return vals[k]

    def snapshot(self) -> dict:
        mean = self.sum / self.count if self.count else 0.0
        vals = sorted(self.values)     # one sort for both percentiles
        p50 = vals[min(int(len(vals) * 0.50), len(vals) - 1)] if vals \
            else 0.0
        p99 = vals[min(int(len(vals) * 0.99), len(vals) - 1)] if vals \
            else 0.0
        return {"count": self.count, "sum": round(self.sum, 6),
                "mean": round(mean, 6),
                "min": round(self.min, 6) if self.count else 0.0,
                "max": round(self.max, 6),
                "p50": round(p50, 6), "p99": round(p99, 6)}


#: default explicit bucket bounds for observe_hist: latency-shaped,
#: 1ms..~67s in powers of 4 (seconds).  Callers with counts (batch
#: sizes) pass their own bounds.
DEFAULT_HIST_BUCKETS = (0.001, 0.004, 0.016, 0.064, 0.256, 1.024,
                        4.096, 16.384, 65.536)


class _Histogram:
    """Explicit-bucket histogram: cumulative bucket counts, +Inf
    implied by the total count."""
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"bucket bounds must be strictly "
                             f"increasing: {bounds}")
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1

    def snapshot(self) -> dict:
        return {"buckets": [[b, c] for b, c in
                            zip(self.bounds, self.counts)],
                "sum": round(self.sum, 6), "count": self.count}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._samples: Dict[str, _Summary] = {}
        self._hists: Dict[str, _Histogram] = {}

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = value

    def add_sample(self, key: str, value_s: float) -> None:
        with self._lock:
            self._samples.setdefault(key, _Summary()).add(value_s)

    def observe_hist(self, key: str, value: float,
                     buckets=None) -> None:
        """Explicit-bucket histogram observation.  Bucket bounds are
        fixed at first observation; a later call with different bounds
        keeps the original (bounds are config, not data)."""
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(
                    buckets if buckets is not None
                    else DEFAULT_HIST_BUCKETS)
            h.add(float(value))

    def measure_since(self, key: str, t0: float) -> None:
        """t0 from time.monotonic(); records seconds elapsed."""
        self.add_sample(key, _time.monotonic() - t0)

    @contextmanager
    def timed(self, key: str):
        t0 = _time.monotonic()
        try:
            yield
        finally:
            self.measure_since(key, t0)

    def dump(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "samples": {k: s.snapshot()
                            for k, s in self._samples.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()
            self._hists.clear()


#: process-global registry (the go-metrics global sink analog)
global_metrics = MetricsRegistry()
