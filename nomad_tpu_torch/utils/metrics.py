"""In-process metrics registry (reference: armon/go-metrics as wired in
command/agent/command.go:985-1060; the timing points mirror
nomad/worker.go:162,245,282 and nomad/plan_apply.go:185,369,400).

The counterpart of `nomad_tpu.utils.metrics`: counters, gauges, timing
samples (`measure_since`, the MeasureSince analog; `timed` the
context-manager sugar) and explicit-bucket histograms, read back with
`dump` or as Prometheus text (`prometheus`), surfaced at /v1/metrics.
The per-namespace key cap is `MetricsRegistry(max_keys_per_ns=)`, else
`NOMAD_TPU_METRICS_MAX_KEYS` read at construction (the process-wide
`global_metrics` at import), else 512.
"""
from __future__ import annotations

import os
import re
import threading
import time as _time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional


_RESERVOIR = 2048

#: per-namespace key-cardinality cap (namespace = the key's first
#: dot-segment).  A runaway label (per-eval ids, per-node gauges from a
#: buggy caller) must not grow the registry without bound: past the cap
#: new keys are dropped and the `metrics.overflow` counter ticks.
#: NOMAD_TPU_METRICS_MAX_KEYS overrides.
DEFAULT_MAX_KEYS_PER_NS = 512
OVERFLOW_KEY = "metrics.overflow"


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
    """Explicit-bucket histogram: cumulative bucket counts as
    Prometheus expects, +Inf implied by total count."""
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
    def __init__(self, max_keys_per_ns: Optional[int] = None):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._samples: Dict[str, _Summary] = {}
        self._hists: Dict[str, _Histogram] = {}
        if max_keys_per_ns is None:
            try:
                max_keys_per_ns = int(os.environ.get(
                    "NOMAD_TPU_METRICS_MAX_KEYS",
                    str(DEFAULT_MAX_KEYS_PER_NS)))
            except ValueError:
                max_keys_per_ns = DEFAULT_MAX_KEYS_PER_NS
        self.max_keys_per_ns = max(int(max_keys_per_ns), 1)
        self._ns_keys: Dict[str, int] = {}   # namespace -> distinct keys

    def _admit_locked(self, key: str, table: dict) -> bool:
        """Label-explosion guard: True when `key` may be written to
        `table` — existing keys always pass, a NEW key only while its
        namespace is under the cap (otherwise the overflow counter
        ticks and the write is dropped)."""
        if key in table:
            return True
        ns = key.split(".", 1)[0]
        n = self._ns_keys.get(ns, 0)
        if n >= self.max_keys_per_ns and key != OVERFLOW_KEY:
            self._counters[OVERFLOW_KEY] = \
                self._counters.get(OVERFLOW_KEY, 0.0) + 1.0
            return False
        self._ns_keys[ns] = n + 1
        return True

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            if self._admit_locked(key, self._counters):
                self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            if self._admit_locked(key, self._gauges):
                self._gauges[key] = value

    def add_sample(self, key: str, value_s: float) -> None:
        with self._lock:
            if self._admit_locked(key, self._samples):
                self._samples.setdefault(key, _Summary()).add(value_s)

    def observe_hist(self, key: str, value: float,
                     buckets=None) -> None:
        """Explicit-bucket histogram observation.  Bucket bounds are
        fixed at first observation; a later call with different bounds
        keeps the original (bounds are config, not data)."""
        with self._lock:
            if not self._admit_locked(key, self._hists):
                return
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
            self._ns_keys.clear()

    # --------------------------------------------------------- prometheus
    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the registry —
        served at /v1/metrics?format=prometheus next to the JSON dump.
        Counters map to `counter`, gauges to `gauge`, timing samples to
        a `summary` (quantile series + _sum/_count), explicit-bucket
        histograms to `histogram` (cumulative `_bucket{le=}` series
        plus the implied +Inf).  Keys are mangled
        to the metric charset ([a-zA-Z0-9_:]); collisions after
        mangling keep the first-seen series (stable within a dump —
        both orderings are sorted)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            samples = sorted((k, s.snapshot())
                             for k, s in self._samples.items())
            hists = sorted((k, h.snapshot())
                           for k, h in self._hists.items())
        out: List[str] = []
        seen: set = set()

        def name(key: str) -> Optional[str]:
            n = re.sub(r"[^a-zA-Z0-9_:]", "_", key)
            if re.match(r"^[0-9]", n):
                n = "_" + n
            if n in seen:
                return None
            seen.add(n)
            return n

        for key, v in counters:
            n = name(key)
            if n is None:
                continue
            out.append(f"# TYPE {n} counter")
            out.append(f"{n} {_fmt(v)}")
        for key, v in gauges:
            n = name(key)
            if n is None:
                continue
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {_fmt(v)}")
        for key, snap in samples:
            n = name(key)
            if n is None:
                continue
            out.append(f"# TYPE {n} summary")
            out.append(f'{n}{{quantile="0.5"}} {_fmt(snap["p50"])}')
            out.append(f'{n}{{quantile="0.99"}} {_fmt(snap["p99"])}')
            out.append(f"{n}_sum {_fmt(snap['sum'])}")
            out.append(f"{n}_count {snap['count']}")
        for key, snap in hists:
            n = name(key)
            if n is None:
                continue
            out.append(f"# TYPE {n} histogram")
            for le, c in snap["buckets"]:
                out.append(f'{n}_bucket{{le="{_fmt(le)}"}} {c}')
            out.append(f'{n}_bucket{{le="+Inf"}} {snap["count"]}')
            out.append(f"{n}_sum {_fmt(snap['sum'])}")
            out.append(f"{n}_count {snap['count']}")
        return "\n".join(out) + "\n"


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render bare."""
    if float(v) == int(v):
        return str(int(v))
    return repr(float(v))


#: process-global registry (the go-metrics global sink analog)
global_metrics = MetricsRegistry()
