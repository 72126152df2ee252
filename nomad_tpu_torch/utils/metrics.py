"""In-process metrics registry (reference: armon/go-metrics as wired in
command/agent/command.go:985-1060).

The counterpart of `nomad_tpu.utils.metrics`, reduced to what the
scheduler path calls: counters (`incr_counter`), read back with `dump`.
The counters in use: `scheduler.preempt.host_fallback` (the host-side
preemption pass) and the solver's resident world,
`solver.resident.rebuild` (a full repack of the world) and
`solver.resident.delta_sync` (a change-log sync).  Not here yet: gauges,
timing samples, histograms, the Prometheus exposition and the
per-namespace key cap (`NOMAD_TPU_METRICS_MAX_KEYS`), which serve the
server plane and the HTTP API.
"""
from __future__ import annotations

import threading
from typing import Dict


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    def incr_counter(self, key: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def dump(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters)}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


#: process-global registry (the go-metrics global sink analog)
global_metrics = MetricsRegistry()
