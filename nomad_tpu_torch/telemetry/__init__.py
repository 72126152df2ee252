"""Cluster health plane: the server's telemetry beat.

The counterpart of `nomad_tpu.telemetry`:

  * `health` — fleet health counters: the device reduction over a
    streaming `ResidentSolver`'s planes (`device_health_counters`) and
    its numpy twin over the resident template (`health_host`).
  * `series` — bounded multi-resolution time-series rings (1s/10s/60s
    with min/max/sum/count downsampling), with an optional JSONL sink
    of finalized points (`open_sink`).
  * `slo` — multi-window error-budget burn-rate alerting for the
    serving tier.
"""
from .health import (HealthCounters, MAX_DC, N_EDGES, UTIL_EDGES,
                     device_health_counters, health_host)
from .series import (DEFAULT_RESOLUTIONS, TimeSeriesStore, global_series,
                     open_sink)
from .slo import SloBurnTracker

__all__ = [
    "DEFAULT_RESOLUTIONS", "HealthCounters", "MAX_DC", "N_EDGES",
    "SloBurnTracker", "TimeSeriesStore", "UTIL_EDGES",
    "device_health_counters", "global_series", "health_host",
    "open_sink",
]
