"""Cluster health plane: the server's telemetry beat.

The counterpart of `nomad_tpu.telemetry`:

  * `health` — fleet health counters and their numpy reduction over the
    resident template (the device kernel is ROADMAP.md Queue 1, item 9).
  * `series` — bounded multi-resolution time-series rings (1s/10s/60s
    with min/max/sum/count downsampling).
  * `slo` — multi-window error-budget burn-rate alerting for the
    serving tier.
"""
from .health import HealthCounters, MAX_DC, N_EDGES, UTIL_EDGES, health_host
from .series import DEFAULT_RESOLUTIONS, TimeSeriesStore, global_series
from .slo import SloBurnTracker

__all__ = [
    "DEFAULT_RESOLUTIONS", "HealthCounters", "MAX_DC", "N_EDGES",
    "SloBurnTracker", "TimeSeriesStore", "UTIL_EDGES", "global_series",
    "health_host",
]
