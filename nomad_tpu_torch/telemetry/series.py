"""Multi-resolution time-series rings with downsampling rollover.

`TimeSeriesStore` keeps, per series name, one fixed-size ring per
resolution (1s / 10s / 60s by default).  A `record(name, value)` lands
in the current 1s bucket; when the wall clock crosses a bucket
boundary the finalized point (min / max / sum / count over the bucket)
is pushed into the 1s ring AND merged into the current 10s bucket,
which rolls over into the 60s ring the same way.  Memory is bounded:
ring lengths are fixed at construction, the name universe is capped
(overflow recorded in a counter), and a point is a 5-tuple — no
per-sample retention.

The counterpart of `nomad_tpu.telemetry.series`, without its JSONL sink
of finalized points (`open_sink`; ROADMAP.md Queue 1, item 5).

Clock is injected (`clock=time.monotonic` default) so the rollover
tests drive time explicitly, like every other timed component here.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: (resolution_seconds, ring_length) — 2h of 1s, ~5.5h of 10s, 24h of
#: 60s; ~7200 + 2000 + 1440 points * 5 floats per name, worst case.
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int], ...] = (
    (1, 7200), (10, 2000), (60, 1440))

#: series-name admission cap (same spirit as MetricsRegistry's
#: per-namespace cap): past it, records land in the overflow counter
#: instead of growing memory.
DEFAULT_MAX_NAMES = 256

OVERFLOW_NAME = "telemetry.series_overflow"


class _Bucket:
    __slots__ = ("start", "mn", "mx", "sum", "count")

    def __init__(self, start: int):
        self.start = start
        self.mn = float("inf")
        self.mx = float("-inf")
        self.sum = 0.0
        self.count = 0

    def add(self, v: float) -> None:
        if v < self.mn:
            self.mn = v
        if v > self.mx:
            self.mx = v
        self.sum += v
        self.count += 1

    def merge(self, p: Tuple) -> None:
        # p = (t, mn, mx, sum, count) — a finalized finer-grain point
        if p[1] < self.mn:
            self.mn = p[1]
        if p[2] > self.mx:
            self.mx = p[2]
        self.sum += p[3]
        self.count += p[4]

    def point(self) -> Tuple[int, float, float, float, int]:
        return (self.start, self.mn, self.mx, self.sum, self.count)


class _Ring:
    """Fixed-capacity append ring of finalized points."""
    __slots__ = ("cap", "buf", "head", "n")

    def __init__(self, cap: int):
        self.cap = cap
        self.buf: List = [None] * cap
        self.head = 0
        self.n = 0

    def push(self, p) -> None:
        self.buf[self.head] = p
        self.head = (self.head + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def points(self) -> List:
        if self.n < self.cap:
            return [p for p in self.buf[:self.n]]
        return self.buf[self.head:] + self.buf[:self.head]


class _Series:
    __slots__ = ("rings", "cur")

    def __init__(self, resolutions):
        self.rings = [_Ring(cap) for _, cap in resolutions]
        self.cur: List[Optional[_Bucket]] = [None] * len(resolutions)


class TimeSeriesStore:
    """Thread-safe multi-resolution ring store (tentpole b)."""

    def __init__(self,
                 resolutions: Sequence[Tuple[int, int]] =
                 DEFAULT_RESOLUTIONS,
                 max_names: int = DEFAULT_MAX_NAMES,
                 clock=time.monotonic):
        res = sorted(resolutions)
        if not res or any(r <= 0 or cap <= 0 for r, cap in res):
            raise ValueError(f"bad resolutions: {resolutions}")
        for (ra, _), (rb, _) in zip(res, res[1:]):
            if rb % ra != 0:
                raise ValueError(
                    f"resolutions must nest (each a multiple of the "
                    f"previous): {resolutions}")
        self.resolutions = tuple(res)
        self.max_names = max_names
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._overflow = 0

    # ------------------------------------------------------ recording
    def record(self, name: str, value: float,
               now: Optional[float] = None) -> None:
        t = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self.max_names and \
                        name != OVERFLOW_NAME:
                    self._overflow += 1
                    return
                s = self._series[name] = _Series(self.resolutions)
            self._roll_locked(s, t)
            b = s.cur[0]
            if b is None:
                b = s.cur[0] = _Bucket(
                    int(t) // self.resolutions[0][0]
                    * self.resolutions[0][0])
            b.add(float(value))

    def _roll_locked(self, s: _Series, t: float) -> None:
        """Finalize any current buckets the clock has moved past,
        cascading each finalized point into the next resolution."""
        carry = None
        for i, (res, _cap) in enumerate(self.resolutions):
            b = s.cur[i]
            if carry is not None:
                if b is None:
                    b = s.cur[i] = _Bucket(
                        carry[0] // res * res)
                b.merge(carry)
            carry = None
            if b is not None and int(t) // res * res > b.start:
                p = b.point()
                s.rings[i].push(p)
                s.cur[i] = None
                carry = p

    def flush(self, now: Optional[float] = None) -> None:
        """Finalize every in-progress bucket (shutdown / test hook)."""
        t = self._clock() if now is None else now
        with self._lock:
            for s in self._series.values():
                # nudge past every resolution's bucket end
                self._roll_locked(s, t + self.resolutions[-1][0])

    # -------------------------------------------------------- reading
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, name: str, res: int = 1,
               since: float = 0.0) -> List[Dict]:
        """Finalized points for one series at one resolution, oldest
        first, bucket start > `since` (the HTTP cursor)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            for i, (r, _cap) in enumerate(self.resolutions):
                if r == int(res):
                    pts = s.rings[i].points()
                    break
            else:
                raise KeyError(f"no ring at resolution {res}s "
                               f"(have {[r for r, _ in self.resolutions]})")
        return [{"t": p[0], "min": p[1], "max": p[2], "sum": p[3],
                 "count": p[4],
                 "mean": (p[3] / p[4] if p[4] else 0.0)}
                for p in pts if p is not None and p[0] > since]

    def stats(self) -> Dict:
        with self._lock:
            return {"names": len(self._series),
                    "overflow": self._overflow,
                    "resolutions": [list(rc)
                                    for rc in self.resolutions]}


#: process-wide store, mirroring global_metrics / global_tracer.
global_series = TimeSeriesStore()
