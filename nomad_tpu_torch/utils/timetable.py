"""Raft-index <-> wallclock witness table (reference: nomad/timetable.go:14).

GC thresholds are expressed in time ("older than 1h") but state is
versioned by index; the table records (index, time) witnesses so a time
cutoff maps to the newest index at-or-before it.

The counterpart of `nomad_tpu.utils.timetable`.
"""
from __future__ import annotations

import threading
import time as _time
from typing import List, Tuple


class TimeTable:
    def __init__(self, granularity_s: float = 1.0, limit: int = 8192):
        self.granularity = granularity_s
        self.limit = limit
        self._lock = threading.Lock()
        self._witnesses: List[Tuple[int, float]] = []

    def witness(self, index: int, when: float = None) -> None:
        when = _time.time() if when is None else when
        with self._lock:
            if (self._witnesses
                    and when - self._witnesses[-1][1] < self.granularity):
                # too soon for a new row: conservatively keep the older
                # index for this slot so nearest_index never attributes an
                # index to a time before it happened (reference:
                # nomad/timetable.go Witness skips within granularity)
                return
            self._witnesses.append((index, when))
            if len(self._witnesses) > self.limit:
                del self._witnesses[:len(self._witnesses) - self.limit]

    def nearest_index(self, cutoff: float) -> int:
        """Largest witnessed index whose time is <= cutoff, else 0."""
        with self._lock:
            best = 0
            for index, when in self._witnesses:
                if when <= cutoff:
                    best = index
                else:
                    break
            return best
