"""Eval tracing: the span layer the scheduler writes its stages into.

The counterpart of `nomad_tpu.utils.tracing`, reduced to what the
scheduler path calls: `global_tracer.stage` / `.event`, a span's `set` /
`end`, and `NULL_SPAN`.  One trace id (the eval id) collects its
completed spans in order; `stage()` parents a span on the trace's last
completed one, as the reference does.  Completed spans are kept in a
bounded in-memory ring of traces (oldest trace evicted whole) and read
back with `get`.

Not here yet (the reference's flight recorder beyond this): spans with
an explicit parent, per-id sampling, the off-thread spill drainer, the
JSONL sink, queries beyond `get`, the learned-scorer corpus export and
the mesh event log, and the reference's knobs (recording on/off and
the ring depth from the environment): recording is always on here, at
a fixed depth of `TRACE_DEPTH` traces.
"""
from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import Dict, List, Optional

from .ids import generate_uuid

#: ring depth in traces (the reference's default)
TRACE_DEPTH = 512


class Span:
    """One timed operation inside a trace, recorded when `end()` runs (a
    span abandoned mid-flight leaves no row)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t_start", "t_end", "attrs", "_rec")

    def __init__(self, rec: Optional["FlightRecorder"], trace_id: str,
                 name: str, parent_id: str, attrs: Dict):
        self._rec = rec
        self.trace_id = trace_id
        self.span_id = generate_uuid()[:12]
        self.parent_id = parent_id
        self.name = name
        self.t_start = _time.monotonic()
        self.t_end = 0.0
        self.attrs = dict(attrs)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> None:
        if self._rec is None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.t_end = _time.monotonic()
        rec, self._rec = self._rec, None     # record exactly once
        rec._record(self)


class _NullSpan:
    """The span of an untraced call (no trace id): every method a no-op,
    one shared instance so that path allocates nothing."""

    __slots__ = ()
    trace_id = span_id = parent_id = name = ""
    attrs: Dict = {}

    def set(self, **attrs):
        return self

    def end(self, **attrs) -> None:
        return None


NULL_SPAN = _NullSpan()


class FlightRecorder:
    """Bounded in-memory trace store: trace id -> completed span rows in
    completion order; at most `TRACE_DEPTH` traces, oldest evicted
    whole."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._tail: Dict[str, str] = {}      # trace id -> last span id

    def stage(self, trace_id: str, name: str, **attrs):
        """Open a span parented on the trace's last completed span; the
        caller must end() it."""
        if not trace_id:
            return NULL_SPAN
        with self._lock:
            parent = self._tail.get(trace_id, "")
        return Span(self, trace_id, name, parent, attrs)

    def event(self, trace_id: str, name: str, **attrs) -> None:
        """Record a zero-duration stage, chained like `stage`."""
        self.stage(trace_id, name, **attrs).end()

    def _record(self, sp: Span) -> None:
        row = {"trace_id": sp.trace_id, "span_id": sp.span_id,
               "parent_id": sp.parent_id, "name": sp.name,
               "t_start": sp.t_start, "t_end": sp.t_end,
               "dur_s": round(sp.t_end - sp.t_start, 9),
               "attrs": sp.attrs}
        with self._lock:
            self._tail[sp.trace_id] = sp.span_id
            spans = self._traces.get(sp.trace_id)
            if spans is None:
                while len(self._traces) >= TRACE_DEPTH:
                    old, _ = self._traces.popitem(last=False)
                    self._tail.pop(old, None)
                spans = self._traces[sp.trace_id] = []
            spans.append(row)

    def get(self, trace_id: str) -> Optional[List[dict]]:
        """The trace's completed spans, ordered by start time."""
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                return None
            return sorted((dict(s) for s in spans),
                          key=lambda s: s["t_start"])


#: process-global recorder (the scheduler's trace sink)
global_tracer = FlightRecorder()
