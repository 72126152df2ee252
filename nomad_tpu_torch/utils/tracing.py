"""Eval tracing: the span layer the server plane and the scheduler write
their stages into, and the event log of notable transitions.

The counterpart of `nomad_tpu.utils.tracing`.  One trace id (the eval
id) collects its completed spans; `stage()` parents a span on the
trace's last completed one, `span()` takes an explicit parent.
Completed spans are kept in a bounded in-memory ring of traces (oldest
trace evicted whole) and read back with `get`.  `MeshEventLog` is the
bounded, sequence-numbered event log (the serving tier's SLO burn
alerts land there; the server's telemetry beat reads its rate; the
federation's `region.*` events replay into `region_table`).

Not here yet (ROADMAP.md Queue 1, item 5): per-id sampling, the
off-thread spill drainer, the JSONL sinks, queries beyond `get`, the
learned-scorer corpus export, and the reference's knobs (recording on/off and the ring depth from the
environment): recording is always on here, at a fixed depth of
`TRACE_DEPTH` traces.
"""
from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .ids import generate_uuid

#: ring depth in traces (the reference's default)
TRACE_DEPTH = 512
#: event-log ring depth (the reference's default)
MESH_EVENTS_DEPTH = 4096


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

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()


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

    def __enter__(self):
        return self

    def __exit__(self, *a) -> None:
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

    def span(self, trace_id: str, name: str,
             parent: Optional[str] = None, **attrs):
        """Open a span under an explicit parent; the caller must end()
        it (or use `with`)."""
        if not trace_id:
            return NULL_SPAN
        return Span(self, trace_id, name, parent or "", attrs)

    def stage(self, trace_id: str, name: str, **attrs):
        """Open a span parented on the trace's last completed span; the
        caller must end() it."""
        if not trace_id:
            return NULL_SPAN
        with self._lock:
            parent = self._tail.get(trace_id, "")
        return Span(self, trace_id, name, parent, attrs)

    def event(self, trace_id: str, name: str,
              parent: Optional[str] = None, **attrs) -> None:
        """Record a zero-duration stage (chained like `stage` unless an
        explicit parent is given)."""
        sp = (self.span(trace_id, name, parent=parent, **attrs)
              if parent is not None else self.stage(trace_id, name,
                                                    **attrs))
        sp.end()

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


class MeshEventLog:
    """Bounded, sequence-numbered log of notable transitions (the
    reference's /v1/agent/events surface): the serving tier's `slo.burn`
    trips and clears land here."""

    def __init__(self, depth: int = MESH_EVENTS_DEPTH):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(int(depth), 1))
        self._seq = 0

    def record(self, kind: str, **attrs) -> dict:
        ev = {"seq": 0, "kind": kind, "t_wall": round(_time.time(), 6),
              "t_mono": _time.monotonic(), **attrs}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
        return ev

    def events(self, limit: int = 256, kind: Optional[str] = None,
               since_seq: int = 0) -> List[dict]:
        """Newest-last events with seq strictly above `since_seq`."""
        with self._lock:
            evs = list(self._events)
        if since_seq:
            evs = [e for e in evs if e["seq"] > since_seq]
        if kind:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-max(int(limit), 1):]

    @property
    def last_seq(self) -> int:
        """The newest assigned cursor (0 = nothing recorded yet)."""
        with self._lock:
            return self._seq

    def region_table(self) -> dict:
        """Federation membership replayed from the region.* events:
        region -> {"members": [...], "state": "up"|"left"
        |"degraded"}.  region.join adds (member joins when the event
        names one; node-universe joins from CrossRegionResidentSolver
        carry none), region.fail removes a member, region.leave marks
        the region gone, region.degraded/.recovered flip the mesh
        health — the WAN-gossip view a /v1/regions surface serves."""
        with self._lock:
            evs = list(self._events)
        table: dict = {}
        degraded: Optional[str] = None
        for ev in evs:
            kind = ev.get("kind", "")
            if not kind.startswith("region."):
                continue
            region = ev.get("region")
            if kind == "region.recovered":
                if degraded is not None and degraded in table:
                    table[degraded]["state"] = "up"
                degraded = None
                continue
            if region is None:
                continue
            row = table.setdefault(
                region, {"members": set(), "state": "up"})
            if kind == "region.join":
                row["state"] = "up"
                if ev.get("member"):
                    row["members"].add(ev["member"])
            elif kind == "region.fail":
                row["members"].discard(ev.get("member"))
            elif kind == "region.leave":
                row["state"] = "left"
            elif kind == "region.degraded":
                row["state"] = "degraded"
                degraded = region
        return {r: {"members": sorted(row["members"]),
                    "state": row["state"]}
                for r, row in table.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __bool__(self) -> bool:
        # __len__ alone would make an EMPTY log falsy, so an
        # `if event_log:` presence check would skip a fresh log
        return True


#: process-global recorder and event log (the scheduler's and the
#: server plane's trace sinks)
global_tracer = FlightRecorder()
global_mesh_events = MeshEventLog()
