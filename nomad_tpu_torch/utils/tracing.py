"""Flight recorder: end-to-end eval tracing + the mesh event log.

A lightweight span layer threaded through the full eval lifecycle
(create -> admit -> broker -> worker batch -> scheduler walk -> solve ->
plan submit/apply), so ONE trace id — the eval id — yields the complete
timeline with queue-age, batch-size and shed/nack causality attached,
and the device-side wave/byte counters land on the solve span instead
of dying in bench-only JSON.  This is the learned placement scorer's
training substrate: every solve span
carries per-(group, node) candidate scores and the chosen placements,
exportable as a JSONL corpus (`FlightRecorder.corpus_rows` /
`write_corpus`, served at /v1/trace/corpus).

The counterpart of `nomad_tpu.utils.tracing`.  Design constraints:

  * explicit-parent spans — no contextvar propagation; a caller either
    passes `parent=` or uses `stage()`, which chains on the trace's
    last COMPLETED span (the recorder's own tail, still an explicit
    read, never ambient state);
  * monotonic timestamps (`time.monotonic`) with one wall anchor per
    recorder so exported spans carry both orderings;
  * bounded in-memory ring store — at most `depth` traces, oldest
    evicted whole (a trace is the eviction unit: a partial timeline is
    worse than none);
  * near-free when idle: `enabled` is checked first and every record
    call returns immediately when off (no allocation, no lock); cheap
    when on — one dict append per stage under a leaf lock.

Knobs, constructor arguments with the reference's defaults (the port
reads no environment variable; the agent configuration, ROADMAP.md
item 15, will pass the reference's `NOMAD_TPU_TRACE*` and
`NOMAD_TPU_MESH_EVENT_LOG`):
  FlightRecorder(enabled=True)   False disables recording
  FlightRecorder(depth=512)      ring depth in traces
  FlightRecorder(sink_path=None) JSONL path; completed spans append here
  FlightRecorder(sample=1.0)     sampling rate 0.0-1.0 (1.0 = every
                                 trace).  DETERMINISTIC per trace id
                                 (crc32 threshold), so a sampled eval
                                 keeps its whole timeline and reruns
                                 sample identically
  FlightRecorder(spill=8192)     the bound of the record spill
  MeshEventLog(sink_path=None)   JSONL path for the mesh event log
"""
from __future__ import annotations

import json
import threading
import time as _time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .ids import generate_uuid

DEFAULT_TRACE_DEPTH = 512
DEFAULT_MESH_EVENTS = 4096
#: bounded record spill: completed spans park here and the
#: drainer thread does the ring insert + JSONL sink write, so the solve
#: hot path never takes the recorder's main lock
DEFAULT_TRACE_SPILL = 8192


class Span:
    """One timed operation inside a trace.  Created by the recorder;
    recorded (appended to the ring + sink) when `end()` runs — a span
    abandoned mid-flight leaves no partial row."""

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
    """The disabled-recorder span: every method a no-op, shared
    singleton so the off path allocates nothing."""

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
    """Bounded in-memory trace store + optional JSONL sink.

    Traces are keyed by id (the eval id throughout the server plane);
    each holds the list of COMPLETED span rows in completion order.
    The ring evicts whole traces, oldest first, once `depth` distinct
    trace ids are held."""

    def __init__(self, depth: int = DEFAULT_TRACE_DEPTH,
                 enabled: bool = True,
                 sink_path: Optional[str] = None,
                 sample: float = 1.0,
                 spill: int = DEFAULT_TRACE_SPILL):
        self._lock = threading.Lock()
        self.sample = min(max(float(sample), 0.0), 1.0)
        # crc32 threshold over [0, 2^32): trace ids at or above it are
        # dropped whole — per-ID determinism keeps every sampled
        # timeline complete and reruns reproducible
        self._sample_cut = int(self.sample * (1 << 32))
        self.depth_limit = max(int(depth), 1)
        self.enabled = bool(enabled)
        self._sink_path = sink_path
        self._sink = None
        # trace id -> list of completed span row dicts; insertion order
        # is the eviction order (a later span on an old trace does NOT
        # refresh it — timelines age out as wholes)
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._tail: Dict[str, str] = {}      # trace id -> last span id
        self._dropped = 0
        # wall anchor: exported rows carry t_wall = anchor + monotonic
        # offset, so cross-process consumers can line traces up
        self._anchor_mono = _time.monotonic()
        self._anchor_wall = _time.time()
        # off-hot-path record spill: `end()` builds the row,
        # updates the tail pointer under the LEAF `_tail_lock` and parks
        # the row here; the lazily-started drainer thread (or the next
        # query, whichever comes first) moves it into the ring + sink
        # under `self._lock`.  Lock order is `_lock` outer, `_tail_lock`
        # inner, and the record path takes only the leaf.
        self.spill_limit = max(int(spill), 1)
        self._spill: deque = deque()
        self._spill_dropped = 0
        self._tail_lock = threading.Lock()
        self._spill_event = threading.Event()
        self._drainer: Optional[threading.Thread] = None

    # ------------------------------------------------------------- record
    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace-id sampling verdict: crc32 of the
        id against the rate threshold.  All-or-nothing per id — every
        stage of a sampled eval records, none of a dropped one."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode("utf-8", "replace"))
                & 0xFFFFFFFF) < self._sample_cut

    def span(self, trace_id: str, name: str,
             parent: Optional[str] = None, **attrs):
        """Open a span; the caller must end() it (or use `with`)."""
        if not self.enabled or not trace_id \
                or not self.sampled(trace_id):
            return NULL_SPAN
        return Span(self, trace_id, name, parent or "", attrs)

    def stage(self, trace_id: str, name: str, **attrs):
        """Open a span chained on the trace's last completed span —
        the lifecycle-stage convenience (create -> admit -> dequeue ->
        ... each parented on its predecessor)."""
        if not self.enabled or not trace_id \
                or not self.sampled(trace_id):
            return NULL_SPAN
        with self._tail_lock:
            parent = self._tail.get(trace_id, "")
        return Span(self, trace_id, name, parent, attrs)

    def event(self, trace_id: str, name: str,
              parent: Optional[str] = None, **attrs) -> None:
        """Record a zero-duration stage (chained like `stage` unless an
        explicit parent is given)."""
        if not self.enabled or not trace_id \
                or not self.sampled(trace_id):
            return
        sp = (self.span(trace_id, name, parent=parent, **attrs)
              if parent is not None else self.stage(trace_id, name,
                                                    **attrs))
        sp.end()

    def _record(self, sp: Span) -> None:
        row = {
            "trace_id": sp.trace_id, "span_id": sp.span_id,
            "parent_id": sp.parent_id, "name": sp.name,
            "t_start": sp.t_start, "t_end": sp.t_end,
            "dur_s": round(sp.t_end - sp.t_start, 9),
            "t_wall": round(self._anchor_wall
                            + (sp.t_start - self._anchor_mono), 6),
            "attrs": sp.attrs,
        }
        with self._tail_lock:
            # eager tail update: stage() parent chaining stays exact
            # even while the row itself waits in the spill queue
            self._tail[sp.trace_id] = sp.span_id
            if len(self._spill) >= self.spill_limit:
                # bounded: a storm sheds rows, never blocks the solver
                self._spill_dropped += 1
                return
            self._spill.append(row)
            if self._drainer is None:
                self._drainer = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name="trace-drain")
                self._drainer.start()
        self._spill_event.set()

    def flush(self) -> None:
        """Synchronously drain the spill queue into the ring + sink —
        after this, everything recorded-before-call is durably sunk."""
        self._drain_pending()

    def _drain_loop(self) -> None:
        while True:
            self._spill_event.wait(0.5)
            self._spill_event.clear()
            self._drain_pending()

    def _drain_pending(self) -> None:
        """Move spilled rows into the ring + sink.  Runs on the drainer
        thread AND at the top of every query path (so a reader always
        sees everything recorded before its call)."""
        with self._lock:
            while True:
                with self._tail_lock:
                    if not self._spill:
                        break
                    row = self._spill.popleft()
                self._apply_row_locked(row)
            with self._tail_lock:
                if len(self._tail) > 4 * self.depth_limit:
                    # the tail map tracks evicted traces too until trimmed
                    live = set(self._traces)
                    for tid in [t for t in self._tail if t not in live]:
                        del self._tail[tid]

    def _apply_row_locked(self, row: dict) -> None:
        spans = self._traces.get(row["trace_id"])
        if spans is None:
            while len(self._traces) >= self.depth_limit:
                self._traces.popitem(last=False)
                self._dropped += 1
            spans = self._traces[row["trace_id"]] = []
        spans.append(row)
        sink = self._sink_file_locked()
        if sink is not None:
            # single writer (the drain holds the main lock): concurrent
            # stages can't interleave bytes mid-line in the sink
            try:
                sink.write(json.dumps(row, sort_keys=True) + "\n")
                sink.flush()
            except OSError:
                pass

    def _sink_file_locked(self):
        if not self._sink_path:
            return None
        if self._sink is None:
            try:
                self._sink = open(self._sink_path, "a")
            except OSError:
                self._sink_path = None
                return None
        return self._sink

    # -------------------------------------------------------------- query
    def get(self, trace_id: str) -> Optional[List[dict]]:
        """The trace's completed spans, ordered by start time (records
        land in completion order; concurrent stages can end out of
        start order)."""
        self._drain_pending()
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                return None
            return sorted((dict(s) for s in spans),
                          key=lambda s: s["t_start"])

    def traces(self, limit: int = 50) -> List[dict]:
        """Newest-first trace summaries."""
        self._drain_pending()
        with self._lock:
            items = list(self._traces.items())[-max(int(limit), 1):]
        out = []
        for tid, spans in reversed(items):
            t0 = min(s["t_start"] for s in spans)
            t1 = max(s["t_end"] for s in spans)
            out.append({"trace_id": tid, "n_spans": len(spans),
                        "names": [s["name"] for s in spans],
                        "wall_s": round(t1 - t0, 6)})
        return out

    def stats(self) -> dict:
        self._drain_pending()
        with self._lock:
            with self._tail_lock:
                spill_dropped = self._spill_dropped
            return {"enabled": self.enabled,
                    "sample": self.sample,
                    "traces": len(self._traces),
                    "spans": sum(len(v) for v in self._traces.values()),
                    "depth_limit": self.depth_limit,
                    "dropped_traces": self._dropped,
                    "spill_dropped": spill_dropped}

    def reset(self) -> None:
        with self._lock:
            with self._tail_lock:
                self._spill.clear()
                self._tail.clear()
                self._spill_dropped = 0
            self._traces.clear()
            self._dropped = 0

    # ------------------------------------------------------------- corpus
    def corpus_rows(self) -> List[dict]:
        """The learned-scorer training substrate: one
        row per recorded placement decision, flattened from the solve
        spans — per-eval features, the candidate (group, node) score
        window, the chosen placement.  Failed placements ride along
        with node_id "" (negative examples are training signal too)."""
        self._drain_pending()
        with self._lock:
            traces = [(tid, list(spans))
                      for tid, spans in self._traces.items()]
        rows: List[dict] = []
        for tid, spans in traces:
            queue_age = batch_size = None
            for s in spans:
                if s["name"] == "broker.dequeue":
                    queue_age = s["attrs"].get("queue_age_s")
                elif s["name"] == "worker.batch":
                    batch_size = s["attrs"].get("batch_size")
            for s in spans:
                if s["name"] != "solve":
                    continue
                a = s["attrs"]
                for p in a.get("placements", ()):
                    rows.append({
                        "eval_id": tid,
                        "job_id": a.get("job_id", ""),
                        "group": p.get("group", ""),
                        "node_id": p.get("node_id", ""),
                        "score": p.get("score", 0.0),
                        "candidates": p.get("candidates", []),
                        "features": p.get("features", {}),
                        "evicted": p.get("evicted", []),
                        "queue_age_s": queue_age,
                        "batch_size": batch_size,
                        "fused": a.get("fused", False),
                        "solve_wall_s": s["dur_s"],
                        "t_wall": s["t_wall"],
                    })
        return rows

    def write_corpus(self, path: str) -> int:
        """Write the corpus as JSONL; returns the row count."""
        rows = self.corpus_rows()
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        return len(rows)


class MeshEventLog:
    """Persistent log of elastic-mesh transitions
    (grow/shrink/move/fail/recover) with measured reshard/recovery bytes
    and durations, the serving tier's `slo.burn` trips and the region.*
    federation events (see region_table) — the /v1/agent/events
    surface.  Bounded ring; an optional JSONL sink (`sink_path`) makes
    it durable."""

    def __init__(self, depth: int = DEFAULT_MESH_EVENTS,
                 sink_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(int(depth), 1))
        self._seq = 0
        self._sink_path = sink_path
        self._sink = None

    def record(self, kind: str, **attrs) -> dict:
        ev = {"seq": 0, "kind": kind, "t_wall": round(_time.time(), 6),
              "t_mono": _time.monotonic(), **attrs}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
            sink = self._sink_file_locked()
            if sink is not None:
                try:
                    sink.write(json.dumps(ev, sort_keys=True) + "\n")
                    sink.flush()
                except OSError:
                    pass
        return ev

    def _sink_file_locked(self):
        if not self._sink_path:
            return None
        if self._sink is None:
            try:
                self._sink = open(self._sink_path, "a")
            except OSError:
                self._sink_path = None
                return None
        return self._sink

    def events(self, limit: int = 256, kind: Optional[str] = None,
               since_seq: int = 0) -> List[dict]:
        """Newest-last events (the natural replay order).  `since_seq`
        is the poller cursor: only events with seq STRICTLY
        above it return, so `since_seq=last_seen` re-reads nothing —
        seq is monotone and ring eviction only ever drops the low
        end."""
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
        # __len__ alone would make an EMPTY log falsy, so
        # `if event_log:` presence checks silently skip recording on
        # the first event of a fresh log; a log object is always
        # truthy — emptiness is `len(log) == 0`
        return True


#: process-global recorder + mesh event log (the go-metrics-style
#: global sink analog; servers and solvers share them so one HTTP
#: surface serves every component's telemetry)
global_tracer = FlightRecorder()
global_mesh_events = MeshEventLog()
