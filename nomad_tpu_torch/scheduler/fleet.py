"""Fleet solve: fuse a batch of evals into ONE device solve.

This is the accelerator recast of the reference's optimistic worker concurrency
(SURVEY §2.5): where the reference runs N goroutines each solving one
eval against its own snapshot — conflicts surfacing only at the plan
applier — this path drains up to K ready evals (one per job, by broker
construction), reconciles each on the host, and solves ALL their
placements in a single kernel invocation. Placements from different evals
see each other inside the solve (the scan's shared `used` carry), so
intra-batch plan conflicts largely vanish instead of being retried.

Shared world note: the packed usage comes from the common snapshot;
capacity freed by an eval's own stops becomes visible only after its plan
commits. An eval that fails a placement or partially commits falls back
to the single-eval path, which sees its stops.

The counterpart of `nomad_tpu.scheduler.fleet`.  `form_lanes` and
`LaneWidthController` feed the lane stream of the streaming
`solver.resident.ResidentSolver` (`lanes=`, `lane_counters()`), and
the serving tier's lane knobs configure the controller
(`ServingTier.lane_controller()`); as in the reference, the server
builds its coordinator without a lane former (ROADMAP.md Queue 1 item
21).
"""
from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from ..structs import (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED, Allocation,
                       Evaluation, JOB_TYPE_BATCH, JOB_TYPE_SERVICE)
from .generic import GenericScheduler, _VALID_TRIGGERS

#: hard ceiling on evals fused into one coordinator round — beyond
#: this the ask tensor gets big enough that solve wall grows past the
#: SLO budget the BatchController sized the member batches for
DEFAULT_MAX_FUSED = 128

#: per-round wall breakdown stages.  `dequeue` is recorded
#: by the worker loop (the broker wait isn't visible here); the fleet
#: phases record the rest.  `device` is the union of in-order device
#: intervals — under pipelining it overlaps reconcile/pack of the next
#: round, so the stages deliberately do NOT sum to round wall.
ROUND_STAGES = ("dequeue", "reconcile", "pack", "dispatch", "device",
                "fetch", "plan_build", "apply")


def record_stage_metrics(stages: Dict[str, float],
                         prefix: str = "coordinator.stage") -> None:
    """Publish one round's stage breakdown as metrics histograms
    (explicit latency buckets)."""
    from ..utils.metrics import global_metrics as _m
    for name, v in stages.items():
        _m.observe_hist(f"{prefix}.{name}_s", float(v))


def form_lanes(members: List, width: int, key_fn) -> List:
    """Conflict-aware chunk formation: order `members` so
    that every consecutive `width`-block — one lane chunk of the
    chunked scan-of-vmap — holds members with pairwise-disjoint
    conflict footprints wherever the workload allows.

    `key_fn(member)` returns the member's footprint: an iterable of
    hashable atoms (candidate-shortlist node ids, (dc, zone) pins,
    namespace keys — whatever the caller can compute cheaply).  Two
    members conflict when their footprints intersect; conflicting
    members sharing a chunk solve against the same stale usage
    snapshot and bounce at the cross-lane revalidation, so the former
    keeps them in DIFFERENT chunks — serialized through the scan
    carry — and fills each chunk from one independent set.

    Greedy first-fit coloring: each color class keeps the union of
    its members' footprints, and a member joins the first class whose
    union it does not touch (disjoint-from-union implies pairwise
    disjoint).  Classes then emit whole chunks; ragged tails are
    re-packed across classes with the same disjointness check, so
    conflicting tails serialize instead of sharing a chunk.  Pure
    reorder: the result is a permutation of `members`, never a
    drop — a bounced lane is a retry, a dropped member is a lost
    eval."""
    if width <= 1 or len(members) <= width:
        return list(members)
    classes: List[List] = []          # [union_footprint, [members]]
    keys: Dict[int, frozenset] = {}
    for m in members:
        ks = frozenset(key_fn(m))
        keys[id(m)] = ks
        for cl in classes:
            if not (cl[0] & ks):
                cl[0] |= ks
                cl[1].append(m)
                break
        else:
            classes.append([set(ks), [m]])
    out: List = []
    tails: List = []
    for _uni, group in classes:
        n_full = (len(group) // width) * width
        out.extend(group[:n_full])
        tails.extend(group[n_full:])
    while tails:
        chunk: List = []
        uni: set = set()
        rest: List = []
        for m in tails:
            ks = keys[id(m)]
            if len(chunk) < width and not (uni & ks):
                chunk.append(m)
                uni |= ks
            else:
                rest.append(m)
        out.extend(chunk)
        tails = rest
    return out


class LaneWidthController:
    """Adaptive lane width for the chunked scan-of-vmap:
    pow2 widths in [1, max_width], one step per observation.

    Fed by the two signals the issue names: the measured cross-lane
    bounce rate (ResidentSolver.lane_counters) and the coordinator's stage
    accounting (is `device` still the dominant stage?).  Widen when
    lanes are winning — bounce below `widen_below` AND the device
    stage dominant, so more in-kernel parallelism attacks the actual
    bottleneck; narrow when revalidation bounces above `narrow_above`
    — a bounced lane re-solves through the retry path, so a high
    bounce rate makes wide chunks slower than the serial depth they
    save.  `patience` consecutive agreeing rounds are required per
    step (hysteresis: one conflicted round must not collapse L), and
    any disagreeing round resets the streak."""

    def __init__(self, max_width: int = 8, start: int = 2,
                 widen_below: float = 0.05, narrow_above: float = 0.25,
                 patience: int = 2):
        self.max_width = max(1, int(max_width))
        self.width = min(max(1, int(start)), self.max_width)
        self.widen_below = float(widen_below)
        self.narrow_above = float(narrow_above)
        self.patience = max(1, int(patience))
        self._streak = 0          # +n widen votes, -n narrow votes
        #: observation log (bounce_rate, device_frac, width) — the
        #: bench's lane leg reports the trajectory
        self.history: List[Tuple[float, float, int]] = []

    def record(self, bounce_rate: float,
               device_frac: float = 1.0) -> int:
        """Feed one round's signals; returns the (possibly stepped)
        width to use for the next round."""
        self.history.append((float(bounce_rate), float(device_frac),
                             self.width))
        if bounce_rate > self.narrow_above:
            self._streak = min(self._streak, 0) - 1
        elif bounce_rate < self.widen_below and device_frac >= 0.5:
            self._streak = max(self._streak, 0) + 1
        else:
            self._streak = 0
        if self._streak >= self.patience and self.width < self.max_width:
            self.width <<= 1
            self._streak = 0
        elif self._streak <= -self.patience and self.width > 1:
            self.width >>= 1
            self._streak = 0
        return self.width


class _Entry:
    def __init__(self, ev: Evaluation, token: str,
                 sched: GenericScheduler):
        self.ev = ev
        self.token = token
        self.sched = sched
        self.prep = None
        self.ask_base = 0
        self.err: Optional[str] = None


class _SolveView:
    """Per-eval slice of the fused SolveOutput with rebased ask indexes."""

    def __init__(self, placements, class_eligibility):
        self.placements = placements
        self.class_eligibility = class_eligibility
        self.trace: dict = {}       # shared fused-solve counters


class _FleetRound:
    """One fused round in flight between the pipeline phases: built by
    `fleet_begin` (reconcile), armed by `fleet_dispatch` (kernel
    launch, no fetch), completed by `fleet_finish` (fetch + fan-back +
    finalize).  `stages` collects the per-round wall breakdown
    (ROUND_STAGES keys, seconds)."""

    __slots__ = ("fused", "solvable", "snapshot", "nodes", "by_dc",
                 "allocs_by_node", "all_asks", "spans", "pending",
                 "stages", "t_dispatched", "t_fetch_done")

    def __init__(self) -> None:
        self.fused: List[_Entry] = []
        self.solvable: List[_Entry] = []
        self.snapshot = None
        self.nodes: List = []
        self.by_dc: Dict[str, int] = {}
        self.allocs_by_node = {}
        self.all_asks: List = []
        self.spans: Dict[str, object] = {}
        self.pending = None          # PendingSolve once dispatched
        self.stages: Dict[str, float] = {}
        self.t_dispatched = 0.0
        self.t_fetch_done = 0.0


def fleet_begin(server, worker, batch: List[Tuple[Evaluation, str]]
                ) -> Optional[_FleetRound]:
    """Reconcile phase: pause redeliveries, peel off evals the fused
    path can't carry (single-eval processed inline), build the shared
    world ONCE, and run every member's reconcile + ask assembly against
    it.  Returns None when nothing is left to fuse."""
    t0 = _time.perf_counter()
    # the fused pass can outlive the nack timeout for tail-of-batch
    # evals; hold the timers while we own the batch (explicit ack/nack
    # follows) — one lock hold per touched shard, not per eval
    server.broker.pause_nack_batch([(ev.id, tok) for ev, tok in batch])

    fused: List[_Entry] = []
    for ev, token in batch:
        if ev.type not in (JOB_TYPE_SERVICE, JOB_TYPE_BATCH) \
                or ev.triggered_by not in _VALID_TRIGGERS:
            worker._process(ev, token)
            continue
        fused.append(_Entry(ev, token, GenericScheduler(
            server.store, worker, batch=(ev.type == JOB_TYPE_BATCH),
            solver=worker.fleet_solver())))
    if not fused:
        return None

    rnd = _FleetRound()
    rnd.fused = fused
    wait_index = max(max(e.ev.modify_index, e.ev.snapshot_index)
                     for e in fused)
    server.store.wait_for_index(wait_index, timeout=5.0)
    snapshot = server.store.snapshot()
    rnd.snapshot = snapshot

    # one shared world for the whole batch — including the node-id map
    # and dc counts every member's prepare pass reads (the per-eval
    # rebuild of node_by_id over a 2k-node list was pure burn)
    nodes = [n for n in snapshot.nodes() if n.ready()]
    rnd.nodes = nodes
    node_by_id = {n.id: n for n in nodes}
    by_dc: Dict[str, int] = {}
    for n in nodes:
        by_dc[n.datacenter] = by_dc.get(n.datacenter, 0) + 1
    rnd.by_dc = by_dc
    allocs_by_node: Dict[str, List[Allocation]] = {}
    for n in nodes:
        live = [a for a in snapshot.allocs_by_node(n.id)
                if not a.terminal_status()]
        if live:
            allocs_by_node[n.id] = live
    rnd.allocs_by_node = allocs_by_node

    all_asks: List = []
    for e in fused:
        try:
            missing, err = e.sched._begin(e.ev, snapshot)
        except Exception as exc:
            e.err = f"scheduler error: {exc}"
            continue
        if err is not None:
            e.err = err
            continue
        if missing:
            # restrict to this job's datacenters via the ask's dc mask —
            # the shared node list spans all DCs
            prep = e.sched._prepare_placements(
                snapshot, missing, nodes=nodes, by_dc=by_dc,
                allocs_by_node=allocs_by_node, node_by_id=node_by_id)
            if prep is not None:
                _nodes, _by_dc, _abn, asks, ask_missing = prep
                e.prep = (missing, ask_missing)
                e.ask_base = len(all_asks)
                all_asks.extend(asks)
                rnd.solvable.append(e)
    rnd.all_asks = all_asks
    rnd.stages["reconcile"] = _time.perf_counter() - t0
    return rnd


def fleet_dispatch(server, worker, rnd: _FleetRound) -> None:
    """Dispatch phase: launch the fused kernel WITHOUT fetching.  After
    this returns the device is solving and the leader is free to
    reconcile the next round."""
    if not rnd.all_asks:
        return
    solvable = rnd.solvable
    snapshot = rnd.snapshot
    # fleet-mode proposed corrections: the shared world carries no
    # stop exclusions (capacity freed by an eval's own stops lands
    # after its plan commits — see module note); sticky probes from
    # every fused eval overlay the resident world's usage
    probes = [p for e in solvable for p in e.sched._sticky_probes]
    # in-kernel preemption only when EVERY fused eval's scheduler
    # type has it enabled (the pass can't gate per ask beyond the
    # priority delta); mixed configs keep the host-side fallback
    from .preemption import preemption_enabled
    cfg = snapshot.scheduler_config()
    preempt_ok = all(
        preemption_enabled(cfg, "batch" if e.sched.batch
                           else "service")
        for e in solvable)
    # one fused device solve, one solve span PER member trace: each
    # eval's timeline stays self-contained, the shared counters
    # (and fused_batch size) tie the members back together
    from ..utils.tracing import global_tracer as _tr
    for e in solvable:
        rnd.spans[e.ev.id] = _tr.stage(
            e.ev.id, "solve", job_id=e.ev.job_id, fused=True,
            fused_batch=len(solvable))
    rnd.pending = worker.fleet_solver().solve_async(
        rnd.nodes, rnd.all_asks, rnd.allocs_by_node, rnd.by_dc,
        snapshot=snapshot, proposed_delta=([], probes),
        preempt=preempt_ok)
    rnd.t_dispatched = rnd.pending.t_dispatched
    rnd.stages["pack"] = rnd.pending.pack_wall_s
    rnd.stages["dispatch"] = rnd.pending.dispatch_wall_s


def fleet_finish(server, worker, rnd: _FleetRound,
                 prev_fetch_done: float = 0.0) -> None:
    """Fetch + fan-back + finalize phase: block on the device result,
    slice it back to the member evals in ONE pass, finalize and
    ack/nack.  `prev_fetch_done` (pipelining): the previous round's
    fetch-completion stamp, so device time is accounted as the union of
    in-order device intervals rather than double-counted overlap."""
    out = None
    if rnd.pending is not None:
        out = rnd.pending.wait()
        rnd.t_fetch_done = _time.perf_counter()
        rnd.stages["fetch"] = rnd.pending.fetch_wall_s
        # device busy: this round's interval clipped to start after the
        # previous round's fetch completed (in-order execution)
        rnd.stages["device"] = max(
            0.0, rnd.t_fetch_done - max(rnd.t_dispatched,
                                        prev_fetch_done))
        serving = getattr(server, "serving", None)
        if serving is not None:
            # sizing-model feed: device time, NOT round wall — see
            # ServingTier.note_device_solve for why wall over-drains
            # the close rule under pipelining
            serving.note_device_solve(len(rnd.fused),
                                      rnd.stages["device"])

    snapshot = rnd.snapshot
    if out is not None and rnd.solvable:
        t0 = _time.perf_counter()
        # single-pass fan-back: each placement belongs to exactly one
        # member (ask ranges partition the fused ask list), so rebase
        # ask_index in place and bucket by owner — the old O(E*P) scan
        # with a copy per match dominated plan build at batch 128
        owner: List[int] = []
        for i, e in enumerate(rnd.solvable):
            owner.extend([i] * len(e.prep[1]))
        local: List[List] = [[] for _ in rnd.solvable]
        for p in out.placements:
            i = owner[p.ask_index]
            p.ask_index -= rnd.solvable[i].ask_base
            local[i].append(p)
        stage_attrs = {f"stage_{k}_s": round(v, 6)
                       for k, v in rnd.stages.items()}
        for i, e in enumerate(rnd.solvable):
            missing, ask_missing = e.prep
            base, n_local = e.ask_base, len(e.prep[1])
            view = _SolveView(
                local[i], out.class_eligibility[base:base + n_local])
            view.trace = dict(out.trace)
            view.trace.update(stage_attrs)
            e.sched._consume_solve(snapshot, view, rnd.nodes,
                                   rnd.allocs_by_node, missing,
                                   ask_missing,
                                   span=rnd.spans.get(e.ev.id))
        rnd.stages["plan_build"] = _time.perf_counter() - t0

    # finalize each eval; anything incomplete replays on the single path
    t0 = _time.perf_counter()
    acks: List[Tuple[str, str]] = []
    for e in rnd.fused:
        if e.err is not None:
            e.sched._set_status(EVAL_STATUS_FAILED, str(e.err))
            server.broker.nack(e.ev.id, e.token)
            continue
        try:
            done, err = e.sched._finalize({"made": False})
        except Exception as exc:
            done, err = False, f"finalize error: {exc}"
        if err is not None:
            e.sched._set_status(EVAL_STATUS_FAILED, str(err))
            server.broker.nack(e.ev.id, e.token)
        elif done:
            e.sched._set_status(EVAL_STATUS_COMPLETE, "")
            acks.append((e.ev.id, e.token))
        else:
            # partial commit / refresh: the single-eval retry loop owns it
            worker._process(e.ev, e.token)
    if acks:
        server.broker.ack_batch(acks)
    rnd.stages["apply"] = _time.perf_counter() - t0
    record_stage_metrics(rnd.stages)


def process_fleet(server, worker, batch: List[Tuple[Evaluation, str]]
                  ) -> None:
    """Process a dequeued eval batch with one fused solve. `worker` is the
    Planner handed to each scheduler and the fallback single-eval
    processor for anything the fused path can't finish.  Serialized
    composition of the three pipeline phases — the coordinator overlaps
    them across rounds instead."""
    rnd = fleet_begin(server, worker, batch)
    if rnd is None:
        return
    fleet_dispatch(server, worker, rnd)
    fleet_finish(server, worker, rnd)


class _FusedSubmission:
    """One worker's bulk batch parked on the coordinator: the worker
    blocks on `done` while the drain leader solves it (possibly fused
    with other workers' batches)."""

    __slots__ = ("worker", "batch", "done", "error")

    def __init__(self, worker, batch):
        self.worker = worker
        self.batch = batch
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class SolveCoordinator:
    """Cross-worker solve fusion: N dequeue workers submit
    their bulk batches here instead of each running its own
    process_fleet — the first submitter becomes the drain leader,
    coalesces every queued submission into ONE combined batch, and runs
    the existing process_fleet path on a single pinned solver, so the
    device sees one big wave instead of N serialized small ones.
    Non-leaders park on a per-batch future.

    Lock discipline: `self._lock` guards only the queue/role flags and
    is NEVER held across the device solve or a submission wait — a
    submitter holding it through `done.wait()` would deadlock the drain
    leader trying to pick its batch up.

    PIPELINING: the drain leader runs the solve as three
    phases (fleet_begin -> fleet_dispatch -> fleet_finish) and keeps
    ONE round in flight: while round b's fused kernel solves on the
    device, the leader reconciles and dispatches round b+1 — the same
    double-buffer `solve_stream_pipelined` runs inside a single solve,
    lifted to the serving path.  Round b+1's reconcile reads a snapshot
    that does not yet include round b's uncommitted plans; that is the
    SAME optimistic-concurrency model the reference's parallel workers
    (and unpipelined fused rounds) already use — conflicts surface at the
    plan applier and replay through the single-eval retry path.
    Submitters are released only when their round's finish phase
    completes, so at-least-once eval ownership is unchanged.

    `pause()`/`resume()` is the determinism hook for tests: paused, the
    coordinator only accumulates submissions; `resume()` drains them in
    one fused round, so a test can prove fusion produces placements
    identical to serialized singles."""

    def __init__(self, server, max_fused: int = DEFAULT_MAX_FUSED,
                 solve_fn=None, pipeline: bool = True,
                 dispatch_fn=None, finish_fn=None,
                 lane_former=None, lane_controller=None):
        self.server = server
        self.max_fused = max(1, int(max_fused))
        #: conflict-aware chunk formation: when set, the
        #: drain leader reorders each round's combined member list via
        #: `lane_former(members, width)` before dispatch, so the lane
        #: kernel's consecutive L-blocks hold non-conflicting members
        #: (`form_lanes` partially applied over a footprint key_fn is
        #: the standard former).  `lane_controller` supplies the width
        #: and is fed by the round's finish path (the bench's lane leg
        #: and the sharded drain both read the solver's lane counters
        #: there — the coordinator itself never blocks on a fetch to
        #: learn the bounce rate).
        self.lane_former = lane_former
        self.lane_controller = lane_controller
        #: (server, worker, combined_batch) -> None; serialized custom
        #: path (bench A/B legs, tests) — disables pipelining
        self.solve_fn = solve_fn
        #: split custom path: dispatch_fn(server, worker, batch) -> round
        #: handle (or None when nothing to solve), finish_fn(server,
        #: worker, round) -> None.  The bench injects a direct resident-
        #: solver pair here to measure pipelined fusion alone.
        self.dispatch_fn = dispatch_fn
        self.finish_fn = finish_fn
        self.pipeline = (bool(pipeline) and solve_fn is None) \
            or dispatch_fn is not None
        self._lock = threading.Lock()
        # signalled on every submission: the drain leader parks here
        # (briefly, bounded) when it has a round in flight but nothing
        # queued, so a submission landing during the device solve is
        # dispatched BEFORE the in-flight fetch instead of after it —
        # the difference between a back-to-back device and a bubble
        self._submitted = threading.Condition(self._lock)
        self._queue: List[_FusedSubmission] = []
        self._draining = False
        self._paused = False
        # the single resident solver the combined waves run on: pinned
        # to the first drain leader's worker so every fused round reuses
        # one tensorized world + compile cache
        self._solve_worker = None

    def submit(self, worker, batch: List[Tuple[Evaluation, str]]) -> None:
        """Solve `batch`, fused with whatever other workers have queued.
        Blocks until the batch's evals are acked/nacked/fallen back;
        re-raises the drain error so the caller's nack path owns its
        own evals."""
        sub = self.submit_nowait(worker, batch)
        if not sub.done.wait(60.0):
            raise TimeoutError("fused solve coordinator timed out")
        if sub.error is not None:
            raise sub.error

    def submit_nowait(self, worker,
                      batch: List[Tuple[Evaluation, str]]
                      ) -> "_FusedSubmission":
        """Queue `batch` for fused solving and return its fan-back
        future: `done` fires after the batch's round completes its
        finish phase, `error` carries a drain failure.  The FIRST
        submitter still becomes the drain leader and blocks inside
        `_drain`; every other caller returns immediately — the shape
        that keeps dequeue threads feeding the pipeline (a blocked
        submitter cannot fetch the next batch, so with blocking
        submits the device idles between rounds exactly as long as a
        dequeue takes).  Callers that fire-and-forget must arrange
        ack/nack inside the round itself (the bench's finish_fn does);
        callers that need results wait on the future — `submit` is
        that composition."""
        sub = _FusedSubmission(worker, batch)
        with self._lock:
            self._queue.append(sub)
            self._submitted.notify()
            leader = not self._draining and not self._paused
            if leader:
                self._draining = True
        if leader:
            self._drain(worker)
        return sub

    def pause(self) -> None:
        """Hold submissions without draining (test/chaos hook)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        """Release a pause; the resuming thread drains the backlog."""
        with self._lock:
            self._paused = False
            leader = not self._draining and bool(self._queue)
            if leader:
                self._draining = True
        if leader:
            self._drain(None)

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def _drain(self, worker) -> None:
        """Drain leader: fuse queued submissions round by round until
        the queue is empty (submissions landing mid-solve join the next
        round).  The role flag hand-off is atomic with the queue check,
        so a submission is never left behind without a drainer.

        Pipelined mode keeps one round in flight: each iteration
        dispatches round b+1 FIRST (the device starts solving), then
        finishes round b (fetch + fan-back + ack) — so the Python
        reconcile/plan work of every round overlaps the device solve of
        its neighbor.  The leader never returns with a round in flight,
        and a submitter's `done` fires only after its round's finish
        phase (no eval is released between dispatch and fetch)."""
        from ..utils.metrics import global_metrics as _m
        # (submitters, round handle) of the dispatched-not-fetched round
        inflight: Optional[Tuple[List[_FusedSubmission], object]] = None
        prev_fetch_done = 0.0
        while True:
            with self._lock:
                if inflight is not None and not self._queue \
                        and not self._paused:
                    # a round is solving on the device and the queue is
                    # dry: the fetch below would block until the device
                    # finishes anyway, so give a concurrent submitter a
                    # bounded beat to land — a submission caught here is
                    # dispatched UNDER the in-flight solve (back-to-back
                    # device) instead of after its fetch (a bubble the
                    # size of a dispatch).  Condition.wait releases the
                    # lock, so submitters are never blocked out.
                    self._submitted.wait(0.002)
                dry = self._paused or not self._queue
                if dry and inflight is None:
                    self._draining = False
                    return
                round_subs: List[_FusedSubmission] = []
                if not dry:
                    total = 0
                    while self._queue and total < self.max_fused:
                        s = self._queue.pop(0)
                        round_subs.append(s)
                        total += len(s.batch)
                    if self._solve_worker is None:
                        self._solve_worker = worker or round_subs[0].worker
                solve_worker = self._solve_worker
            rnd = None
            if round_subs:
                combined = [pair for s in round_subs for pair in s.batch]
                if self.lane_former is not None:
                    w = (self.lane_controller.width
                         if self.lane_controller is not None else 0)
                    combined = self.lane_former(combined, w)
                _m.add_sample("coordinator.fused_evals",
                              float(len(combined)))
                if len(round_subs) > 1:
                    _m.incr_counter("coordinator.cross_worker_rounds")
                _m.incr_counter("coordinator.rounds")
                if not self.pipeline:
                    # serialized path (legacy solve_fn or pipeline off):
                    # run the round end to end; nothing ever in flight
                    try:
                        (self.solve_fn or process_fleet)(
                            self.server, solve_worker, combined)
                    except Exception as exc:
                        # each submitter nacks its OWN evals from its
                        # worker loop's failure path — the coordinator
                        # only relays
                        for s in round_subs:
                            s.error = exc
                    finally:
                        for s in round_subs:
                            s.done.set()
                    continue
                try:
                    if self.dispatch_fn is not None:
                        rnd = self.dispatch_fn(self.server, solve_worker,
                                               combined)
                    else:
                        rnd = fleet_begin(self.server, solve_worker,
                                          combined)
                        if rnd is not None:
                            fleet_dispatch(self.server, solve_worker,
                                           rnd)
                except Exception as exc:
                    for s in round_subs:
                        s.error = exc
                        s.done.set()
                    round_subs, rnd = [], None
                if round_subs and rnd is None:
                    # nothing fused (every eval took the single path
                    # inside begin): the round is already complete
                    for s in round_subs:
                        s.done.set()
                    round_subs = []
            # round b's device solve has been running while round b+1
            # reconciled + dispatched above; finish it now and release
            # its submitters
            if inflight is not None:
                prev_fetch_done = self._finish_inflight(
                    solve_worker, inflight, prev_fetch_done)
            inflight = (round_subs, rnd) if round_subs else None

    def _finish_inflight(self, worker, inflight, prev_fetch_done: float
                         ) -> float:
        subs, rnd = inflight
        t_done = prev_fetch_done
        try:
            if self.finish_fn is not None:
                self.finish_fn(self.server, worker, rnd)
            else:
                fleet_finish(self.server, worker, rnd,
                             prev_fetch_done=prev_fetch_done)
            t_done = getattr(rnd, "t_fetch_done", 0.0) or prev_fetch_done
        except Exception as exc:
            for s in subs:
                s.error = exc
        finally:
            for s in subs:
                s.done.set()
        return t_done
