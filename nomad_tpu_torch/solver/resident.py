"""Resident solve: node planes live on the card, eval batches stream.

The counterpart of `nomad_tpu.solver.resident`, the system's throughput
path:

  * pack the node side ONCE (capacity, attributes, device inventory) and
    put it on the device a single time;
  * per eval batch, pack only the [G, ...] ask programs
    (`Tensorizer.repack_asks`): no O(N) host walk, no O(N) transfer;
  * carry `used` / `dev_used` on the device between batches, so cluster
    usage never bounces through the host;
  * run MANY eval batches through one stream (`solve_stream`): each
    batch's placements see every earlier batch's resource commits
    through the carried usage.  Job-scoped scoring state (distinct_hosts
    blocking, anti-affinity collocation, spread usage) is seeded per
    batch, which is sound because the eval broker serializes evals per
    job: one job never appears in two batches of one stream, and
    `solve_stream` enforces that;
  * fetch ONE packed [B, K, 2*TOP_K+1] result (node indices, scores and
    a per-placement STATUS_* outcome; `ok` derives from the score,
    since failed slots score NEG_INF).

The node planes advance between streams by row scatters
(`apply_delta`: `kernel.delta_scatter_set` / `delta_scatter_add`, in
place) or, past `delta_threshold`, by a full repack.

The reference's three device programs are torch ops driving the wave
solve (`kernel.solve_steps`): `_stream_kernel` (B solves in turn,
carrying usage, with the eviction pass when the planes are resident),
`_parallel_kernel` (B solves against one snapshot, then a serial
revalidation that bounces what no longer fits) and
`_lane_stream_kernel` (chunks of L solves in lock-step through
`kernel.solve_lanes`, then a cross-lane revalidation).  The wave loop
waits for the card once a wave (and once more after a rerank), so a
dispatch returns only when its solves are done; nothing here is
asynchronous.  Every wave call on
CUDA tensors goes through `wave_kernel.fused_wave`, which launches the
kernel or raises.  The solves' waves, full passes and host syncs come
back per batch (`last_waves`, `last_rescore_waves`, `last_syncs`,
`last_graphed`, `last_captures`, the waves whose conflict check and
commits ran on the node-segmented kernels, `last_conflict_kernel`, and
the [group, node] pairs the static feasibility ruled out,
`last_filtered`) and each dispatch folds them
into the process registry (`solve.count_dispatch`).

The mesh solvers (`nomad_tpu_torch.parallel.sharded`) subclass this
one through its four placement hooks and `_solve_one(..., mesh=)`.  The
knobs `shortlist_c`, `fused_lanes` and `delta_threshold` are constructor
arguments that default, when None, to `NOMAD_TPU_SHORTLIST_C`,
`NOMAD_TPU_FUSED_LANES` and `NOMAD_TPU_DELTA_THRESHOLD`, read at
construction.
`apply_delta` consults the chaos site "delta_row" (one dict lookup while
nothing is armed): an armed "mutate" corrupts the first `rows` node rows
bound for the card after the host template took the clean apply, so
`plane_checksum()` differs from `template_checksum` until a clean
re-apply of those rows or a repack.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos.injection import global_injections
from . import seg_kernel as _sk
from . import wave_kernel as _wk
from .kernel import (MERGED_GP_MAX, NEG_INF, TOP_K, WAVE_K, _MERGED_W_CAP,
                     _WIDE_W_CAP, delta_scatter_add, delta_scatter_set,
                     resolve_shortlist_c, solve_lanes, solve_shards,
                     solve_steps)
from .masks import np_pack_bool_u32, unpack_bool_u32
from .solve import count_dispatch, resolve_device
from .tensorize import PackedBatch, PlacementAsk, Tensorizer

# per-placement outcome in the packed result's last column
STATUS_FAILED = 0      # infeasible / resources exhausted: terminal
STATUS_COMMITTED = 1   # slot-0 choice committed into carried usage
STATUS_RETRY = 2       # bounced by revalidation or wave budget: resubmit

# ask-side solve arguments stacked per batch
_ASK_ARGS = ("ask_res", "ask_desired", "distinct", "dc_ok", "host_ok",
             "coll0", "penalty", "c_op", "c_col", "c_rank", "a_op", "a_col",
             "a_rank", "a_weight", "a_host", "sp_col", "sp_weight",
             "sp_targeted", "sp_desired", "sp_implicit", "sp_used0",
             "dev_ask", "p_ask", "ask_prio")
# node-side planes put on the device once
_NODE_PLANES = ("avail", "reserved", "valid", "node_dc", "attr_rank",
                "dev_cap")


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unpack_stream(out) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Decode a fetched stream payload (compact int16, see
    pack_out_compact, or the f32 layout) into (choice, ok, score,
    status)."""
    out = _host(out)
    choice = out[..., :TOP_K].astype(np.int32)
    if out.dtype == np.int16:
        u16 = np.ascontiguousarray(
            out[..., TOP_K:2 * TOP_K]).view(np.uint16)
        score = (u16.astype(np.uint32) << 16).view(np.float32)
    else:
        score = out[..., TOP_K:2 * TOP_K]
    status = out[..., -1].astype(np.int32)
    ok = score > NEG_INF / 2
    return choice, ok, score, status


def _env_shortlist_c() -> int:
    """NOMAD_TPU_SHORTLIST_C: unset/'auto' -> 0 (auto), 'off'/-1 ->
    disabled, else an int handed to kernel.resolve_shortlist_c (which
    validates it against the problem shape at solve time)."""
    raw = os.environ.get("NOMAD_TPU_SHORTLIST_C", "").strip().lower()
    if raw in ("", "auto"):
        return 0
    if raw in ("off", "-1"):
        return -1
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"NOMAD_TPU_SHORTLIST_C={raw!r} invalid: use 'auto', 'off' "
            "or an integer shortlist width") from None


def _env_fused_lanes() -> int:
    """NOMAD_TPU_FUSED_LANES: unset/'1'/'serial' -> 1 (the serial
    stream); an integer > 1 opts solve_stream into chunks of that many
    lanes.  Callers that widen per round (the lane-width controller)
    pass `lanes=` per call instead."""
    raw = os.environ.get("NOMAD_TPU_FUSED_LANES", "").strip().lower()
    if raw in ("", "1", "serial"):
        return 1
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError(
            f"NOMAD_TPU_FUSED_LANES={raw!r} invalid: pass an integer "
            "lane width (1 = serial scan)") from None


def pack_out_compact(choice, score, status) -> torch.Tensor:
    """Device-side result compaction: node indices as int16, scores as
    bfloat16 bits, status as int16: [..., 2*TOP_K+1] int16, half the
    fetch bytes of the f32 layout; `ok` (score > NEG_INF/2) survives
    bf16.  Requires Np < 32768 (int16 node indices)."""
    return torch.cat(
        [choice.to(torch.int16),
         score.to(torch.bfloat16).view(torch.int16),
         status.to(torch.int16)[..., None]], dim=-1)


def _pack_out(choice, score, status, compact: bool) -> torch.Tensor:
    if compact:
        return pack_out_compact(choice, score, status)
    return torch.cat([choice.to(torch.float32), score,
                      status.to(torch.float32)[..., None]], dim=-1)


def _total(counts) -> int:
    """The sum of a stream's per-batch counts (an array, or a list of
    them from a pipelined stream)."""
    if isinstance(counts, list):
        return int(sum(int(np.asarray(c).sum()) for c in counts))
    return int(np.asarray(counts).sum())


def _status(commit, retry) -> torch.Tensor:
    return torch.where(commit, STATUS_COMMITTED,
                       torch.where(retry, STATUS_RETRY, STATUS_FAILED))


def pack_batch_cached(solver, asks: Sequence[PlacementAsk],
                      job_keys: Optional[set] = None
                      ) -> Optional[PackedBatch]:
    """pack_batch with a whole-batch cache: asks carrying NO per-eval
    state (no penalties, existing allocs, blocked hosts, spread seeds,
    property limits) reuse the previously packed batch for the same
    (spec signature, count) sequence, the steady-state stream where
    merge_asks collapses every chunk to the same few rows.  Nothing
    mutates a PackedBatch, so sharing is sound; job_keys (the stream
    guard) is refreshed per call.  distinct_hosts asks are never cached:
    their packed `distinct` column interns job/group identity, which the
    spec signature excludes."""
    from ..scheduler import feasible as hostfeas
    from ..structs import CONSTRAINT_DISTINCT_HOSTS
    cacheable = all(
        not (a.penalty_nodes or a.existing_by_node
             or a.distinct_hosts_blocked or a.spread_seed
             or a.property_limits)
        and not any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                    for c in hostfeas.merged_constraints(a.job, a.tg))
        for a in asks)
    if not cacheable:
        return solver.pack_batch(asks, job_keys=job_keys)
    sig = solver._tz.ask_signer()
    key = tuple((sig(a), a.count) for a in asks)
    pb = solver._eval_cache.get(key)
    if pb is None:
        pb = solver.pack_batch(asks, job_keys=job_keys)
        if pb is None:
            return None
        if len(solver._eval_cache) > 512:
            solver._eval_cache.clear()
        solver._eval_cache[key] = pb
    else:
        pb.job_keys = (job_keys if job_keys is not None else
                       {(a.job.namespace, a.job.id) for a in asks})
    return pb


def model_wave_bytes(Np: int, Gp: int, K: int, S: int, R: int,
                     has_spread: bool, mode: str, TK: int, C: int
                     ) -> Tuple[int, int, int]:
    """Two-tier per-wave byte model: (bytes_wave1, bytes_rewave,
    fused_pass_count).  bytes_wave1 models a full-N pass (wave 1 and
    every shortlist-escape rescore); bytes_rewave a shortlist-resident
    contention wave over the carried [Gp, C] state.  A pure function of
    the solve shape (the reference's model, term for term)."""
    plane = Gp * Np
    spread_planes = (2 * S * plane * 4) if has_spread else 0
    if mode == "off":
        # the unfused chain: ~6 elementwise [Gp, Np] f32 passes plus the
        # [Gp, Np, R] broadcast intermediates and the top-k read
        bytes_wave1 = (plane * 4 * 6 + plane * R * 4 * 2
                       + spread_planes + Np * R * 4 * 2
                       + K * 4 * 6)
        passes = 6
    else:
        # fused single pass: every plane read once (feas/pen bitpacked,
        # aff, jitter and coll f32, spread statics), node columns once,
        # plus the score plane's write and read in "score" mode only
        reads = plane * (4 + 4 + 4) + 2 * (plane // 8) \
            + spread_planes + Np * R * 4 * 3
        extra = (plane * 4 * 2 if mode == "score" else 0)
        bytes_wave1 = reads + extra + K * 4 * 6
        passes = 1
    if C > 0:
        # shortlist wave: the carried [Gp, C] state read and written, the
        # live gathers of used/avail/reserved rows, the [Gp, TK] window,
        # the [Np] commit-mark plane and the K-sized commit vectors
        per_entry = (14 + (8 * S if has_spread else 0)) * 2 + 12 * R
        bytes_rewave = (Gp * C * per_entry + Np * 4
                        + Gp * TK * 12 + K * 4 * 2)
    else:
        bytes_rewave = bytes_wave1     # no shortlist: all waves full
    return int(bytes_wave1), int(bytes_rewave), passes


def _solve_steps(node, used, dev_used, batch, n_place, seed=0, *,
                 has_preempt=False, has_distinct=True, **kw):
    """One batch's wave solve (a `solve_steps` generator) against the
    resident planes `node` and the usage `used` / `dev_used`.  host_ok
    and penalty may arrive bitpacked (int32 words) from _stack_args;
    they unpack on the device.  A mesh shard's `node` may also carry its
    elastic layout tables (node_gid, owner_map, slot_map)."""
    Np = node["avail"].shape[0]
    for name in ("node_gid", "owner_map", "slot_map"):
        if name in node:
            kw[name] = node[name]
    host_ok, penalty = batch["host_ok"], batch["penalty"]
    if host_ok.dtype == torch.int32:
        host_ok = unpack_bool_u32(host_ok, Np)
    if penalty.dtype == torch.int32:
        penalty = unpack_bool_u32(penalty, Np)
    if has_preempt:
        # the stream gated distinct batches off already (the eviction
        # pass refuses distinct_hosts batches)
        has_distinct = False
        kw.update(has_preempt=True, ev_res=node["ev_res"],
                  ev_prio=node["ev_prio"], ask_prio=batch["ask_prio"])
    b = batch
    return solve_steps(
        node["avail"], node["reserved"], used, node["valid"],
        node["node_dc"], node["attr_rank"], b["ask_res"], b["ask_desired"],
        b["distinct"], b["dc_ok"], host_ok, b["coll0"], penalty, b["c_op"],
        b["c_col"], b["c_rank"], b["a_op"], b["a_col"], b["a_rank"],
        b["a_weight"], b["a_host"], b["sp_col"], b["sp_weight"],
        b["sp_targeted"], b["sp_desired"], b["sp_implicit"], b["sp_used0"],
        node["dev_cap"], dev_used, b["dev_ask"], b["p_ask"], n_place, seed,
        has_distinct=has_distinct, **kw)


def _solve_one(node, used, dev_used, batch, *args, mesh=None, **kw):
    """One batch's solve.  With `mesh`, `node`, `used`, `dev_used` and
    `batch` are lists with one entry a shard (linear order), the mesh
    keywords (`mesh_axis`, `mesh_shards`, ...) pass through to each
    shard's `solve_steps`, and the result is the list of the shards'
    SolveResults (`kernel.solve_shards`)."""
    if mesh is None:
        return solve_lanes([_solve_steps(node, used, dev_used, batch,
                                         *args, single_lane=True,
                                         **kw)])[0]
    return solve_shards(
        [_solve_steps(node[i], used[i], dev_used[i], batch[i], *args, **kw)
         for i in range(len(node))], mesh)


def _batch(stacked: Dict, b: int) -> Dict:
    return {k: v[b] for k, v in stacked.items()}


def _per_placement(batch, name):
    """The [K, ...] ask rows of each placement (ask_res / dev_ask)."""
    return batch[name][batch["p_ask"].to(torch.int64)]


def _revalidate(node, used, dev_used, cand, ok, res_k, dev_k):
    """The serial plan applier over placements in row order: a placement
    commits when its node still fits it after every earlier ok placement
    on the same node (conservative one-round semantics: a bounced
    placement's load still counts toward later rows, so a bounce can
    cascade; every bounce is STATUS_RETRY).  Returns (used, dev_used,
    commit).  The earlier rows' sums and the commits run over one
    sort of the rows by node (`seg_kernel`), exact for integer asks at
    any row count."""
    cand = cand.to(torch.int64)
    seg = _sk.sort_segments(cand, ok)
    prior = _sk.prior_sum(seg, res_k)
    prior_dev = _sk.prior_sum(seg, dev_k)
    fits = ((used[cand] + prior + res_k) <= node["avail"][cand]).all(-1)
    dev_fits = ((dev_used[cand] + prior_dev + dev_k)
                <= node["dev_cap"][cand]).all(-1)
    commit = ok & fits & dev_fits
    return (_sk.seg_add(seg, used, res_k, commit),
            _sk.seg_add(seg, dev_used, dev_k, commit), commit)


def _stream_kernel(node, used0, dev_used0, stacked, n_places, seeds, *,
                   compact=True, has_preempt=False, **kw):
    """B solves in turn, threading usage from batch to batch.  Returns
    (used, dev_used, out [B, K, 2*TOP_K+1], evict [B, K, E] (zeros
    [B, K, 1] without the eviction pass), waves [B], rescores [B],
    syncs [B], graphed [B], captures [B], filtered [B], conflict [B])."""
    used, dev_used = used0, dev_used0
    outs, evicts, waves, rescores, syncs = [], [], [], [], []
    graphed, captures, filtered, conflict = [], [], [], []
    for b, (n_place, seed) in enumerate(zip(n_places, seeds)):
        batch = _batch(stacked, b)
        res = _solve_one(node, used, dev_used, batch, int(n_place),
                         int(seed), has_preempt=has_preempt, **kw)
        status = _status(res.choice_ok[:, 0], res.unfinished)
        outs.append(_pack_out(res.choice, res.score, status, compact))
        evicts.append(res.evict if has_preempt else torch.zeros(
            (res.choice.shape[0], 1), dtype=torch.bool,
            device=res.choice.device))
        waves.append(res.n_waves)
        rescores.append(res.n_rescore)
        syncs.append(res.n_syncs)
        graphed.append(res.n_graphed)
        captures.append(res.n_captures)
        filtered.append(res.filtered_pairs)
        conflict.append(res.n_conflict_kernel)
        used, dev_used = res.used_final, res.dev_used_final
    return (used, dev_used, torch.stack(outs), torch.stack(evicts),
            np.asarray(waves, np.int32), np.asarray(rescores, np.int32),
            np.asarray(syncs, np.int32), np.asarray(graphed, np.int32),
            np.asarray(captures, np.int32), np.asarray(filtered, np.int64),
            np.asarray(conflict, np.int32))


def _parallel_kernel(node, used0, dev_used0, stacked, n_places, seeds,
                     **kw):
    """The reference's optimistic worker concurrency (worker goroutines
    plus the serial plan applier): B solves against ONE usage snapshot,
    each with its own tie-break seed and the shortlist off (with the
    solver's wave scorer; the reference's program keeps its unfused
    one, which scores the same within the ulp bound), then every
    batch's slot-0 placements revalidated in batch order against the
    cumulative usage, bouncing what no longer fits.  Returns (used,
    dev_used, out [B, K, 2*TOP_K+1] f32, waves [B], rescores [B],
    syncs [B], graphed [B], captures [B], filtered [B], conflict [B])."""
    kw["shortlist_c"] = -1
    res = [_solve_one(node, used0, dev_used0, _batch(stacked, b), int(n),
                      int(s), **kw)
           for b, (n, s) in enumerate(zip(n_places, seeds))]
    used, dev_used = used0, dev_used0
    outs = []
    for b, r in enumerate(res):
        batch = _batch(stacked, b)
        ks = torch.arange(r.choice.shape[0], device=r.choice.device)
        ok = r.choice_ok[:, 0] & (ks < int(n_places[b]))
        used, dev_used, commit = _revalidate(
            node, used, dev_used, r.choice[:, 0], ok,
            _per_placement(batch, "ask_res"),
            _per_placement(batch, "dev_ask"))
        # bounced placements lose ALL slots (their fall-through scores
        # were solved against a stale snapshot and never charged)
        score = torch.where(commit[:, None], r.score, NEG_INF)
        outs.append(_pack_out(r.choice, score,
                              _status(commit, ok | r.unfinished), False))
    return (used, dev_used, torch.stack(outs),
            np.asarray([r.n_waves for r in res], np.int32),
            np.asarray([r.n_rescore for r in res], np.int32),
            np.asarray([r.n_syncs for r in res], np.int32),
            np.asarray([r.n_graphed for r in res], np.int32),
            np.asarray([r.n_captures for r in res], np.int32),
            np.asarray([r.filtered_pairs for r in res], np.int64),
            np.asarray([r.n_conflict_kernel for r in res], np.int32))


def _lane_stream_kernel(node, used0, dev_used0, stacked, n_places, seeds,
                        *, lanes, compact=True, **kw):
    """The chunked stream: L batches a step solve in lock-step
    (`solve_lanes`) against the carried usage, then all L lanes' slot-0
    commits revalidate in one pass in lane-major order (lane l's
    placement k at rank l*K + k).  Serial depth drops from B to B/L;
    placements a sibling lane beat to a node bounce to STATUS_RETRY with
    every score slot nulled.  B must be a multiple of `lanes` (the host
    pads with n_place = 0 rows).  Returns (used, dev_used, out, waves,
    rescores, syncs, filtered, conflict, bounced, committed), each per
    batch.  Lanes in lock-step open no profiler ranges: `solve_lanes`
    opens the waves."""
    L = lanes
    used, dev_used = used0, dev_used0
    outs, waves, rescores, syncs, filtered = [], [], [], [], []
    conflict, bounced, committed = [], [], []
    for c in range(len(n_places) // L):
        bs = range(c * L, (c + 1) * L)
        batches = [_batch(stacked, b) for b in bs]
        res = solve_lanes(
            _solve_steps(node, used, dev_used, batches[i],
                         int(n_places[b]), int(seeds[b]),
                         wave_ranges=L == 1, single_lane=L == 1, **kw)
            for i, b in enumerate(bs))
        K = res[0].choice.shape[0]
        ks = torch.arange(K, device=res[0].choice.device)
        choice = torch.stack([r.choice for r in res])      # [L, K, TOP_K]
        okf = torch.stack([r.choice_ok[:, 0] & (ks < int(n_places[b]))
                           for r, b in zip(res, bs)]).reshape(L * K)
        unfin = torch.stack([r.unfinished for r in res]).reshape(L * K)
        used, dev_used, commit = _revalidate(
            node, used, dev_used, choice[:, :, 0].reshape(L * K), okf,
            torch.cat([_per_placement(bt, "ask_res") for bt in batches]),
            torch.cat([_per_placement(bt, "dev_ask") for bt in batches]))
        score = torch.where(commit.reshape(L, K, 1),
                            torch.stack([r.score for r in res]), NEG_INF)
        status = _status(commit, okf | unfin).reshape(L, K)
        outs.append(_pack_out(choice, score, status, compact))
        waves += [r.n_waves for r in res]
        rescores += [r.n_rescore for r in res]
        syncs += [r.n_syncs for r in res]
        filtered += [r.filtered_pairs for r in res]
        conflict += [r.n_conflict_kernel for r in res]
        bounced.append((okf & ~commit).reshape(L, K).sum(dim=1))
        committed.append(commit.reshape(L, K).sum(dim=1))
    return (used, dev_used, torch.cat(outs), np.asarray(waves, np.int32),
            np.asarray(rescores, np.int32), np.asarray(syncs, np.int32),
            np.asarray(filtered, np.int64), np.asarray(conflict, np.int32),
            torch.cat(bounced), torch.cat(committed))


class ResidentSolver:
    """Streaming placement engine for one node snapshot.

    Build once per (node set, attribute / task-runtime universe); then
    `solve_stream` processes eval batches with card-resident state.  The
    probe asks passed to the constructor define the tensor universe
    (attr columns, constraint/affinity/spread slot counts, device
    patterns); real batches whose asks fit that universe take the fast
    path.  The solver runs on `device` (`solve.resolve_device`: cuda
    unless the caller asks for the CPU; raises without a GPU).

    `shortlist_c` (0 auto-sizes, -1 disables), `fused_lanes` (1: the
    serial stream; L > 1: chunks of L lanes) and `delta_threshold` (the
    touched share of real node slots above which `apply_delta` repacks)
    take, when None, `NOMAD_TPU_SHORTLIST_C`, `NOMAD_TPU_FUSED_LANES` and
    `NOMAD_TPU_DELTA_THRESHOLD` (defaults 0, 1 and 0.25).  `evict_e` > 0
    packs top-E evictable-alloc planes from `allocs_by_node` and runs
    the eviction pass for groups with nothing placeable.  The pass
    frees each victim's resources from the carried usage itself; the
    caller then feeds the victims back before the next batch as the
    stops of a delta applied with `evicted=True`
    (`apply_delta(delta, evicted=True)`), which advances the eviction
    planes without charging the carried usage a second time.  A plain
    stop delta would free the victims twice.
    """

    def __init__(self, nodes, probe_asks: Sequence[PlacementAsk],
                 allocs_by_node: Optional[Dict[str, list]] = None,
                 gp: Optional[int] = None, kp: Optional[int] = None,
                 max_waves: int = 0, wave_mode: str = "scan",
                 stack_commit: bool = False, pallas: str = "auto",
                 delta_threshold: Optional[float] = None,
                 shortlist_c: Optional[int] = None,
                 evict_e: int = 0, fused_lanes: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.nodes = list(nodes)
        self.evict_e = int(evict_e)
        self.max_waves = max_waves        # 0 = kernel default
        self.wave_mode = wave_mode
        self.stack_commit = stack_commit  # serial-fidelity commits
        #: "auto" picks the fused wave kernel's mode from the shape on
        #: CUDA ("off" on the CPU); "off" / "score" / "topk" pin it
        self.pallas = pallas
        self.shortlist_c = (int(shortlist_c) if shortlist_c is not None
                            else _env_shortlist_c())
        self.fused_lanes = (max(1, int(fused_lanes))
                            if fused_lanes is not None
                            else _env_fused_lanes())
        self.delta_threshold = (
            float(delta_threshold) if delta_threshold is not None
            else float(os.environ.get("NOMAD_TPU_DELTA_THRESHOLD",
                                      "0.25")))
        #: revalidation counters of the last lane stream (None after a
        #: serial stream); fetch with lane_counters()
        self.last_lane_counters = None
        #: per-batch wave, full-rescore wave and host-sync counts of the
        #: last stream, its waves replayed as CUDA graphs, graphs
        #: captured and waves on the node-segmented kernels, and the
        #: [group, node] pairs its static feasibility ruled out
        self.last_waves = None
        self.last_rescore_waves = None
        self.last_syncs = None
        self.last_graphed = None
        self.last_captures = None
        self.last_conflict_kernel = None
        self.last_filtered = None
        self.delta_counters = {
            "delta_applies": 0, "repack_fallbacks": 0,
            "last_delta_ratio": 0.0,
            "bytes_dispatched_delta": 0, "bytes_dispatched_full": 0,
            "bytes_dispatched_ask": 0, "ask_dispatches": 0,
        }
        #: pow2-bucketed staging buffers for B > 1 stacked ask planes
        self._stage_cache: Dict = {}
        #: B > 1 stacked-args cache keyed on the batches' identities
        self._stream_stack_cache: Dict = {}
        #: bumps on every node-shape change; stacked-batch caches are
        #: keyed on it so a stale ask plane is never reused
        self._node_epoch = 0
        #: bumps whenever the eviction planes advance
        self._ev_epoch = 0
        #: host bytes the last dispatch shipped (0 on a cached one)
        self.last_dispatch_bytes = 0
        self.last_pipeline_stats = None
        #: [B, K, E] eviction-slot masks of the last stream (a list when
        #: pipelined); None until a preempt-enabled stream ran
        self.last_evict = None
        self._probe_asks = list(probe_asks)
        self._tz = Tensorizer()
        self.template = self._tz.pack(nodes, probe_asks, allocs_by_node,
                                      evict_e=self.evict_e)
        self.node_index = {n.id: i for i, n in enumerate(self.nodes)}
        self.gp = gp or self.template.ask_res.shape[0]
        self.kp = kp or self.template.p_ask.shape[0]
        self._drv_cache: Dict[str, np.ndarray] = {}
        self._row_cache: Dict = {}
        self._eval_cache: Dict = {}
        # device-resident constants for the [G, N] ask planes that are
        # usually all-zero (fresh jobs) or at their default (host_ok)
        self._const_cache: Dict[Tuple[str, int], torch.Tensor] = {}
        self._put_node_side()

    #: host_ok / penalty ship bitpacked; the mesh solvers ship them
    #: dense, since a packed word of 32 node columns cannot be split on
    #: the node axis
    _pack_bool_planes = True

    # The four hooks below (`_put_node`, `_put_ask`, `_delta_set`,
    # `_delta_add`) are where the sharded solvers differ, as in the
    # reference: node planes are split on the node axis, ask planes
    # replicated, and delta rows routed to the shard that owns them.

    def _put_node(self, name: str, arr) -> torch.Tensor:
        """One node-side plane on the device.  Always COPIES first: on
        the CPU a tensor from numpy shares its memory, and apply_delta
        later edits the template arrays in place
        (apply_node_delta_host); through an alias the device planes would
        take both the host `+=` and the scatter-add."""
        return torch.as_tensor(np.array(arr)).to(self.device)

    def _put_ask(self, name: str, arr) -> torch.Tensor:
        """One stacked [B, ...] ask plane on the device, copied (the
        staged planes are views into a reused staging ring)."""
        return torch.as_tensor(np.array(arr)).to(self.device)

    def _put_node_side(self) -> None:
        """Ship the full node-side planes to the device (initial build
        and the repack path) and rebuild everything derived from the
        node axis."""
        t = self.template
        self._dev_node = {name: self._put_node(name, getattr(t, name))
                          for name in _NODE_PLANES}
        if t.ev_prio is not None:
            self._dev_node["ev_prio"] = self._put_node("ev_prio", t.ev_prio)
            self._dev_node["ev_res"] = self._put_node("ev_res", t.ev_res)
        self._used = self._put_node("used", t.used0)
        self._dev_used = self._put_node("dev_used", t.dev_used0)
        # the compact int16 payload needs int16-expressible node ids
        self._compact = t.avail.shape[0] < 32768
        self._default_host_ok = np.zeros((self.gp, t.avail.shape[0]),
                                         bool)
        self._default_host_ok[:, :t.n_real] = True
        self.delta_counters["bytes_dispatched_full"] += int(
            sum(getattr(t, n).nbytes for n in _NODE_PLANES)
            + t.used0.nbytes + t.dev_used0.nbytes
            + (t.ev_prio.nbytes + t.ev_res.nbytes
               if t.ev_prio is not None else 0))

    def _delta_set(self, arr, idx, rows):
        """Row "set" into a resident plane, in place."""
        return delta_scatter_set(arr, idx, rows)

    def _delta_add(self, arr, idx, rows):
        """Row "add" into the carried usage, in place."""
        return delta_scatter_add(arr, idx, rows)

    # ------------------------------------------------- delta lifecycle
    def apply_delta(self, delta, evicted: bool = False) -> str:
        """Apply a ClusterDelta to the card-resident cluster state.

        The incremental path (returns "delta") scatters only the touched
        rows into the resident planes and the carried usage: no
        [Np, ...] re-tensorization, no full re-put.  Falls back to a
        full repack (returns "repack") when the delta steps outside the
        interned universe (new dc / attr value / device pattern),
        overflows the padded node axis, or touches more than
        `delta_threshold` of the real node slots.

        `evicted=True` says the delta's stops are victims of the last
        stream's eviction pass (`last_evict`), which already freed their
        resources from the carried usage: the stops advance the eviction
        planes and the host template, and the carried usage keeps its
        value for them (their device usage, which the pass does not
        free, is still released)."""
        from .tensorize import alloc_usage_vector, apply_node_delta_host
        if delta.empty():
            return "delta"
        nd = self._tz.delta_pack(self.template, self.node_index, delta)
        if nd is not None:
            self.delta_counters["last_delta_ratio"] = round(
                nd.ratio(self.template.n_real), 6)
        if nd is None or nd.ratio(self.template.n_real) \
                > self.delta_threshold:
            self.repack(delta, evicted=evicted)
            return "repack"
        n_real_before = self.template.n_real
        apply_node_delta_host(self.template, nd, self.nodes,
                              self.node_index)

        # pow2-pad the scatter payloads, as the reference does: "set"
        # repeats row 0 (identical duplicate writes), "add" pads with
        # zero rows at slot 0 (no-op adds, which must accumulate)
        def _pad(idx, rows, repeat_first):
            M = idx.size
            P = 8
            while P < M:
                P *= 2
            if P == M:
                return idx, rows
            if repeat_first:
                pad_i = np.full(P - M, idx[0], idx.dtype)
                pads = [np.repeat(r[:1], P - M, axis=0) for r in rows]
            else:
                pad_i = np.zeros(P - M, idx.dtype)
                pads = [np.zeros((P - M,) + r.shape[1:], r.dtype)
                        for r in rows]
            return (np.concatenate([idx, pad_i]),
                    [np.concatenate([r, p]) for r, p in zip(rows, pads)])

        dn = self._dev_node
        if nd.touches_nodes():
            inj = global_injections.get("delta_row")
            if inj is not None:
                # corrupt only the rows bound for the card: the host
                # template took the clean apply above, so the planes
                # diverge until a checksum audit catches it
                inj.fire()
                k = min(int(inj.args.get("rows", 1)), nd.avail.shape[0])
                nd.avail = nd.avail.copy()
                nd.avail[:k] += 1.0
            idx, rows = _pad(nd.idx, [getattr(nd, n) for n in _NODE_PLANES],
                             repeat_first=True)
            for name, r in zip(_NODE_PLANES, rows):
                dn[name] = self._delta_set(dn[name], idx, r)
            # node-shape changes invalidate every cached host mask and
            # packed batch (task-runtime / volume feasibility, host_ok
            # widths)
            self._node_epoch += 1
            self._row_cache.clear()
            self._drv_cache.clear()
            self._eval_cache.clear()
            if self.template.n_real != n_real_before:
                self._default_host_ok = np.zeros(
                    (self.gp, self.template.avail.shape[0]), bool)
                self._default_host_ok[:, :self.template.n_real] = True
                self._const_cache = {
                    k: v for k, v in self._const_cache.items()
                    if k[0] != "host_ok"}
        if nd.u_idx.size:
            u_res = nd.u_res
            if evicted and nd.alloc_stop:
                u_res = u_res.copy()
                row = {int(s): i for i, s in enumerate(nd.u_idx)}
                for s, alloc in nd.alloc_stop:
                    u_res[row[s]] += alloc_usage_vector(alloc)
            u_idx, (u_res, u_dev) = _pad(nd.u_idx, [u_res, nd.u_dev],
                                         repeat_first=False)
            self._used = self._delta_add(self._used, u_idx, u_res)
            self._dev_used = self._delta_add(self._dev_used, u_idx, u_dev)
        if self.template.ev_lists is not None:
            # eviction-plane rows the host apply just recomputed scatter
            # like every other node plane
            t = self.template
            ev_slots = sorted(s for s in ({s for s, _ in nd.alloc_place}
                                          | {s for s, _ in nd.alloc_stop})
                              if s < t.ev_prio.shape[0])
            if ev_slots:
                self._ev_epoch += 1
                e_idx, (e_prio, e_res) = _pad(
                    np.asarray(ev_slots, np.int32),
                    [t.ev_prio[ev_slots], t.ev_res[ev_slots]],
                    repeat_first=True)
                dn["ev_prio"] = self._delta_set(dn["ev_prio"], e_idx, e_prio)
                dn["ev_res"] = self._delta_set(dn["ev_res"], e_idx, e_res)
        self.delta_counters["delta_applies"] += 1
        self.delta_counters["bytes_dispatched_delta"] += nd.nbytes()
        return "delta"

    def repack(self, delta=None, evicted: bool = False) -> None:
        """Full-repack fallback: rebuild the node-side template from the
        current node set (delta applied host-side first, removed nodes
        compacted away) and re-put it whole.  Carried usage transfers by
        node id; usage deltas in `delta` are folded in host-side, except
        the resources of stops that are `evicted` (apply_delta)."""
        from .tensorize import alloc_usage_vector
        used, dev_used = self.usage()
        old_ids = list(self.template.node_ids)
        by_id = {n.id: n for n in self.nodes}
        removed = set()
        if delta is not None:
            for n in delta.upsert_nodes:
                by_id[n.id] = n
            removed = set(delta.remove_node_ids)
        # keep join order, compact tombstones away; an upsert in the
        # triggering delta revives a previously-removed slot
        upserted = ({n.id for n in delta.upsert_nodes}
                    if delta is not None else set())
        new_nodes = []
        seen = set()
        for i, nid in enumerate(old_ids):
            if nid in removed:
                continue
            if not self.template.valid[i] and nid not in upserted:
                continue              # old tombstone stays dead
            new_nodes.append(by_id[nid])
            seen.add(nid)
        if delta is not None:
            for n in delta.upsert_nodes:
                if n.id not in seen and n.id not in removed:
                    new_nodes.append(n)
                    seen.add(n.id)
        old_ev_lists = (None if self.template.ev_lists is None else
                        {nid: self.template.ev_lists[i]
                         for i, nid in enumerate(old_ids)
                         if i < len(self.template.ev_lists)})
        self.nodes = new_nodes
        self.template = self._tz.pack(self.nodes, self._probe_asks,
                                      evict_e=self.evict_e)
        self.node_index = {n.id: i for i, n in enumerate(self.nodes)}
        t = self.template
        if t.ev_lists is not None and old_ev_lists is not None:
            # eviction candidates carry by node id too
            from .tensorize import _evict_row
            E = t.ev_prio.shape[1]
            for j, nid in enumerate(t.node_ids):
                cands = old_ev_lists.get(nid)
                if cands:
                    t.ev_lists[j] = list(cands)
                    t.ev_prio[j], t.ev_res[j], t.ev_ids[j] = _evict_row(
                        cands, E)
        for i, nid in enumerate(old_ids):
            j = self.node_index.get(nid)
            if j is not None:
                t.used0[j] = used[i]
                t.dev_used0[j] = dev_used[i]
        if delta is not None:
            for nid, alloc in delta.place:
                j = self.node_index.get(nid)
                if j is not None:
                    t.used0[j] += alloc_usage_vector(alloc)
            for nid, alloc in ([] if evicted else delta.stop):
                j = self.node_index.get(nid)
                if j is not None:
                    t.used0[j] -= alloc_usage_vector(alloc)
            if t.ev_lists is not None:
                from .tensorize import apply_evict_ops
                slot_ops = lambda grp: [  # noqa: E731
                    (j, a) for nid, a in grp
                    for j in (self.node_index.get(nid),)
                    if j is not None]
                apply_evict_ops(t, slot_ops(delta.stop),
                                slot_ops(delta.place))
        self._node_epoch += 1
        self._ev_epoch += 1
        self._row_cache.clear()
        self._drv_cache.clear()
        self._eval_cache.clear()
        self._const_cache.clear()
        self._stream_stack_cache.clear()
        self.delta_counters["repack_fallbacks"] += 1
        self._put_node_side()

    # ---------------------------------------------------------- packing
    def pack_batch(self, asks: Sequence[PlacementAsk],
                   job_keys: Optional[set] = None
                   ) -> Optional[PackedBatch]:
        """Ask-side-only pack against the resident universe.  job_keys
        overrides the same-job stream guard's key set (merge_asks
        callers pass the pre-merge keys so absorbed jobs still count)."""
        pb = self._tz.repack_asks(self.nodes, asks, self.template,
                                  gp=self.gp, kp=self.kp,
                                  drv_cache=self._drv_cache,
                                  row_cache=self._row_cache)
        if pb is not None:
            pb.job_keys = (job_keys if job_keys is not None else
                           {(a.job.namespace, a.job.id) for a in asks})
        return pb

    def pack_batch_cached(self, asks: Sequence[PlacementAsk],
                          job_keys: Optional[set] = None
                          ) -> Optional[PackedBatch]:
        return pack_batch_cached(self, asks, job_keys)

    def merge_asks(self, asks: Sequence[PlacementAsk]
                   ) -> Tuple[List[PlacementAsk], set]:
        """Throughput-mode ask dedup: asks with the SAME spec signature
        and no per-eval state collapse into one group row with the
        summed count, shrinking the [G, N] wave work by the workload's
        duplication factor.  Job-scoped soft scoring (anti-affinity,
        spread progress) is then computed over the merged population;
        the hard commit quotas stay exact, and distinct_hosts (at any
        level) / stateful asks never merge.  Returns (merged asks, job
        keys of EVERY original ask, for pack_batch's stream guard)."""
        from ..scheduler import feasible as hostfeas
        from ..structs import CONSTRAINT_DISTINCT_HOSTS
        signer = self._tz.ask_signer()
        first: Dict = {}
        counts: Dict = {}
        out: List[PlacementAsk] = []
        order: List = []
        keys = {(a.job.namespace, a.job.id) for a in asks}
        for a in asks:
            stateful = (a.penalty_nodes or a.existing_by_node
                        or a.distinct_hosts_blocked or a.spread_seed
                        or a.property_limits)
            distinct = any(
                c.operand == CONSTRAINT_DISTINCT_HOSTS
                for c in hostfeas.merged_constraints(a.job, a.tg))
            if stateful or distinct:
                out.append(a)
                continue
            sig = signer(a)
            if sig in counts:
                counts[sig] += a.count
            else:
                first[sig] = a
                counts[sig] = a.count
                order.append(sig)
        merged = [
            (first[sig] if counts[sig] == first[sig].count
             else dataclasses.replace(first[sig], count=counts[sig]))
            for sig in order]
        return merged + out, keys

    # ---------------------------------------------------------- solving
    def _solve_kw(self, batches, has_distinct: bool) -> Dict:
        return dict(has_spread=self._has_spread(batches),
                    group_count_hint=self._group_count_hint(batches),
                    max_waves=self.max_waves, wave_mode=self.wave_mode,
                    has_distinct=has_distinct,
                    has_devices=self._has_devices(batches),
                    stack_commit=self.stack_commit,
                    pallas_mode=self.pallas, shortlist_c=self.shortlist_c)

    def solve_stream(self, batches: Sequence[PackedBatch],
                     seeds: Optional[Sequence[int]] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """Solve B ask batches in one stream.

        Returns (choice [B, K, TOP_K] int, ok [B, K, TOP_K] bool,
        score [B, K, TOP_K] float, status [B, K] int, STATUS_*).
        Resource usage carries on the device: a later batch sees every
        earlier batch's placements, and the carried usage persists for
        the next call.  STATUS_RETRY placements (wave budget ran out)
        should be resubmitted in a later stream.  A job may appear in at
        most ONE batch per stream.  `seeds`: optional per-batch
        tie-break seeds (None keeps exact deterministic scoring)."""
        return unpack_stream(self.solve_stream_async(batches, seeds))

    def solve_stream_async(self, batches: Sequence[PackedBatch],
                           seeds: Optional[Sequence[int]] = None,
                           lanes: Optional[int] = None) -> torch.Tensor:
        """Dispatch a stream and return its packed result on the device
        (finish_stream unpacks it).  Not asynchronous in this package:
        the wave loop syncs with the host once per wave, so the call
        returns when every solve of the stream is done; only the fetch
        is left.

        `lanes` overrides `fused_lanes` for this call: > 1 routes a
        multi-batch stream to the lane stream (L batches a step against
        the carried usage, revalidated cross-lane, conflicts bounced to
        STATUS_RETRY).  Preemption streams always stay serial.  Each
        dispatch folds its waves, full passes and host syncs into the
        process registry (`solve.count_dispatch`)."""
        self._check_stream_jobs(batches)
        self._check_batch_axis(batches)
        has_distinct = self._has_distinct(batches)
        preempt = self._preempt_on(has_distinct)
        L = int(self.fused_lanes if lanes is None else lanes)
        if L > 1 and len(batches) > 1 and not preempt:
            return self._solve_lanes(batches, seeds, L, has_distinct)
        self.last_lane_counters = None
        stacked = self._stack_args(batches)
        n_places = [pb.n_place for pb in batches]
        seed_list = [0] * len(batches) if seeds is None else list(seeds)
        (self._used, self._dev_used, out, self.last_evict,
         self.last_waves, self.last_rescore_waves, self.last_syncs,
         self.last_graphed, self.last_captures,
         self.last_filtered, self.last_conflict_kernel) = _stream_kernel(
            self._dev_node, self._used, self._dev_used, stacked, n_places,
            seed_list, compact=self._compact, has_preempt=preempt,
            **self._solve_kw(batches, has_distinct))
        count_dispatch(self.last_waves, self.last_rescore_waves,
                       self.last_syncs, self.last_graphed,
                       self.last_captures, self.last_filtered,
                       self.last_conflict_kernel)
        return out

    def _solve_lanes(self, batches: Sequence[PackedBatch], seeds,
                     L: int, has_distinct: bool) -> torch.Tensor:
        """Lane stream dispatch: pad B up to a multiple of L with
        zero-place rows (repeating the last batch's planes: nothing
        solves, nothing commits) and run the chunked stream.  The
        revalidation counters stay on the device until lane_counters()."""
        B = len(batches)
        pad = (-B) % L
        pbs = list(batches) + [batches[-1]] * pad
        stacked = self._stack_args(pbs)
        n_places = [pb.n_place for pb in batches] + [0] * pad
        seed_list = ([0] * B if seeds is None else list(seeds)) + [0] * pad
        kw = self._solve_kw(batches, has_distinct)
        (self._used, self._dev_used, out, waves, rescores, syncs, filtered,
         conflict, bounced, committed) = _lane_stream_kernel(
            self._dev_node, self._used, self._dev_used, stacked, n_places,
            seed_list, lanes=L, compact=self._compact, **kw)
        # the padding lanes' waves and syncs too, but not as solves
        count_dispatch(waves, rescores, syncs, filtered=filtered,
                       conflict_kernel=conflict, solves=B)
        self.last_evict = None
        self.last_waves = waves[:B]
        self.last_rescore_waves = rescores[:B]
        self.last_syncs = syncs[:B]
        self.last_filtered = filtered[:B]
        self.last_conflict_kernel = conflict[:B]
        self.last_graphed = self.last_captures = np.zeros(B, np.int32)
        self.last_lane_counters = {
            "lanes": L, "chunks": (B + pad) // L,
            "bounced": bounced[:B], "committed": committed[:B]}
        return out[:B]

    def lane_counters(self) -> Optional[Dict]:
        """Fetch the last lane stream's revalidation counters:
        bounced/committed placement totals and the bounce rate the
        adaptive lane-width controller feeds on
        (fleet.LaneWidthController.record).  None after a serial
        stream."""
        lc = self.last_lane_counters
        if lc is None:
            return None
        bounced = int(lc["bounced"].sum())
        committed = int(lc["committed"].sum())
        total = bounced + committed
        return {"lanes": int(lc["lanes"]), "chunks": int(lc["chunks"]),
                "bounced": bounced, "committed": committed,
                "bounce_rate": (bounced / total) if total else 0.0}

    def _preempt_on(self, has_distinct: bool) -> bool:
        """Eviction waves run only when the planes are resident and the
        stream has no distinct_hosts groups (the pass refuses them)."""
        return ("ev_prio" in self._dev_node) and not has_distinct

    def finish_stream(self, out) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """Decode a solve_stream_async result: the method the reference's
        federated solver (ROADMAP.md item 11) overrides to merge regions;
        here it is unpack_stream."""
        return unpack_stream(out)

    def solve_stream_pipelined(self, chunks, seeds=None, pack=None,
                               deltas=None
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """The reference's wave pipeline: per chunk, apply its delta
        (`deltas[b]`, a ClusterDelta or None, through apply_delta), pack
        it (`chunks` holds PackedBatches, or ask lists packed by `pack`,
        default pack_batch_cached) and dispatch it as a one-batch
        stream; then ONE concatenated fetch for the whole stream.  Here
        a dispatch returns when its solve is done, so the host packs the
        next chunk after it, not under it.  Returns the solve_stream
        tuple; per-phase times land in last_pipeline_stats (with the
        delta apply, the bytes each dispatch shipped and the stream's
        waves and host syncs) and per-call wave counts in last_waves (a
        list)."""
        chunks = list(chunks)
        if not chunks:
            raise ValueError("solve_stream_pipelined needs >= 1 chunk")
        outs, waves, rescores, syncs, evicts = [], [], [], [], []
        graphed, captures, filtered, conflict = [], [], [], []
        pack_s = dispatch_s = delta_s = 0.0
        bytes_shipped = 0

        def _pack(chunk):
            if isinstance(chunk, PackedBatch):
                return chunk
            pb = (pack or self.pack_batch_cached)(chunk)
            if pb is None:
                raise ValueError(
                    "pipelined chunk fell outside the resident universe")
            return pb

        t0 = time.perf_counter()
        pb_next = _pack(chunks[0])
        pack_s += time.perf_counter() - t0
        for b in range(len(chunks)):
            pb = pb_next
            if deltas is not None and b < len(deltas) \
                    and deltas[b] is not None:
                t0 = time.perf_counter()
                self.apply_delta(deltas[b])
                delta_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            outs.append(self.solve_stream_async(
                [pb], seeds=None if seeds is None else [seeds[b]]))
            waves.append(self.last_waves)
            rescores.append(self.last_rescore_waves)
            syncs.append(self.last_syncs)
            graphed.append(self.last_graphed)
            captures.append(self.last_captures)
            filtered.append(self.last_filtered)
            conflict.append(self.last_conflict_kernel)
            evicts.append(self.last_evict)
            bytes_shipped += self.last_dispatch_bytes
            t1 = time.perf_counter()
            dispatch_s += t1 - t0
            if b + 1 < len(chunks):
                pb_next = _pack(chunks[b + 1])
                pack_s += time.perf_counter() - t1
        t3 = time.perf_counter()
        packed = _host(torch.cat(outs))            # ONE fetch
        fetch_s = time.perf_counter() - t3
        self.last_waves = waves
        self.last_rescore_waves = rescores
        self.last_syncs = syncs
        self.last_graphed = graphed
        self.last_captures = captures
        self.last_filtered = filtered
        self.last_conflict_kernel = conflict
        self.last_evict = evicts
        self.last_pipeline_stats = {
            "pack_s": pack_s, "dispatch_s": dispatch_s,
            "delta_apply_s": delta_s,
            "fetch_s": fetch_s, "n_dispatches": len(outs),
            "bytes_dispatched": bytes_shipped,
            "waves": _total(waves), "syncs": _total(syncs),
            "waves_graphed": _total(graphed),
            "graph_captures": _total(captures),
            "waves_conflict_kernel": _total(conflict)}
        return unpack_stream(packed)

    def solve_parallel(self, batches: Sequence[PackedBatch]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """Optimistic-parallel variant of solve_stream: all B batches
        solve against the CURRENT usage snapshot (seeds 1..B), then a
        serial revalidation commits them in order and bounces placements
        that no longer fit, STATUS_RETRY with every score slot nulled.
        Batches see each other only through the revalidation."""
        self._check_stream_jobs(batches)
        self._check_batch_axis(batches)
        stacked = self._stack_args(batches)
        n_places = [pb.n_place for pb in batches]
        kw = self._solve_kw(batches, self._has_distinct(batches))
        kw.pop("stack_commit")
        (self._used, self._dev_used, out, waves, rescores, syncs,
         graphed, captures, self.last_filtered,
         conflict) = _parallel_kernel(
            self._dev_node, self._used, self._dev_used, stacked, n_places,
            range(1, len(batches) + 1), **kw)
        count_dispatch(waves, rescores, syncs, graphed, captures,
                       self.last_filtered, conflict)
        return unpack_stream(out)

    # -------------------------------------------------------- reporting
    def wave_traffic(self, batches: Sequence[PackedBatch]) -> Dict:
        """Two-tier per-wave byte model for the current solve
        configuration: `bytes_wave1` a full-N pass (the first wave and
        every rescore escape), `bytes_rewave` a shortlist-resident
        contention wave.  `tile` is the node width one block of the
        fused kernel covers (the score kernel's stripe, the topk
        kernel's tile; the reference reports its Pallas tile there).
        Measured counters ride along under "measured" once a stream ran."""
        t = self.template
        Np, R = t.avail.shape
        Gp = max(pb.ask_res.shape[0] for pb in batches)
        K = max(pb.p_ask.shape[0] for pb in batches)
        S = t.sp_desired.shape[1]
        has_spread = self._has_spread(batches)
        hint = self._group_count_hint(batches)
        w_cap = (_MERGED_W_CAP if Gp <= MERGED_GP_MAX else _WIDE_W_CAP)
        TK = min(max(WAVE_K, min(2 * hint, w_cap)) + TOP_K, Np)
        C = (0 if self._has_distinct(batches)
             else resolve_shortlist_c(Np, TK, self.shortlist_c))
        mode = self.pallas
        if mode == "auto":
            mode = _wk.resolve_mode(Np, Gp, TK, t.sp_desired.shape[2],
                                    has_spread,
                                    on=self.device.type == "cuda")
        tile = {"score": _wk.SCORE_THREADS * _wk.SCORE_NODES,
                "topk": _wk.TOPK_TILE}.get(mode, 0)
        bytes_wave1, bytes_rewave, passes = model_wave_bytes(
            Np, Gp, K, S, R, has_spread, mode, TK, C)
        out = {"mode": mode, "tile": tile,
               "bytes_per_wave": int(bytes_wave1),
               "bytes_wave1": int(bytes_wave1),
               "bytes_rewave": int(bytes_rewave),
               "shortlist_c": int(C),
               "fused_pass_count": passes,
               "delta": dict(self.delta_counters)}
        m = self.measured_wave_counters()
        if m is not None:
            m["modeled_bytes_total"] = int(
                bytes_wave1 * m["rescore_waves"]
                + bytes_rewave * m["shortlist_waves"])
            out["measured"] = m
        return out

    def trace_attrs(self, batches: Optional[Sequence[PackedBatch]] = None
                    ) -> Dict:
        """Solve-span attributes of the last dispatched stream: the
        measured wave/rescore/shortlist counters and host syncs, the
        eviction-commit count, the resident-delta counters and, when the
        solved batches are passed, the two-tier byte model."""
        attrs: Dict = {"delta": dict(self.delta_counters)}
        m = self.measured_wave_counters()
        if m is not None:
            attrs.update(m)
        if self.last_syncs is not None:
            attrs["syncs_total"] = _total(self.last_syncs)
        ev = self.last_evict
        if ev is not None:
            evs = ev if isinstance(ev, list) else [ev]
            attrs["evict_commits"] = int(sum(
                int(_host(e).any(axis=-1).sum())
                for e in evs if e is not None))
        if batches:
            wt = self.wave_traffic(batches)
            attrs["wave_traffic"] = {k: v for k, v in wt.items()
                                     if k != "delta"}
        return attrs

    def measured_wave_counters(self) -> Optional[Dict]:
        """Waves / full-rescore waves of the last dispatched stream(s);
        shortlist_waves is the remainder, the waves that ran
        shortlist-resident."""
        if self.last_waves is None:
            return None
        waves = _total(self.last_waves)
        resc = (_total(self.last_rescore_waves)
                if self.last_rescore_waves is not None else waves)
        return {"waves_total": waves, "rescore_waves": resc,
                "shortlist_waves": waves - resc}

    def health_counters(self):
        """Fleet health reduction over the resident planes: one pass on
        the device and one fetch (telemetry.health), equal to the numpy
        `health_host` over the same template and usage."""
        from ..telemetry.health import device_health_counters
        return device_health_counters(self)

    @staticmethod
    def _has_spread(batches: Sequence[PackedBatch]) -> bool:
        return bool(any((pb.sp_col[:, 0] >= 0).any() for pb in batches))

    @staticmethod
    def _has_distinct(batches: Sequence[PackedBatch]) -> bool:
        return bool(any((pb.distinct >= 0).any() for pb in batches))

    @staticmethod
    def _has_devices(batches: Sequence[PackedBatch]) -> bool:
        return bool(any(pb.dev_ask.any() for pb in batches))

    @staticmethod
    def _group_count_hint(batches: Sequence[PackedBatch],
                          floor: int = 6) -> int:
        """Pow2-rounded largest per-group placement count across the
        stream (sizes the wave window), floored at 2**floor and capped
        at half the kernel's window cap, as the reference's."""
        m = 1
        for pb in batches:
            if pb.n_place:
                cm = pb.__dict__.get("_count_max")
                if cm is None:
                    cm = int(np.bincount(pb.p_ask[:pb.n_place]).max())
                    pb.__dict__["_count_max"] = cm
                m = max(m, cm)
        gp = max((pb.ask_res.shape[0] for pb in batches), default=0)
        cap = (_MERGED_W_CAP if gp <= MERGED_GP_MAX else _WIDE_W_CAP) // 2
        return min(1 << max(floor, (m - 1).bit_length()), cap)

    # ------------------------------------------------ dispatch internals
    def _stack_args(self, batches: Sequence[PackedBatch]) -> Dict:
        """Stack the ask planes on a leading batch axis and put them on
        the device, substituting cached device constants for the big
        [G, N] planes when every batch carries the default (all-zero
        coll0 / penalty / a_host, default host_ok).  host_ok and penalty
        otherwise ship bitpacked.

        A one-batch dispatch caches its device planes on the
        PackedBatch, keyed on the node epoch (a repack bumps it); a
        multi-batch one in a small cache keyed on the batches' identity
        (the entry holds the batches, so their ids stay theirs): a
        re-dispatched batch ships zero ask bytes.  last_dispatch_bytes
        records what each call moved."""
        B = len(batches)
        if B == 1:
            cached = batches[0].__dict__.get("_dev_stacked")
            if cached is not None and cached[0] == self._node_epoch:
                self.last_dispatch_bytes = 0
                return cached[1]
        else:
            skey = tuple(id(pb) for pb in batches)
            cached = self._stream_stack_cache.get(skey)
            if cached is not None and cached[0] == self._node_epoch:
                self.last_dispatch_bytes = 0
                return cached[2]
        dev = {}
        shipped = 0
        for name in _ASK_ARGS:
            mats = [getattr(pb, name) for pb in batches]
            if name in ("coll0", "penalty", "a_host") and not any(
                    m.any() for m in mats):
                key = (name, B)
                if key not in self._const_cache:
                    self._const_cache[key] = self._put_ask(
                        name,
                        np.zeros((B,) + mats[0].shape, mats[0].dtype))
                dev[name] = self._const_cache[key]
                continue
            if name == "host_ok" and all(
                    np.array_equal(m, self._default_host_ok)
                    for m in mats):
                key = (name, B)
                if key not in self._const_cache:
                    self._const_cache[key] = self._put_ask(
                        name, np.broadcast_to(
                            self._default_host_ok,
                            (B,) + self._default_host_ok.shape))
                dev[name] = self._const_cache[key]
                continue
            arr = (self._staged_stack(name, mats) if B > 1
                   else np.stack(mats))
            if name in ("host_ok", "penalty") and self._pack_bool_planes:
                # bitpacked words (8x fewer bytes); the uint32 bits ride
                # in int32, which _solve_steps unpacks on the device
                arr = np_pack_bool_u32(arr).view(np.int32)
            shipped += arr.nbytes
            dev[name] = self._put_ask(name, arr)
        self.last_dispatch_bytes = shipped
        self.delta_counters["bytes_dispatched_ask"] += shipped
        self.delta_counters["ask_dispatches"] += 1
        if B == 1:
            batches[0].__dict__["_dev_stacked"] = (self._node_epoch, dev)
            return dev
        if len(self._stream_stack_cache) >= 4:
            self._stream_stack_cache.pop(
                next(iter(self._stream_stack_cache)))
        self._stream_stack_cache[skey] = (self._node_epoch,
                                          tuple(batches), dev)
        return dev

    def _staged_stack(self, name: str, mats) -> np.ndarray:
        """Pow2-bucketed preallocated staging for the B > 1 stacked ask
        planes: `np.stack` allocates a fresh [B, ...] block per plane
        per round; these buffers are keyed (plane, pow2(B), row shape,
        dtype) and reused, rows copied in place.  Two buffers rotate per
        key, as the reference's (its device put may alias host memory;
        here `_put_ask` copies)."""
        B = len(mats)
        bucket = 1 << max(0, (B - 1).bit_length())
        key = (name, bucket, mats[0].shape, mats[0].dtype.str)
        ring = self._stage_cache.get(key)
        if ring is None:
            ring = [np.empty((bucket,) + mats[0].shape, mats[0].dtype),
                    np.empty((bucket,) + mats[0].shape, mats[0].dtype),
                    0]
            self._stage_cache[key] = ring
        buf = ring[ring[2]]
        ring[2] ^= 1
        for i, m in enumerate(mats):
            buf[i] = m
        return buf[:B]

    def _check_batch_axis(self, batches: Sequence[PackedBatch]) -> None:
        """A full repack can change the padded node axis; batches packed
        before it carry [G, Np_old] planes and must be re-packed."""
        Np = self.template.avail.shape[0]
        for pb in batches:
            if pb.host_ok.shape[1] != Np:
                raise ValueError(
                    "PackedBatch predates a full repack (node axis "
                    f"{pb.host_ok.shape[1]} != {Np}); re-pack its asks")

    @staticmethod
    def _check_stream_jobs(batches: Sequence[PackedBatch]) -> None:
        seen: set = set()
        for pb in batches:
            keys = getattr(pb, "job_keys", None)
            if keys:
                overlap = seen & keys
                if overlap:
                    raise ValueError(
                        f"job {overlap} appears in multiple batches of "
                        "one stream; job-scoped state (distinct_hosts, "
                        "anti-affinity, spread) would not be visible "
                        "across them")
                seen |= keys

    @staticmethod
    def compile_count() -> int:
        """The reference's compile-cache probe; -1, its value for "probe
        unavailable": nothing here is traced or cached by shape."""
        return -1

    # ------------------------------------------------------------ state
    def usage(self) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch the carried usage (copies: a later in-place delta never
        reaches what this returned)."""
        return np.array(_host(self._used)), np.array(_host(self._dev_used))

    def plane_checksum(self) -> int:
        """Fingerprint of the card-resident node planes (one fetch).
        Equals tensorize.template_checksum(self.template) whenever the
        delta scatters and repacks landed the planes on the host
        template bit for bit."""
        from .tensorize import plane_crc
        t = self.template
        dn = self._dev_node
        meta = f"{t.n_real}:{','.join(t.node_ids)}".encode()
        return plane_crc(dn["avail"], dn["reserved"], dn["valid"],
                         dn["node_dc"], dn["attr_rank"], dn["dev_cap"],
                         ev_prio=dn.get("ev_prio"),
                         ev_res=dn.get("ev_res"), meta=meta)

    def reset_usage(self, used0: Optional[np.ndarray] = None,
                    dev_used0: Optional[np.ndarray] = None) -> None:
        t = self.template
        self._used = self._put_node(
            "used", t.used0 if used0 is None else used0)
        self._dev_used = self._put_node(
            "dev_used", t.dev_used0 if dev_used0 is None else dev_used0)
