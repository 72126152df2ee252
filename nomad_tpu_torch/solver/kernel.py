"""The placement solve on one device, in torch.

The counterpart of `nomad_tpu.solver.kernel.solve_kernel`: the reference's
per-placement iterator chain (scheduler/stack.go:107 Select ->
feasible.go checks -> rank.go scoring -> select.go limit/max) recast as
dense tensor math over the whole node axis:

  static feasibility mask  [G, N]   (constraints, dc, host-evaluated ops)
  wave loop: batched [G, N] scoring -> per-group top-k -> parallel commit

Every wave scores all (group, node) pairs against current usage (the
fused CUDA wave kernel, or the spec-driven torch scorer), ranks each
group's remaining placements onto its best candidates, and commits every
assignment that survives the same-wave conflict checks (cumulative
capacity per node, distinct_hosts, spread quotas).  Losers retry next
wave against refreshed usage.  Contention waves re-rank a carried
per-group shortlist instead of re-reading the [G, N] planes whenever the
validity triggers prove the result identical to a full rescore.

Torch idiom in place of the reference's JAX: Python control flow where
the reference has `lax.scan` / `lax.cond` (the loop ends at the first wave
with nothing left to decide; `n_waves` counts executed wave bodies), a
written-out group dimension where it has `vmap`, stable sorts where it
relies on `lax.top_k` / `lax.sort` tie order, and accumulating
`index_put` where it scatters with `.at[].add`.  The reference's
`approx_max_k` (approximate only on a TPU) is an exact top-k here.

With `has_preempt` each wave ends with the reference's eviction pass:
groups with nothing placeable pick, per feasible node, a min-cost set of
lower-priority victims from the node's eviction planes, rank nodes by
the post-eviction bin-pack score and commit (place, evict) pairs through
the same conflict checks.

The wave loop is a generator, `solve_steps`, that stops at the two
decisions the reference makes lane-uniform under its lane axis (carried
shortlist wave or full pass; rerank or skip) and takes each decision
from its caller: `solve_kernel` answers with the solve's own
predicates, `solve_lanes` advances L solves one wave at a time with the
reference's psum rules.  Both wave modes ("scan", "while") run the same
loop, which ends at the first wave with nothing left to decide, as the
reference's while loop does.  `delta_scatter_set` / `delta_scatter_add`
write rows into card-resident planes in place.

`learned` and `region_bias` ([Gp, Np] f32 planes, precomputed outside
the solve) append one more scorer each (`score_spec.combine_learned` /
`combine_region`).  Only the spec-driven torch scorer implements them,
as in the reference: with either plane the shortlist is off and the
wave scorer is "off" whatever `pallas_mode` asks, so no CUDA kernel is
ever handed a plane.

In mesh mode (`mesh_axis`) the node axis is split over S shards: every
[.., Np, ..] argument is one shard's local plane, scoring, extraction and
the shortlist stay on the shard, and only per-group candidate keys
(score, global node id) and K-sized integer vectors cross shards.  The
generator then also yields the reference's collectives as requests:
("axis_index", axis) for the shard's linear index, ("psum", x) for an
integer sum over the mesh and ("merge", s, i, k) for the exact
(score desc, global id asc) top-k of every shard's window.
`solve_shards` drives the S generators in lock-step and answers them,
the counterpart of the reference's `shard_map`.

The wave body is a chain of segment functions over explicit inputs
(`_Inputs`, `_Carry`): `_wave_prep`, the fused kernel (`_wave_scores`),
`_wave_body` up to the rerank decision, and `_wave_rerank`.  A solve
driven alone (`single_lane`) on a CUDA device, with the fused kernel and
without the eviction pass or a mesh, replays them as CUDA graphs once
its signature repeats (`_GraphWaves`, `wave_graph`): the kernel itself
is still called each full pass, and the host waits once a wave, for the
wave's flags (its next entry test and the carried window's premise),
and once more after a rerank.
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import score_spec as _score_spec
from . import seg_kernel as _sk
from . import wave_graph
from . import wave_kernel as _wk
from ..utils.tracing import (NULL_SPAN, SOLVE_PROLOGUE, WAVE_CARRIED,
                             WAVE_FULL, WAVE_SYNC, device_range)
from .masks import pack_bool_u32
from .tensorize import (OP_EQ, OP_GE, OP_GT, OP_IS_SET, OP_LE, OP_LT, OP_NE,
                        OP_NOT_SET, R_CPU, R_MEM)

TOP_K = 4
WAVE_K = 32       # min per-group wave width; scales up with batch size
MAX_WAVES = 12    # wave budget per solve
NEG_INF = _score_spec.NEG_INF
# victim eligibility gate: the ask's priority must exceed the victim's by
# at least this (scheduler/preemption.PRIORITY_DELTA, kept here so the
# device module imports nothing of the scheduler; pinned equal by a test)
EV_PRIORITY_DELTA = 10
# test hook: force the sort-based conflict path at small K
_FORCE_SORT_CONFLICTS = False
# value-vocabulary size up to which spread lookups are select-sums
_SELECT_SUM_MAX_V = 16
_TORCH_OPS = _score_spec.TorchOps(select_sum_max_v=_SELECT_SUM_MAX_V)
#: node-axis width from which the reference's TPU kernel extracts with
#: `approx_max_k` (its `_APPROX_MIN_NP`, nomad_tpu/solver/kernel.py:65).
#: The port's top-k stays exact at every width; `host.prefer_host` keeps
#: this bound so that both packages route a problem alike
_APPROX_MIN_NP = 4096
# group-count at or below which a batch is treated as "merged few-group"
MERGED_GP_MAX = 16
# per-group candidate-window caps (wave width W <= cap)
_MERGED_W_CAP = 1024
_WIDE_W_CAP = 256
_SHORTLIST_TILE = 128          # auto shortlist width rounds up to this
_U32 = 0xFFFFFFFF


def _rows_like(arr: torch.Tensor, idx, rows):
    idx = torch.as_tensor(idx).to(arr.device, torch.int64)
    rows = torch.as_tensor(rows).to(arr.device, arr.dtype)
    return idx, rows


def delta_scatter_set(arr: torch.Tensor, idx, rows) -> torch.Tensor:
    """Row "set" into a card-resident plane, in place (`arr[idx] =
    rows`; the reference's donated `.at[idx].set`).  A repeated index
    must carry identical rows: `apply_delta` pads by repeating row 0."""
    i, r = _rows_like(arr, idx, rows)
    return arr.index_put_((i,), r)


def delta_scatter_add(arr: torch.Tensor, idx, rows) -> torch.Tensor:
    """Row "add" into a card-resident plane, in place; repeated indices
    accumulate (`apply_delta` pads with zero rows at index 0)."""
    i, r = _rows_like(arr, idx, rows)
    return arr.index_put_((i,), r, accumulate=True)


def _op_eval(vals: torch.Tensor, op: torch.Tensor, rank: torch.Tensor
             ) -> torch.Tensor:
    """Evaluate vectorizable constraint ops.

    vals: [..., N, C] node value ranks (-1 missing); op/rank: [..., C].
    Semantics mirror scheduler/feasible.go:671 checkConstraint — note
    `!=` passes when the attribute is missing.
    """
    op = op.unsqueeze(-2)
    rank = rank.unsqueeze(-2)
    found = vals >= 0
    eq = found & (vals == rank)
    res = torch.ones_like(found)
    res = torch.where(op == OP_EQ, eq, res)
    res = torch.where(op == OP_NE, ~eq, res)
    res = torch.where(op == OP_LT, found & (vals < rank), res)
    res = torch.where(op == OP_LE, found & (vals <= rank), res)
    res = torch.where(op == OP_GT, found & (vals > rank), res)
    res = torch.where(op == OP_GE, found & (vals >= rank), res)
    res = torch.where(op == OP_IS_SET, found, res)
    res = torch.where(op == OP_NOT_SET, ~found, res)
    return res


class SolveResult(NamedTuple):
    choice: torch.Tensor        # [K, TOP_K] node indices, best first
    choice_ok: torch.Tensor     # [K, TOP_K] bool (feasible + fits)
    score: torch.Tensor         # [K, TOP_K] final normalized scores
    n_feasible: torch.Tensor    # [K] feasible node count at commit wave
    n_exhausted: torch.Tensor   # [K] feasible but resource-exhausted
    dim_exhausted: torch.Tensor  # [K, R] counts per exhausted dimension
    feas: torch.Tensor          # [G, N] static feasibility mask
    cons_filtered: torch.Tensor  # [G, C] nodes filtered per constraint slot
    used_final: torch.Tensor    # [N, R] resource usage after all commits
    dev_used_final: torch.Tensor  # [N, D] device usage after all commits
    n_waves: int                # wave bodies executed
    unfinished: torch.Tensor    # [K] active but undecided after the budget
    n_rescore: int = 0          # waves that ran the full-N pass
    evict: torch.Tensor = None  # [K, E] victim slots of placements the
    #  eviction pass committed (None without has_preempt)
    commit_wave: torch.Tensor = None  # [K] wave each placement committed
    #  on, -1 = none (None without has_preempt): evictions make usage
    #  non-monotone, so the host fixup replays commits in wave order
    n_syncs: int = 0            # times the wave loop waited for the card
    n_graphed: int = 0          # waves whose body replayed a CUDA graph
    n_conflict_kernel: int = 0  # waves whose conflict check and commits
    #  ran on the node-segmented CUDA kernels (`seg_kernel`)
    n_captures: int = 0         # CUDA graphs the solve captured
    filtered_pairs: int = 0     # real [group, node] pairs the static
    #  feasibility rules out (groups with placements, valid nodes; 0 in
    #  mesh mode and without a wave)


class _WaveRanges:
    """A wave solve's profiler ranges (`utils.tracing.device_range`) and
    its count of host syncs.  `prologue()` opens `nomad.solve.prologue`
    at the solve's entry, for `close()` to end before the first wave;
    `sync()` counts one sync and returns its `nomad.wave.sync` range, to
    be held around the blocking call alone; `step(carried)` ends the
    open wave range and opens the next one at a wave's carried-window
    decision, `nomad.wave.carried` for a carried-shortlist wave and
    `nomad.wave.full` for a full pass; `close()` ends the last.  A
    wave's range so runs from its decision to the next wave's, and holds
    the next wave's entry test.  With `on` False nothing opens; syncs
    still count."""

    __slots__ = ("on", "syncs", "_open")

    def __init__(self, on: bool):
        self.on = on
        self.syncs = 0
        self._open = NULL_SPAN

    def sync(self):
        self.syncs += 1
        return device_range(WAVE_SYNC) if self.on else NULL_SPAN

    def prologue(self) -> None:
        self._enter(SOLVE_PROLOGUE)

    def step(self, carried: bool) -> None:
        self.close()
        self._enter(WAVE_CARRIED if carried else WAVE_FULL)

    def _enter(self, name: str) -> None:
        if self.on:
            self._open = device_range(name)
            self._open.__enter__()

    def close(self) -> None:
        self._open.__exit__(None, None, None)
        self._open = NULL_SPAN


class _SLState(NamedTuple):
    """Wave-loop carry for the shortlist-resident contention path (the
    reference's `_SLState`): per-entry planes gathered at the last full
    wave, the era cutoff key, and the next wave's pre-computed window,
    tables and counters, which the loop's host flag (the reference's
    `ok`) allows the next wave to use."""
    idx: torch.Tensor           # [Gp, C] node ids, ascending
    feas: torch.Tensor          # [Gp, C] static feasibility
    pen: torch.Tensor           # [Gp, C] penalty flag
    aff: torch.Tensor           # [Gp, C] affinity score
    vn: torch.Tensor            # [S, Gp, C] spread value ranks
    de: torch.Tensor            # [S, Gp, C] spread desired counts
    coll: torch.Tensor          # [Gp, C] own-group collocation counts
    cut_s: torch.Tensor         # [Gp] era cutoff score
    cut_i: torch.Tensor         # [Gp] era cutoff node id
    comp: torch.Tensor          # [Gp] shortlist holds ALL placeable
    nfeas: torch.Tensor         # [Gp] n_feasible for the next wave
    nexh: torch.Tensor          # [Gp] n_exhausted for the next wave
    ndim: torch.Tensor          # [Gp, R] dim_exhausted for the next wave
    win_s: torch.Tensor         # [Gp, TKl] next wave's window scores
    win_i: torch.Tensor         # [Gp, TKl] next wave's window nodes
    tb_s: torch.Tensor          # [Gp, V+1, TW] next wave's value tables
    tb_i: torch.Tensor          # ([Gp, 1, 1] dummies when tables off)
    gany: torch.Tensor          # [Gp] next wave's grp_any


def resolve_shortlist_c(Np: int, TK: int, requested: int = 0) -> int:
    """Shortlist width C for a solve (0 = path disabled): 0 auto-sizes to
    the candidate window TK rounded up to the next _SHORTLIST_TILE
    multiple (clamped to the node axis), -1 disables, explicit values
    are validated and never clamped (the reference's rule).
    NOMAD_TPU_SHORTLIST_C feeds this via ResidentSolver."""
    if requested == -1:
        return 0
    if requested in (0, None):
        return min(Np, (TK // _SHORTLIST_TILE + 1) * _SHORTLIST_TILE)
    if not isinstance(requested, int) or requested < TOP_K:
        raise ValueError(
            f"shortlist_c={requested!r} invalid: must be -1 (off), 0 "
            f"(auto) or an int >= TOP_K ({TOP_K})")
    if requested % 8:
        raise ValueError(
            f"shortlist_c={requested} invalid: must be a multiple of 8 "
            "(vector lane alignment)")
    if requested > Np:
        raise ValueError(
            f"shortlist_c={requested} exceeds the padded node axis "
            f"({Np}); pick <= Np — it will not be clamped silently")
    if requested < TK:
        raise ValueError(
            f"shortlist_c={requested} is narrower than the candidate "
            f"window TK={TK} for this problem shape; the shortlist "
            "could not fill a single wave's window. Pass a value >= TK "
            "or 0 for auto sizing")
    return requested


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    without an int64 overflow: the uint32 wrap of the reference's
    hashes."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _jitter_salt(gs: torch.Tensor, seed: int) -> torch.Tensor:
    """The jitter's per-group salt [Gp] for groups `gs`: the seed hashed
    into each group's id, on the card."""
    return (_mul32(gs, 7919) + (seed & _U32)) & _U32


def _jitter(gid: torch.Tensor, gsalt: torch.Tensor) -> torch.Tensor:
    """Seeded tie-break jitter for node ids `gid` [Gp, *] under the
    per-group salts `gsalt` [Gp] (`_jitter_salt`): the reference's
    uint32 hash, (h & 1023) * SCORE_BIN / 1023.  The step is an f32
    filled on the card, as the reference folds its literal in."""
    h = (_mul32(gid & _U32, 2654435761)
         + _mul32(gsalt, 40503)[:, None]) & _U32
    h = _mul32(h ^ (h >> 16), 2246822519)
    step = torch.full((), _score_spec.SCORE_BIN / 1023.0,
                      dtype=torch.float32, device=gid.device)
    return (h & 1023).to(torch.float32) * step


def _lex_topk(score: torch.Tensor, idx: torch.Tensor, k: int):
    """Descending (score, ascending node id) top-k along the last axis:
    the reference's two-key `lax.sort((-score, idx), num_keys=2)`.  Two
    stable sorts, ids first; `0.0 - score` maps -0.0 and 0.0 to one
    key, as the reference's sort does."""
    o1 = torch.argsort(idx, dim=-1, stable=True)
    s1 = torch.gather(score, -1, o1)
    i1 = torch.gather(idx, -1, o1)
    o2 = torch.argsort(0.0 - s1, dim=-1, stable=True)[..., :k]
    return torch.gather(s1, -1, o2), torch.gather(i1, -1, o2)


def _top_rows(score: torch.Tensor, k: int):
    """Exact top-k of each [.., Np] row with ties to the lower column
    (lax.top_k's order; the reference's approx_max_k is exact off-TPU)."""
    cols = torch.arange(score.shape[-1], dtype=torch.int32,
                        device=score.device).expand(score.shape)
    o = torch.argsort(0.0 - score, dim=-1, stable=True)[..., :k]
    return torch.gather(score, -1, o), torch.gather(cols, -1, o)


def _gid_top(score: torch.Tensor, gid: torch.Tensor, k: int):
    """Top-k of each [.., Np] row in (score desc, global id asc) order,
    where `gid` [Np] gives each column's global node id (the elastic
    layout's local order is not id order).  Returns (score, gid, local
    column), the reference's three-operand `lax.sort` carrying the
    slot."""
    o1 = torch.argsort(gid, stable=True)
    so = score[..., o1]
    o2 = torch.argsort(0.0 - so, dim=-1, stable=True)[..., :k]
    col = o1[o2]
    return torch.gather(so, -1, o2), gid[col], col


def _add_drop(arr: torch.Tensor, idx, vals, dim: int = 0) -> torch.Tensor:
    """`arr` with `vals` accumulated at `idx` (a tuple of index tensors),
    where an index equal to arr.shape[dim] adds nothing: the reference's
    `.at[].add(mode="drop")` at the pinned slot Np, never a clamp onto
    row Np - 1.  A dropped entry adds an exact zero to index 0."""
    drop = idx[dim] >= arr.shape[dim]
    idx = idx[:dim] + (idx[dim].masked_fill(drop, 0),) + idx[dim + 1:]
    keep = (~drop).reshape(drop.shape + (1,) * (vals.dim() - drop.dim()))
    return arr.index_put(idx, torch.where(keep, vals, 0), accumulate=True)


def static_feas(valid, node_dc, attr_rank, dc_ok, host_ok, c_op, c_col,
                c_rank):
    """Static feasibility of every (ask, node) pair: valid node, allowed
    datacenter, host-evaluated ops and every vectorized constraint.
    Returns (feas [Gp, Np] bool, cons_filtered [Gp, C] i32: nodes each
    constraint slot filtered, credited to the first slot that fails).
    Shared by `solve_kernel` and the system scheduler's `_feas_kernel`
    (`masks.py`)."""
    i32, i64 = torch.int32, torch.int64
    Gp, Np = host_ok.shape
    vals = attr_rank.to(i64)[:, c_col.to(i64)].permute(1, 0, 2)  # [Gp, Np, C]
    ok = _op_eval(vals, c_op, c_rank)
    base = valid[None, :] & dc_ok[:, node_dc.to(i64)] & host_ok
    passed_prev = torch.cumprod(torch.cat(
        [torch.ones((Gp, Np, 1), dtype=i32, device=valid.device),
         ok[:, :, :-1].to(i32)], dim=2), dim=2).bool()
    first_fail = base[:, :, None] & passed_prev & ~ok
    return base & ok.all(dim=2), first_fail.sum(dim=1).to(i32)


def evict_pass(used, evt, want_g, *, ask_res, avail, reserved, feas,
               ev_slot_ok, ev_res, ev_prio, dev=None, ids=None, syncs):
    """The eviction pass of one wave, against post-commit usage `used`
    [Np, R], for the groups in `want_g` [Gp] (the rest keep no option):
    per (group, node) a greedy min-cost victim set over the node's free
    eviction slots (`ev_slot_ok` [Gp, Np, E] and not yet taken in `evt`
    [Np, E]; the float-order twin of scheduler/preemption.
    victim_distance), the redundancy prune (prune_superset order), then
    each group's best node by post-eviction bin-pack score, ties to the
    lower id.  `dev` = (dev_used, dev_cap, dev_ask): device instances
    are never evicted, so the node must fit the device ask as it is.
    `ids` [Np] (mesh mode) are the rows' global node ids: ties then go
    to the lower global id and the returned node is that id, while the
    freed vector and victim mask are the local best row's.  Returns per
    group (score [Gp], node [Gp], freed [Gp, R], victim mask [Gp, E]); a
    group without an option scores NEG_INF.  `syncs` (the caller's
    `_WaveRanges`) counts and ranges the pass's one host sync."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    device = used.device
    Gp, (Np, R), EV = want_g.shape[0], used.shape, ev_prio.shape[1]
    nv_s = torch.full((Gp,), NEG_INF, dtype=f32, device=device)
    nv_i = torch.zeros(Gp, dtype=i64, device=device)
    sel_freed = torch.zeros((Gp, R), dtype=f32, device=device)
    sel_mask = torch.zeros((Gp, EV), dtype=torch.bool, device=device)
    with syncs.sync():
        wg = torch.nonzero(want_g)
    wg = wg.flatten()                                      # groups to solve
    Gw = wg.shape[0]
    es = torch.arange(EV, device=device)
    rows = torch.arange(Np, device=device)[None, :]
    ask_w = ask_res[wg]
    # shortfall base: usage + ask - capacity, per (g, n)
    base_short = (used[None, :, :] + ask_w[:, None, :]
                  - avail[None, :, :])                     # [Gw, Np, R]
    slot_free = ev_slot_ok[wg] & ~evt[None, :, :]         # [Gw, Np, E]
    freed = torch.zeros((Gw, Np, R), dtype=f32, device=device)
    picked = torch.zeros((Gw, Np, EV), dtype=torch.bool, device=device)
    prank = torch.full((Gw, Np, EV), EV, dtype=i32, device=device)
    for t in range(EV):
        s = torch.clamp(base_short - freed, min=0.0)
        covered = (s <= 0.0).all(dim=-1)
        norm = torch.clamp(s, min=1.0)
        # the distance one dimension at a time (one [Gw, Np, E] plane
        # live per term, not a [Gw, Np, E, R] one), summed in the
        # reference's explicit order (part of the float contract)
        d2 = []
        for r in range(R):
            d = (s[:, :, None, r] - ev_res[None, :, :, r]) \
                / norm[:, :, None, r]
            d2.append(d * d)
        dist = torch.sqrt(((d2[0] + d2[1]) + d2[2]) + d2[3])
        del d2
        cand_e = slot_free & ~picked
        dist = torch.where(cand_e, dist, 1e30)
        e_star = torch.argmin(dist, dim=-1)                # first min wins
        take = cand_e.any(dim=-1) & ~covered
        oh = (es == e_star[..., None]) & take[..., None]
        picked = picked | oh
        prank = torch.where(oh, t, prank)
        freed = freed + torch.where(take[..., None],
                                    ev_res[rows, e_star], 0.0)
    # redundancy prune: highest-priority victims first, pick order on
    # ties
    key = torch.where(picked,
                      (32768 - ev_prio[None, :, :]) * (EV + 1) + prank,
                      2 ** 30)
    seq = torch.argsort(key, dim=-1, stable=True)
    for t in range(EV):
        e_t = seq[..., t]
        oh = es == e_t[..., None]
        is_p = (picked & oh).any(dim=-1)
        trial = freed - ev_res[rows, e_t]
        still = ((base_short - trial) <= 0.0).all(dim=-1)
        drop = is_p & still
        picked = picked & ~(oh & drop[..., None])
        freed = torch.where(drop[..., None], trial, freed)
    covered_f = ((base_short - freed) <= 0.0).all(dim=-1)
    ok_node = covered_f & picked.any(dim=-1) & feas[wg]
    if dev is not None:
        dev_used, dev_cap, dev_ask = dev
        ok_node = ok_node & (dev_used[None, :, :] + dev_ask[wg][:, None, :]
                             <= dev_cap[None, :, :]).all(dim=-1)
    after = used[None, :, :] + ask_w[:, None, :] - freed
    binpack = _score_spec.rescore_binpack(_TORCH_OPS, after, avail,
                                          reserved)
    ev_score = torch.where(ok_node, binpack, NEG_INF)
    if ids is None:
        b_s, b_i = _top_rows(ev_score, 1)
        best = b_i[:, 0].to(i64)
        key = best
    else:
        b_s, key, best = _gid_top(ev_score, ids, 1)
        key, best = key[:, 0].to(i64), best[:, 0]
    gw = torch.arange(Gw, device=device)
    nv_s[wg] = b_s[:, 0]
    nv_i[wg] = key
    sel_freed[wg] = freed[gw, best]
    sel_mask[wg] = picked[gw, best]
    return nv_s, nv_i, sel_freed, sel_mask


def _exact_matmul_on(device: torch.device) -> None:
    # the same-wave conflict check sums integer resource asks with an
    # f32 [K, K] @ [K, R] product; TF32 would round those sums, so the
    # CUDA path pins full-precision f32 matmuls
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def solve_kernel(*args, lane_axis=None, **kw) -> SolveResult:
    """The one-device wave solve over tensors on one device (arguments
    as `solve._kernel_args` lays them out, keywords as `solve_steps`
    takes them): one lane, so each lane-uniform decision is the solve's
    own predicate.  Solves in lock-step go through `solve_lanes`, not
    `lane_axis`; a solve split over a mesh (`mesh_axis`) goes through
    `solve_shards`."""
    if lane_axis is not None:
        raise NotImplementedError(
            "solve_kernel: lane_axis is not part of the torch port; drive "
            "the lanes' solve_steps through solve_lanes")
    if kw.get("mesh_axis") is not None:
        raise ValueError("solve_kernel: a mesh-mode solve (mesh_axis) is "
                         "driven by solve_shards")
    return solve_lanes([solve_steps(*args, single_lane=True, **kw)])[0]


def solve_lanes(lanes) -> list:
    """Advance L solves (`solve_steps` generators) one wave at a time and
    return their SolveResults: the reference's lock-stepped lanes (a vmap
    over `lane_axis`).  At each wave's start every live lane offers its
    carried-window flag and all take the carried window only when every
    lane of the chunk has one; a lane that has finished (or never ran,
    a padding lane) counts as one without, since its last wave left
    nothing active and so no window.  At each wave's end all rerank when
    any lane asks to.  A finished lane is frozen, so its waves and
    rescores stop counting.

    One lane opens its own profiler ranges.  Several lanes open none
    (their `solve_steps` run with `wave_ranges=False`): ranges held
    across a yield would interleave on this thread, so `solve_lanes`
    opens one wave range for each lock-stepped wave, from its
    carried-window decision to the next one.  Without the shortlist no
    request marks a wave, and no wave range opens."""
    lanes = list(lanes)
    msgs, results = {}, [None] * len(lanes)
    ranges = _WaveRanges(len(lanes) > 1)

    def advance(ln, value):
        try:
            msgs[ln] = (next(lanes[ln]) if value is None
                        else lanes[ln].send(value))
        except StopIteration as stop:
            msgs.pop(ln, None)
            results[ln] = stop.value

    for ln in range(len(lanes)):
        advance(ln, None)
    while msgs:
        kinds = {m[0] for m in msgs.values()}
        if len(kinds) != 1:
            raise RuntimeError(f"solve_lanes: lanes out of step: {kinds}")
        kind = kinds.pop()
        if kind not in ("carried", "rerank"):
            raise RuntimeError(f"solve_lanes: a lane asked for {kind!r}; "
                               "mesh-mode solves go through solve_shards")
        if kind == "carried":
            take = (len(msgs) == len(lanes)
                    and all(p for _, p in msgs.values()))
            ranges.step(take)
        else:
            take = any(p for _, p in msgs.values())
        for ln in list(msgs):
            advance(ln, take)
    ranges.close()
    return results


def _mesh_tiers(mesh):
    """(devices in linear shard order, group sizes innermost first) of a
    mesh: a grid of torch.devices (`mesh.devices`, a numpy object array)
    whose axes are ("nodes",), ("hosts", "chips") or ("regions",
    "hosts", "chips")."""
    grid = np.asarray(mesh.devices, dtype=object)
    return list(grid.reshape(-1)), list(grid.shape)[::-1]


def _replicate(x: torch.Tensor, devices) -> list:
    """x on each shard's device, one copy per distinct device."""
    per_dev = {x.device: x}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in per_dev:
            per_dev[d] = x.to(d)
        out.append(per_dev[d])
    return out


def _tiered(parts, sizes, reduce_group):
    """Reduce `parts` (one per shard, linear order) tier by tier: groups
    of sizes[0] consecutive parts (the chips of a host), then groups of
    sizes[1] of those (the hosts of a region), and so on, each group on
    its first member's device."""
    level = list(parts)
    for n in sizes:
        level = [reduce_group([p.to(level[j * n].device)
                               for p in level[j * n:(j + 1) * n]],
                              top=len(level) == n)
                 for j in range(len(level) // n)]
    return level[0]


def solve_shards(shards, mesh) -> list:
    """Advance S mesh-mode solves (`solve_steps` generators with
    `mesh_axis`, in the mesh's linear shard order) in lock-step and
    return their SolveResults: the reference's `shard_map` of
    `solve_kernel`.  Requests are answered across the shards' devices:

      ("axis_index", axis)  the shard's linear index;
      ("psum", x)           the sum of the S integer tensors, chips of a
                            host first, then hosts, then regions (the
                            reference's `_psum_mesh` order; integer sums
                            are exact in any order);
      ("merge", s, i, k)    the top-k of the concatenated windows in
                            (score desc, global id asc) order, merged per
                            host, then per region, then across regions
                            (`_merge_mesh`): each tier keeps the top
                            min(k, width) of its members, so the result
                            equals the flat mesh's;
      ("carried", ok) / ("rerank", p)  the shard's own predicate: the
                            reference takes these decisions per shard.

    A result's replicated fields (choices, counters) are equal on every
    shard; `feas` and the usage planes are each shard's own.  The shards
    open no profiler ranges (mesh mode turns them off): `solve_shards`
    opens one wave range for each lock-stepped wave at the carried
    decisions, as `solve_lanes` does, full when any shard runs its full
    pass."""
    shards = list(shards)
    devices, sizes = _mesh_tiers(mesh)
    S = len(shards)
    if len(devices) != S:
        raise ValueError(f"solve_shards: {S} shards on a mesh of "
                         f"{len(devices)} devices")
    msgs: dict = {}
    results = [None] * S

    def advance(i, value, first=False):
        try:
            msgs[i] = next(shards[i]) if first else shards[i].send(value)
        except StopIteration as stop:
            msgs.pop(i, None)
            results[i] = stop.value

    def psum_group(parts, top):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    ranges = _WaveRanges(True)
    for i in range(S):
        advance(i, None, first=True)
    while msgs:
        if len(msgs) != S:
            raise RuntimeError("solve_shards: shards out of step "
                               f"({len(msgs)} of {S} still running)")
        kinds = {m[0] for m in msgs.values()}
        if len(kinds) != 1:
            raise RuntimeError(f"solve_shards: shards out of step: {kinds}")
        kind = kinds.pop()
        if kind == "axis_index":
            answers = list(range(S))
        elif kind in ("carried", "rerank"):
            answers = [msgs[i][1] for i in range(S)]
            if kind == "carried":
                ranges.step(all(answers))
        elif kind == "psum":
            if msgs[0][1].is_floating_point():
                # every sum of the reference's mesh path is of integers,
                # exact in any order; a float sum would have to keep its
                # reduction order
                raise TypeError("solve_shards: psum of a float tensor")
            answers = _replicate(
                _tiered([msgs[i][1] for i in range(S)], sizes, psum_group),
                devices)
        elif kind == "merge":
            k = msgs[0][3]

            def merge_group(parts, top):
                s_ = torch.cat([p[0] for p in parts], dim=-1)
                i_ = torch.cat([p[1] for p in parts], dim=-1)
                return _MergeKeys(*_lex_topk(
                    s_, i_, k if top else min(k, s_.shape[-1])))
            merged = _tiered([_MergeKeys(msgs[i][1], msgs[i][2])
                              for i in range(S)], sizes, merge_group)
            answers = list(zip(_replicate(merged.s, devices),
                               _replicate(merged.i, devices)))
        else:
            raise RuntimeError(f"solve_shards: unknown request {kind!r}")
        for i in range(S):
            advance(i, answers[i])
    ranges.close()
    return results


class _MergeKeys(NamedTuple):
    """A candidate-key window (scores, global ids) moving through the
    merge tiers."""
    s: torch.Tensor
    i: torch.Tensor

    @property
    def device(self):
        return self.s.device

    def to(self, device):
        return _MergeKeys(self.s.to(device), self.i.to(device))


class _Inputs(NamedTuple):
    """A solve's wave-invariant tensors, as the wave segments read them
    (None where the solve's options leave one out)."""
    avail: torch.Tensor             # [Np, R]
    reserved: torch.Tensor          # [Np, R]
    valid: torch.Tensor             # [Np]
    attr_rank: torch.Tensor         # [Np, A]
    attr_rank_l: torch.Tensor       # the same, int64
    ask_res: torch.Tensor           # [Gp, R]
    ask_desired: torch.Tensor       # [Gp]
    distinct: torch.Tensor          # [Gp]
    coll0: torch.Tensor             # [Gp, Np]
    penalty: torch.Tensor           # [Gp, Np]
    feas: torch.Tensor              # [Gp, Np] static feasibility
    aff_score: torch.Tensor         # [Gp, Np]
    sp_col: torch.Tensor            # [Gp, S]
    sp_weight: torch.Tensor         # [Gp, S]
    sp_targeted: torch.Tensor       # [Gp, S]
    sp_desired: torch.Tensor        # [Gp, S, V]
    sp_implicit: torch.Tensor       # [Gp, S]
    sp_vnode: Optional[torch.Tensor]    # [S, Gp, Np] value ranks
    sp_des: Optional[torch.Tensor]      # [S, Gp, Np] desired counts
    dev_cap: torch.Tensor           # [Np, D]
    dev_ask: torch.Tensor           # [Gp, D]
    g_idx: torch.Tensor             # [K] each placement's group
    in_batch: torch.Tensor          # [K] ks < n_place
    g_off: torch.Tensor             # [Gp] rank-wrap rotation offsets
    gsalt: torch.Tensor             # [Gp] jitter salts
    jitter: torch.Tensor            # [Gp, Np]
    pk_feas: Optional[torch.Tensor]     # fused kernel: packed planes
    pk_pen: Optional[torch.Tensor]
    pk_sp_has: Optional[torch.Tensor]
    pk_vnode: Optional[torch.Tensor]
    learned: Optional[torch.Tensor]     # [Gp, Np] extra scorers
    region_bias: Optional[torch.Tensor]
    ev_slot_ok: Optional[torch.Tensor]  # has_preempt: eviction planes
    ev_res_f: Optional[torch.Tensor]
    ev_prio_i: Optional[torch.Tensor]
    ks: torch.Tensor                # [K] arange
    gs: torch.Tensor                # [Gp] arange
    offs_k: torch.Tensor            # [TOP_K] arange
    no_tab_s: torch.Tensor          # [Gp, 1, 1] empty value tables
    no_tab_i: torch.Tensor


class _Carry(NamedTuple):
    """The wave loop's carried state: usage, the committed outputs, the
    shortlist's carry (`_SLState`, None with the shortlist off) and, with
    has_preempt, the taken eviction slots and the eviction outputs."""
    used: torch.Tensor          # [Np, R]
    dev_used: torch.Tensor      # [Np, D]
    sp_used: torch.Tensor       # [Gp, S, V]
    done: torch.Tensor          # [K] decided
    out_idx: torch.Tensor       # [K, TOP_K]
    out_ok: torch.Tensor        # [K, TOP_K]
    out_score: torch.Tensor     # [K, TOP_K]
    out_nfeas: torch.Tensor     # [K]
    out_nexh: torch.Tensor      # [K]
    out_dimexh: torch.Tensor    # [K, R]
    sl: Optional[_SLState] = None
    evt: Optional[torch.Tensor] = None        # [Np, E] slots taken
    out_evict: Optional[torch.Tensor] = None  # [K, E]
    out_wave: Optional[torch.Tensor] = None   # [K]


class _Mid(NamedTuple):
    """What a wave's rerank reads of its wave body: the usage before the
    wave's commits and the full pass's counters."""
    used_pre: torch.Tensor
    dev_used_pre: torch.Tensor
    n_feas_g: torch.Tensor
    n_exh_g: torch.Tensor
    dim_exh_g: torch.Tensor
    act_next_g: torch.Tensor    # [Gp] groups with a placement left


class _Prep(NamedTuple):
    """A full pass's inputs rebuilt from the committed outputs."""
    coll: torch.Tensor          # [Gp, Np] own-group collocation counts
    blocked: Optional[torch.Tensor]     # [Gp, Np] distinct_hosts blocks
    pk_blocked: Optional[torch.Tensor]  # the same, bit-packed
    spread: Optional[tuple]     # the fused kernel's spread pack


#: the per-solve tensors (`c`) that no captured stretch reads: the fused
#: kernel's own inputs (it runs outside the graphs), the spec-driven
#: scorer's and the mesh's
_GRAPH_SKIP = frozenset(("pk_feas", "pk_pen", "jitter", "valid", "learned",
                         "region_bias", "attr_rank", "ev_slot_ok", "ev_res_f",
                         "ev_prio_i"))
#: the per-solve tensors that depend on the signature alone, copied into
#: a plan's buffers once
_GRAPH_CONST = frozenset(("ks", "gs", "offs_k", "no_tab_s", "no_tab_i"))


def _init_carry(k, c: _Inputs, used0, dev_used0, sp_used0) -> _Carry:
    """The carry before the first wave."""
    f32, i32, device = torch.float32, torch.int32, k.device
    Gp, C, K, R, TKl = k.Gp, k.C, k.K, k.R, k.TKl
    sl = None
    if k.use_sl:
        vshape = (k.S, Gp, C) if k.has_spread else (1, 1, 1)
        tshape = (Gp, k.Vs + 1, k.TW) if k.want_tables else (Gp, 1, 1)
        sl = _SLState(
            idx=torch.zeros((Gp, C), dtype=i32, device=device),
            feas=torch.zeros((Gp, C), dtype=torch.bool, device=device),
            pen=torch.zeros((Gp, C), dtype=torch.bool, device=device),
            aff=torch.zeros((Gp, C), dtype=f32, device=device),
            vn=torch.zeros(vshape, dtype=i32, device=device),
            de=torch.zeros(vshape, dtype=f32, device=device),
            coll=torch.zeros((Gp, C), dtype=f32, device=device),
            cut_s=torch.zeros(Gp, dtype=f32, device=device),
            cut_i=torch.zeros(Gp, dtype=i32, device=device),
            comp=torch.zeros(Gp, dtype=torch.bool, device=device),
            nfeas=torch.zeros(Gp, dtype=i32, device=device),
            nexh=torch.zeros(Gp, dtype=i32, device=device),
            ndim=torch.zeros((Gp, R), dtype=i32, device=device),
            win_s=torch.full((Gp, TKl), NEG_INF, dtype=f32, device=device),
            win_i=torch.zeros((Gp, TKl), dtype=i32, device=device),
            tb_s=torch.full(tshape, NEG_INF, dtype=f32, device=device),
            tb_i=torch.zeros(tshape, dtype=i32, device=device),
            gany=torch.zeros(Gp, dtype=torch.bool, device=device))
    evt = out_evict = out_wave = None
    if k.has_preempt:
        evt = torch.zeros((k.Np, k.EV), dtype=torch.bool, device=device)
        out_evict = torch.zeros((K, k.EV), dtype=torch.bool, device=device)
        out_wave = torch.full((K,), -1, dtype=i32, device=device)
    return _Carry(
        used=used0, dev_used=dev_used0, sp_used=sp_used0,
        done=torch.zeros(K, dtype=torch.bool, device=device),
        out_idx=torch.zeros((K, TOP_K), dtype=i32, device=device),
        out_ok=torch.zeros((K, TOP_K), dtype=torch.bool, device=device),
        out_score=torch.full((K, TOP_K), NEG_INF, dtype=f32, device=device),
        out_nfeas=torch.zeros(K, dtype=i32, device=device),
        out_nexh=torch.zeros(K, dtype=i32, device=device),
        out_dimexh=torch.zeros((K, R), dtype=i32, device=device),
        sl=sl, evt=evt, out_evict=out_evict, out_wave=out_wave)


def _wave_prep(k, c: _Inputs, st: _Carry) -> _Prep:
    """The full pass's inputs from the committed outputs: the own-group
    collocation counts, the distinct_hosts block plane (the torch scorer
    takes it whole, the fused kernel bit-packed) and the kernel's
    spread pack."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    committed = st.done & st.out_ok[:, 0]
    chosen = torch.where(committed, st.out_idx[:, 0], 0).to(i64)
    if k.in_mesh:
        # out_idx holds GLOBAL ids: rows of other shards drop
        chosen = k.g2l(chosen)[1]
        coll = _add_drop(c.coll0, (c.g_idx, chosen), committed.to(f32), 1)
    else:
        # the committed rows alone count (the others, all at column 0,
        # would add zeros to one cell)
        coll = _sk.hist_add(c.coll0, c.g_idx * k.Np + chosen, committed)
    blocked = pk_blocked = spread = None
    if k.has_distinct:
        dg_all = c.distinct[c.g_idx].to(i64)
        hit = _add_drop(
            torch.zeros((k.Gp, k.Np), dtype=i32, device=k.device),
            (dg_all.clamp(min=0), chosen),
            (committed & (dg_all >= 0)).to(i32), 1) > 0
        blocked = (hit[c.distinct.to(i64).clamp(min=0)]
                   & (c.distinct >= 0)[:, None])
        if k.use_pk:
            pk_blocked = pack_bool_u32(blocked)
    elif not k.use_pk:
        blocked = torch.zeros((k.Gp, k.Np), dtype=torch.bool,
                              device=k.device)
    if k.use_pk and k.has_spread:
        sp_used = st.sp_used
        pres = sp_used > 0                                  # [Gp, S, V]
        anyp = pres.any(dim=2)
        minc_w = torch.where(pres, sp_used, float("inf")).amin(2)
        maxc_w = torch.where(pres, sp_used, float("-inf")).amax(2)
        # rows with nothing present are pinned finite: their
        # contribution is masked to 0 either way
        spread = (c.pk_vnode, c.sp_des, sp_used, c.sp_weight,
                  c.sp_targeted, c.pk_sp_has,
                  torch.where(anyp, minc_w, 0.0),
                  torch.where(anyp, maxc_w, 0.0), anyp.to(torch.int8))
    return _Prep(coll, blocked, pk_blocked, spread)


def _wave_scores(k, c: _Inputs, st: _Carry, prep: _Prep, out=None) -> dict:
    """Score every (group, node) pair against the carried usage: the
    fused wave kernel (into `out`, `wave_kernel.out_buffers`, when
    given) or the spec-driven torch scorer.  Returns the kernel's result
    dict (counters, and the score plane or its extraction)."""
    i32 = torch.int32
    if k.use_pk:
        return _wk.fused_wave(
            mode=k.pallas_mode, feas=c.pk_feas, blocked=prep.pk_blocked,
            aff=c.aff_score, pen=c.pk_pen, jitter=c.jitter, coll=prep.coll,
            used=st.used, avail=c.avail, reserved=c.reserved,
            ask_res=c.ask_res, ask_desired=c.ask_desired,
            dev=(st.dev_used, c.dev_cap, c.dev_ask) if k.has_devices
            else None,
            spread=prep.spread, seed=k.seed, TK=k.TK, n_extract=k.NE,
            tables_v=k.Vs if (k.want_tables and k.pallas_mode == "topk")
            else 0, out=out)
    pen_score, pen_counts = _score_spec.static_terms(_TORCH_OPS, c.penalty)
    ctx = dict(
        used=st.used, dev_used=st.dev_used, coll=prep.coll,
        sp_used=st.sp_used, blocked=prep.blocked, avail=c.avail,
        reserved=c.reserved, ask_res=c.ask_res, ask_desired=c.ask_desired,
        dev_cap=c.dev_cap, dev_ask=c.dev_ask, feas=c.feas,
        pen_score=pen_score, pen_counts=pen_counts,
        aff_score=c.aff_score, has_devices=k.has_devices,
        has_spread=k.has_spread, sp_col=c.sp_col, sp_weight=c.sp_weight,
        sp_targeted=c.sp_targeted, vnode=c.sp_vnode, des=c.sp_des, S=k.S,
        V=k.V, shape=(k.Gp, k.Np), seed=k.seed, jitter=c.jitter,
        learned=c.learned, region_bias=c.region_bias)
    score, placeable, feas_b, fit, fit_dims, dev_fit = \
        _score_spec.evaluate_wave(_TORCH_OPS, ctx)
    fv = feas_b & c.valid[None, :]
    return {"score": score, "grp_any": placeable.any(dim=1),
            "n_feas": fv.sum(dim=1).to(i32),
            "n_exh": (fv & ~(fit & dev_fit)).sum(dim=1).to(i32),
            "dim_exh": (fv[:, :, None] & ~fit_dims).sum(dim=1).to(i32)}


def _full_tables(k, c: _Inputs, score: torch.Tensor):
    """Per-value candidate tables from a full score plane: one class
    per value plus the missing-value class."""
    vnode = c.sp_vnode[0]
    tabs_s, tabs_i = [], []
    for v in range(k.Vs + 1):
        vmask = (vnode == v) if v < k.Vs else (vnode < 0)
        sv = torch.where(vmask, score, NEG_INF)
        if k.elastic:
            # gid-ordered ties; the ids leave GLOBAL
            ts, ti, _ = _gid_top(sv, k.g_of_local, k.TW)
            ti = ti.to(torch.int32)
        else:
            ts, ti = _top_rows(sv, k.TW)
        tabs_s.append(ts)
        tabs_i.append(ti)
    return torch.stack(tabs_s, dim=1), torch.stack(tabs_i, dim=1)


def _full_extract(k, c: _Inputs, st: _Carry, prep: _Prep, sc: dict):
    """The full pass after scoring: extract the top-NE, window the
    first TK, and with the shortlist on rebuild the carried shortlist
    from the same extraction."""
    i32, i64 = torch.int32, torch.int64
    n_feas_g, n_exh_g = sc["n_feas"], sc["n_exh"]
    dim_exh_g, grp_any = sc["dim_exh"], sc["grp_any"]
    score = sc.get("score")              # None in "topk" mode
    TKl, NE, C = k.TKl, k.NE, k.C
    topk = k.use_pk and k.pallas_mode == "topk"
    if k.elastic:
        # under a tile remap local slot order is not global-id order:
        # extract by (score desc, GLOBAL id asc), carrying the local slot
        ext_s, ext_g, ext_i = _gid_top(score, k.g_of_local, NE)
        ext_g, ext_i = ext_g.to(i32), ext_i.to(i32)
    elif topk:
        ext_s, ext_i = sc["top_score"], sc["top_idx"]
    else:
        ext_s, ext_i = _top_rows(score, NE)                # [Gp, NE]
    top_score, top_idx = ext_s[:, :TKl], ext_i[:, :TKl]
    if k.elastic:
        top_idx = ext_g[:, :TKl]           # window keys are GLOBAL

    if k.want_tables:
        if topk:
            tab_s, tab_i = sc["tab_s"], sc["tab_i"]
        else:
            tab_s, tab_i = _full_tables(k, c, score)
        if k.in_mesh and not k.elastic:
            tab_i = tab_i + k.off
    else:
        tab_s, tab_i = c.no_tab_s, c.no_tab_i
    if k.in_mesh and not k.elastic:
        # window keys leave the shard with GLOBAL node ids
        top_idx = top_idx + k.off

    SL = st.sl
    if k.use_sl:
        # rebuild the carried shortlist from this extraction (node-
        # ascending, so commit positions resolve by bisection); the
        # cutoff key freezes the best possible outsider for the era
        sl_i = torch.sort(ext_i, dim=1).values
        sl_l = sl_i.to(i64)
        if k.has_spread:
            bidx = sl_l.expand(k.S, k.Gp, C)
            vn = torch.gather(c.sp_vnode, 2, bidx)
            de = torch.gather(c.sp_des, 2, bidx)
        else:
            vn, de = SL.vn, SL.de
        SL = _SLState(
            idx=sl_i, feas=torch.gather(c.feas, 1, sl_l),
            pen=torch.gather(c.penalty, 1, sl_l),
            aff=torch.gather(c.aff_score, 1, sl_l), vn=vn, de=de,
            coll=torch.gather(prep.coll, 1, sl_l),
            # the cutoff's tie-break key: the GLOBAL id under the elastic
            # remap (its extraction order), else the local slot (the
            # block map is monotonic)
            cut_s=ext_s[:, NE - 1],
            cut_i=(ext_g if k.elastic else ext_i)[:, NE - 1],
            comp=(n_feas_g - n_exh_g) <= C,
            nfeas=n_feas_g, nexh=n_exh_g, ndim=dim_exh_g,
            win_s=top_score, win_i=top_idx, tb_s=tab_s, tb_i=tab_i,
            gany=grp_any)
    return (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
            dim_exh_g, grp_any, SL)


def _seg_path(k) -> bool:
    """Whether a wave's conflict check (and, off the mesh, its commits
    to usage and the node marks) runs over one sort of its candidates by
    node (`seg_kernel`) in place of [K, K] masks: above 2,048 placements
    a wave, or under the test hook."""
    return k.K > 2048 or _FORCE_SORT_CONFLICTS


def _check_sort_keys(NT: int, Gp: int, V: int) -> None:
    """Refuse a solve whose sort keys (a node and distinct group, a
    spread value class, a node) could reach `seg_kernel.KEY_LIMIT`: the
    sort path sorts them as int32."""
    if max(NT * Gp, 2 * Gp * V + 2) > _sk.KEY_LIMIT:
        raise ValueError(f"{NT} nodes, {Gp} groups and {V} spread values "
                         "overflow the conflict check's int32 sort keys")


def _seg_conflicts(k, c: _Inputs, cand_ok, cand):
    """The same-wave conflict helpers (prior_sum_node, prior_rank_any,
    prior_rank) and the node order `segs`: [K, K] masks up to K = 2048
    (`segs` None); above, one stable sort of the `cand_ok` candidates by
    node (`segs`, which the commits reuse) for the prior sums, and a
    sort of its own for each other key ranked (every key below
    `seg_kernel.KEY_LIMIT`, which `solve_steps` checks)."""
    f32 = torch.float32
    ks = c.ks
    if not _seg_path(k):
        earlier = ks[None, :] < ks[:, None]                # [K, K]
        both_ok = cand_ok[None, :] & cand_ok[:, None]
        same_node = ((cand[None, :] == cand[:, None]) & both_ok
                     & earlier)
        same_f = same_node.to(f32)

        def prior_sum_node(vals):
            return same_f @ vals

        def prior_rank_any(key, m):
            # exclusive count of earlier members with an equal key
            # under any membership mask (the eviction pass ranks
            # placements whose cand_ok is False)
            same = ((key[None, :] == key[:, None]) & m[None, :]
                    & m[:, None] & earlier)
            return same.sum(dim=1)

        def prior_rank(key, member):
            return prior_rank_any(key, member & cand_ok)
        return prior_sum_node, prior_rank_any, prior_rank, None

    segs = _sk.sort_segments(cand, cand_ok)

    def prior_sum_node(vals):
        return _sk.prior_sum(segs, vals)

    def prior_rank_any(key, m):
        return _sk.seg_rank(_sk.sort_segments(key, m))

    def prior_rank(key, member):
        return prior_rank_any(key, member & cand_ok)
    return prior_sum_node, prior_rank_any, prior_rank, segs


def _wave_body(k, c: _Inputs, st: _Carry, sc, prep, take_carried: bool,
               early: bool, rot, wave: int):
    """One wave from its carried-window decision to its rerank decision:
    the window (the carried shortlist's, or the full pass's from the
    scores `sc`), the rank-wrap, the same-wave conflict checks, the
    commits, the eviction pass, the results, and the shortlist's
    maintenance.  A generator only for the mesh's collectives (it yields
    them; anywhere else it yields nothing).  Returns (carry, `_Mid` for
    the rerank or None without the shortlist, flags): `flags` [1..3]
    holds the wave's host decisions on the card, `active_next.any()`
    (the next wave's entry test), and with the shortlist the carried
    window's premise `(ok_pre_g | ~act_next_g).all()` and with
    has_preempt `ev_commit.any()`, so that one sync reads them all.

    `early` is the first half of the wave budget (spread's even quota);
    `rot` the rotation of the rank-wrap (0 without a seed, the wave
    index otherwise; a device scalar in a captured wave); `wave` the
    wave index the eviction outputs record."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    device, Gp, Np, K, S, V = k.device, k.Gp, k.Np, k.K, k.S, k.V
    TK, W, C = k.TK, k.W, k.C
    in_mesh, has_spread = k.in_mesh, k.has_spread
    ks, gs, g_idx = c.ks, c.gs, c.g_idx
    used, dev_used, sp_used = st.used, st.dev_used, st.sp_used
    used_pre, dev_used_pre = used, dev_used
    active = ~st.done & c.in_batch
    SL = st.sl
    if take_carried:
        # shortlist wave: window and counters were pre-computed at the
        # end of the previous wave — no [Gp, Np] plane is read
        (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
         dim_exh_g, grp_any) = (SL.win_s, SL.win_i, SL.tb_s, SL.tb_i,
                                SL.nfeas, SL.nexh, SL.ndim, SL.gany)
    else:
        (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
         dim_exh_g, grp_any, SL) = _full_extract(k, c, st, prep, sc)

    # ---- cross-shard candidate-key merge (mesh mode): each shard's
    # window keys (and value-table keys) merge into the exact top-TK of
    # the whole node axis; the counters sum over the mesh ----
    if in_mesh:
        top_score, top_idx = yield ("merge", top_score, top_idx, TK)
        if k.want_tables:
            tab_s, tab_i = yield ("merge", tab_s, tab_i, k.TKv)
        n_feas_out = yield ("psum", n_feas_g)
        n_exh_out = yield ("psum", n_exh_g)
        dim_exh_out = yield ("psum", dim_exh_g)
        grp_any = (yield ("psum", grp_any.to(i32))) > 0
    else:
        n_feas_out, n_exh_out, dim_exh_out = n_feas_g, n_exh_g, dim_exh_g

    # spread-aware candidate interleaving (slot 0): slot j of the window
    # draws from value class j mod (V+1), classes visited in each
    # group's preference order; holes compact to the tail
    if k.want_tables:
        Vs = k.Vs
        has0 = c.sp_col[:, 0] >= 0                         # [Gp]
        vord = torch.argsort(0.0 - tab_s[:, :, 0], dim=1, stable=True)
        j = torch.arange(TK, device=device)
        vj = vord[:, j % (Vs + 1)]                         # [Gp, TK]
        jj = (j // (Vs + 1))[None, :]
        inter_i = tab_i[gs[:, None], vj, jj]
        inter_s = tab_s[gs[:, None], vj, jj]
        order = torch.argsort((inter_s <= NEG_INF / 2).to(i32), dim=1,
                              stable=True)
        inter_i = torch.gather(inter_i, 1, order)
        inter_s = torch.gather(inter_s, 1, order)
        top_idx = torch.where(has0[:, None], inter_i, top_idx)
        top_score = torch.where(has0[:, None], inter_s, top_score)

    # rank each active placement within its group; the r-th takes the
    # group's (r mod M)-th best candidate (rank-wrap)
    grp_onehot = ((g_idx[None, :] == gs[:, None])
                  & active[None, :]).to(i32)                # [Gp, K]
    act_g = grp_onehot.sum(dim=1)
    rank = (torch.cumsum(grp_onehot, dim=1) - grp_onehot)[g_idx, ks]
    n_cand = (top_score > NEG_INF / 2).sum(dim=1)
    M = torch.clamp(torch.clamp(n_cand, max=W), 1, W)
    if k.stack_commit:
        cr = torch.zeros_like(rank)
    else:
        cr = (rank + c.g_off[g_idx] + rot) % M[g_idx]
    cand = top_idx[g_idx, cr].to(i64)                      # [K]
    cand_score = top_score[g_idx, cr]
    cand_ok = active & (cand_score > NEG_INF / 2)
    fail_now = active & ~grp_any[g_idx]

    # -- same-wave conflict checks over shared nodes --
    prior_sum_node, prior_rank_any, prior_rank, segs = _seg_conflicts(
        k, c, cand_ok, cand)
    # off the mesh the sort path's commits reuse its node order
    seg_commit = segs is not None and not in_mesh

    ask_k = c.ask_res[g_idx]
    prior = prior_sum_node(ask_k * cand_ok[:, None])       # [K, R]
    if in_mesh:
        # each shard checks the fit of the candidates it owns; the
        # K-sized votes sum over the mesh (the [Np, R] planes stay)
        inb, loc, locc = k.g2l(cand)
        fits_l = ((used[locc] + prior + ask_k)
                  <= c.avail[locc]).all(dim=-1) & inb
        fits = (yield ("psum", fits_l.to(i32))) > 0
    else:
        loc = cand
        fits = ((used[cand] + prior + ask_k) <= c.avail[cand]).all(dim=-1)
    if k.has_devices:
        dev_k = c.dev_ask[g_idx]
        prior_dev = prior_sum_node(dev_k * cand_ok[:, None])
        if in_mesh:
            dev_fits_l = ((dev_used[locc] + prior_dev + dev_k)
                          <= c.dev_cap[locc]).all(dim=-1) & inb
            dev_fits = (yield ("psum", dev_fits_l.to(i32))) > 0
        else:
            dev_fits = ((dev_used[cand] + prior_dev + dev_k)
                        <= c.dev_cap[cand]).all(dim=-1)
    else:
        dev_fits = torch.ones(K, dtype=torch.bool, device=device)
    if in_mesh and has_spread:
        # one [K, A] sum of the candidates' attribute rows serves the
        # spread quota and the commit below
        ar_cand = (yield ("psum", torch.where(
            inb[:, None], c.attr_rank[locc].to(i32), 0))).to(i64)

    # distinct_hosts: one commit per (node, distinct group) per wave
    if k.has_distinct:
        dg = c.distinct[g_idx].to(i64)
        dg_ok = prior_rank(cand * Gp + dg.clamp(min=0), dg >= 0) == 0
    else:
        dg_ok = torch.ones(K, dtype=torch.bool, device=device)

    # spread quota per (group, slot, value) for this wave
    sp_ok = torch.ones(K, dtype=torch.bool, device=device)
    for s in (range(S) if has_spread else range(0)):
        cols = c.sp_col[g_idx, s].to(i64)
        if in_mesh:
            vs = torch.gather(ar_cand, 1, cols.clamp(min=0)[:, None])[:, 0]
        else:
            vs = c.attr_rank_l[cand, cols.clamp(min=0)]
        has_s = (cols >= 0) & (vs >= 0)
        # non-members read some in-range slot (the reference's clamped
        # gather); members' ranks are < V by construction
        vsc = vs.clamp(0, V - 1)
        des_s = c.sp_desired[:, s]                         # [Gp, V]
        use_s = sp_used[:, s]
        des_eff = torch.where(des_s < 0, c.sp_implicit[:, s][:, None],
                              des_s)
        present = use_s > 0
        maxc_q = torch.where(present, use_s, 0.0).amax(dim=1)[:, None]
        minc_q = torch.where(
            present, use_s,
            torch.where(present.any(dim=1)[:, None], float("inf"),
                        0.0)).amin(dim=1)[:, None]
        minc_q = torch.where(torch.isfinite(minc_q), minc_q, 0.0)
        # even spread: values may grow to a common level for the first
        # half of the wave budget, unbounded after it
        share = torch.ceil(act_g.to(f32) / V)[:, None]
        level = torch.maximum(maxc_q, minc_q + share)
        if early:
            even_q = torch.clamp(level - use_s, min=1.0)
        else:
            even_q = torch.full_like(use_s, float("inf"))
        quota = torch.where(c.sp_targeted[:, s][:, None],
                            torch.clamp(des_eff - use_s, min=1.0),
                            even_q)                        # [Gp, V]
        gv_key = (g_idx * V + vsc) * 2 + 1
        gv_rank = prior_rank(gv_key, has_s).to(f32)
        sp_ok = sp_ok & (~has_s | (gv_rank < quota[g_idx, vsc]))

    commit = cand_ok & fits & dev_fits & dg_ok & sp_ok
    cm = commit[:, None]

    # -- apply this wave's commits (duplicate nodes accumulate; in mesh
    # mode each shard adds only the rows it owns) --
    if in_mesh:
        used = _add_drop(used, (loc,), ask_k * cm)
        if k.has_devices:
            dev_used = _add_drop(dev_used, (loc,), c.dev_ask[g_idx] * cm)
    elif seg_commit:
        # one write a node, of its segment's committed asks
        used = _sk.seg_add(segs, used, ask_k, commit)
        if k.has_devices:
            dev_used = _sk.seg_add(segs, dev_used, c.dev_ask[g_idx], commit)
    else:
        used = used.index_put((cand,), ask_k * cm, accumulate=True)
        if k.has_devices:
            dev_used = dev_used.index_put((cand,), c.dev_ask[g_idx] * cm,
                                          accumulate=True)
    if has_spread:
        scol = c.sp_col[g_idx].to(i64)                     # [K, S]
        if in_mesh:
            svals = torch.gather(ar_cand, 1, scol.clamp(min=0))
        else:
            svals = c.attr_rank_l[cand[:, None], scol.clamp(min=0)]
        okslot = (scol >= 0) & (svals >= 0) & cm
        # a replicated plane every shard counts alike (the mesh's
        # candidate attributes are psum'd)
        cell = ((g_idx[:, None] * S
                 + torch.arange(S, device=device)[None, :]) * V
                + svals.clamp(0, V - 1))
        sp_used = _sk.hist_add(sp_used, cell, okslot)

    # -- eviction pass: after the normal commits, against post-commit
    # usage, for placements whose group has nothing placeable --
    evt, out_evict, out_wave = st.evt, st.out_evict, st.out_wave
    if k.has_preempt:
        EV = k.EV
        want = active & ~commit & ~grp_any[g_idx]
        want_g = torch.zeros(Gp, dtype=i32, device=device).index_add(
            0, g_idx, want.to(i32)) > 0
        want_any_t = want.any()
        with k.rg.sync():
            any_want = bool(want_any_t)
        if any_want:
            nv_s, nv_i, sel_freed, sel_mask = evict_pass(
                used, evt, want_g, ask_res=c.ask_res, avail=c.avail,
                reserved=c.reserved, feas=c.feas, ev_slot_ok=c.ev_slot_ok,
                ev_res=c.ev_res_f, ev_prio=c.ev_prio_i,
                dev=(dev_used, c.dev_cap, c.dev_ask) if k.has_devices
                else None, ids=k.g_of_local if in_mesh else None,
                syncs=k.rg)
        else:
            nv_s = torch.full((Gp,), NEG_INF, dtype=f32, device=device)
            nv_i = torch.zeros(Gp, dtype=i64, device=device)
            sel_freed = torch.zeros((Gp, k.R), dtype=f32, device=device)
            sel_mask = torch.zeros((Gp, EV), dtype=torch.bool,
                                   device=device)
        if in_mesh:
            # each group's best eviction key (score, global id) from
            # every shard; the owner holds its victim set
            win_s, win_i = yield ("merge", nv_s[:, None], nv_i[:, None], 1)
            win_s, win_i = win_s[:, 0], win_i[:, 0]
        else:
            win_s, win_i = nv_s, nv_i
        ev_any_g = win_s > NEG_INF / 2
        e_cand = win_i[g_idx]                              # [K] global
        p_ok = want & ev_any_g[g_idx]
        # one eviction commit per node per wave, across groups: two
        # victim sets chosen apart must never both apply to one node
        ev_commit = p_ok & (prior_rank_any(e_cand, p_ok) == 0)
        ecm = ev_commit[:, None]
        ev_val = (c.ask_res[g_idx] - sel_freed[g_idx]) * ecm
        if in_mesh:
            e_inb, e_loc, e_locc = k.g2l(e_cand)
            own = (e_inb & ev_commit)[:, None]
            # victims leave and the placement lands in one add
            used = _add_drop(used, (e_loc,), ev_val)
            if k.has_devices:
                dev_used = _add_drop(dev_used, (e_loc,),
                                     c.dev_ask[g_idx] * ecm)
            em_l = sel_mask[g_idx] & own                   # [K, EV]
            evt = evt | (_add_drop(
                torch.zeros((Np, EV), dtype=i32, device=device),
                (e_loc,), em_l.to(i32)) > 0)
            em = (yield ("psum", em_l.to(i32))) > 0
        else:
            used = used.index_put((e_cand,), ev_val, accumulate=True)
            if k.has_devices:
                dev_used = dev_used.index_put(
                    (e_cand,), c.dev_ask[g_idx] * ecm, accumulate=True)
            em = sel_mask[g_idx] & ecm                     # [K, EV]
            evt = evt | (torch.zeros((Np, EV), dtype=i32, device=device)
                         .index_put((e_cand,), em.to(i32),
                                    accumulate=True) > 0)
        if has_spread:
            scol = c.sp_col[g_idx].to(i64)
            if in_mesh:
                ar_ev = (yield ("psum", torch.where(
                    own, c.attr_rank[e_locc].to(i32), 0))).to(i64)
                evals_ = torch.gather(ar_ev, 1, scol.clamp(min=0))
            else:
                evals_ = c.attr_rank_l[e_cand[:, None], scol.clamp(min=0)]
            ok_es = (scol >= 0) & (evals_ >= 0) & ecm
            sp_used = sp_used.index_put(
                (g_idx[:, None], torch.arange(S, device=device)[None, :],
                 evals_.clamp(0, V - 1)), ok_es.to(f32), accumulate=True)
        # a group with no placeable node and no eviction option fails;
        # one with an option keeps retrying
        fail_now = fail_now & ~ev_any_g[g_idx]
    else:
        ev_commit = torch.zeros(K, dtype=torch.bool, device=device)

    # -- record results: a committed placement's fall-through top-K is
    # its group's candidate list starting at its own rank --
    offs = cr[:, None] + c.offs_k[None, :]                 # < TK
    pk_idx = top_idx[g_idx[:, None], offs]
    pk_score = top_score[g_idx[:, None], offs]
    ok_row = (pk_score > NEG_INF / 2) & cm
    if k.has_preempt:
        # an eviction commit records its one node in slot 0 (the victim
        # set is node-specific: no fall-through) with the post-eviction
        # bin-pack score
        ecol = (c.offs_k == 0)[None, :]
        pk_idx = torch.where(ecm, torch.where(
            ecol, e_cand[:, None].to(i32), 0), pk_idx)
        pk_score = torch.where(ecm, torch.where(
            ecol, win_s[g_idx][:, None], NEG_INF), pk_score)
        ok_row = torch.where(ecm, ecol, ok_row)
    newly = commit | ev_commit | fail_now
    upd = newly[:, None]
    if k.has_preempt:
        out_evict = torch.where(upd, em & ecm, out_evict)
        out_wave = torch.where(commit | ev_commit, wave, out_wave)
    st = st._replace(
        used=used, dev_used=dev_used, sp_used=sp_used,
        done=st.done | newly,
        out_idx=torch.where(upd, pk_idx, st.out_idx),
        out_ok=torch.where(upd, ok_row, st.out_ok),
        out_score=torch.where(upd, pk_score, st.out_score),
        out_nfeas=torch.where(newly, n_feas_out[g_idx], st.out_nfeas),
        out_nexh=torch.where(newly, n_exh_out[g_idx], st.out_nexh),
        out_dimexh=torch.where(upd, dim_exh_out[g_idx], st.out_dimexh),
        evt=evt, out_evict=out_evict, out_wave=out_wave)

    # the next wave's active placements are this wave's less the decided
    active_next = active & ~newly
    flags = [active_next.any()]
    if not k.use_sl:
        return st, None, torch.stack(flags)

    # ---- end-of-wave shortlist maintenance: the premise of the next
    # wave's carried window ----
    act_next_g = torch.zeros(Gp, dtype=i32, device=device).index_add(
        0, g_idx, active_next.to(i32)) > 0
    cf = commit.to(f32)
    # TR1: every commit this wave landed inside the group's shortlist
    # (otherwise an outsider's score moved) (in mesh mode only commits
    # to this shard's nodes move its scores: owned commits against the
    # local shortlist)
    if in_mesh:
        tot = (cf * inb.to(f32)).sum()
        mark = _add_drop(torch.zeros(Np, dtype=f32, device=device),
                         (loc,), cf)
    elif seg_commit:
        tot = cf.sum()
        mark = _sk.seg_add(segs, torch.zeros(Np, dtype=f32, device=device),
                           None, commit)
    else:
        tot = cf.sum()
        mark = torch.zeros(Np, dtype=f32, device=device).index_put(
            (cand,), cf, accumulate=True)
    tr1_g = mark[SL.idx.to(i64)].sum(dim=1) == tot
    g_committed = torch.zeros(Gp, dtype=f32, device=device
                              ).index_add(0, g_idx, cf) > 0
    if has_spread:
        has_sp_g = (c.sp_col >= 0).any(dim=1)
    else:
        has_sp_g = torch.zeros(Gp, dtype=torch.bool, device=device)
    # spread groups shift all their node scores when they commit;
    # interleaved groups additionally need a complete shortlist
    sp_gate = has_sp_g & g_committed
    if k.want_tables:
        sp_gate = sp_gate | (c.sp_col[:, 0] >= 0)
    ok_pre_g = SL.comp | (tr1_g & ~sp_gate)
    flags.append((ok_pre_g | ~act_next_g).all())
    if k.has_preempt:
        # an eviction lowers usage, which voids the monotone-usage
        # argument behind the carried window: any eviction commit sends
        # the next wave to a full rescore
        flags.append(ev_commit.any())

    # own-group commit counts fold into the carried coll; window entries
    # outside the shortlist land in a dropped column
    sl_idx = SL.idx.to(i64)
    tloc = k.g2l(top_idx)[1] if in_mesh else top_idx.to(i64)
    win_pos = torch.searchsorted(sl_idx, tloc)
    pos_hit = torch.gather(sl_idx, 1, win_pos.clamp(max=C - 1)) == tloc
    win_pos = torch.where(pos_hit, win_pos, C)
    cand_pos = win_pos[g_idx, cr]
    coll = _sk.hist_add(SL.coll, g_idx * C + cand_pos,
                        commit & (cand_pos < C))
    st = st._replace(sl=SL._replace(coll=coll))
    mid = _Mid(used_pre=used_pre, dev_used_pre=dev_used_pre,
               n_feas_g=n_feas_g, n_exh_g=n_exh_g, dim_exh_g=dim_exh_g,
               act_next_g=act_next_g)
    return st, mid, torch.stack(flags)


def _sl_eval(k, c: _Inputs, sl: _SLState, used_x, dev_used_x, sp_used_x):
    """Exact score/indicator recompute for the <= C shortlist entries
    from gathered live state, term for term the full rescore restricted
    to these nodes.  Returns (score, placeable, exh_ind, dim_ind)."""
    f32, i64 = torch.float32, torch.int64
    Gp, C, R, device = k.Gp, k.C, k.R, k.device
    idx = sl.idx.to(i64)
    u = used_x[idx]                                        # [Gp, C, R]
    av = c.avail[idx]
    rsv = c.reserved[idx]
    after = u + c.ask_res[:, None, :]
    fit_dims = after <= av
    fit = fit_dims.all(dim=-1)
    if k.has_devices:
        dev_fit = (dev_used_x[idx] + c.dev_ask[:, None, :]
                   <= c.dev_cap[idx]).all(dim=-1)
    else:
        dev_fit = torch.ones((Gp, C), dtype=torch.bool, device=device)
    placeable = sl.feas & fit & dev_fit

    denom_cpu = av[:, :, R_CPU]
    denom_mem = av[:, :, R_MEM]
    util_cpu = after[:, :, R_CPU] + rsv[:, :, R_CPU]
    util_mem = after[:, :, R_MEM] + rsv[:, :, R_MEM]
    ok_denoms = (denom_cpu > 0) & (denom_mem > 0)
    free_cpu = 1.0 - util_cpu / torch.clamp(denom_cpu, min=1.0)
    free_mem = 1.0 - util_mem / torch.clamp(denom_mem, min=1.0)
    raw = 20.0 - (10.0 ** free_cpu + 10.0 ** free_mem)
    binpack = torch.where(ok_denoms,
                          torch.clamp(raw, 0.0, 18.0) / 18.0, 0.0)

    anti = torch.where(sl.coll > 0,
                       -(sl.coll + 1.0) / c.ask_desired[:, None], 0.0)
    anti_counts = sl.coll > 0

    if k.has_spread:
        spread_total = torch.zeros((Gp, C), dtype=f32, device=device)
        inf = float("inf")
        for s in range(k.S):
            has = c.sp_col[:, s] >= 0
            v = sl.vn[s]
            has_v = v >= 0
            used_vec = sp_used_x[:, s]
            cur = torch.where(v >= 0, torch.gather(
                used_vec, 1, v.clamp(min=0).to(i64)), 0.0)
            desired = sl.de[s]
            boost = ((desired - (cur + 1.0))
                     / torch.clamp(desired, min=1e-9)
                     ) * c.sp_weight[:, s][:, None]
            targeted = torch.where(~has_v, -1.0,
                                   torch.where(desired <= 0, -1.0, boost))
            present = used_vec > 0
            any_present = present.any(dim=1)[:, None]
            minc = torch.where(present, used_vec, inf).amin(dim=1)[:, None]
            maxc = torch.where(present, used_vec, -inf).amax(dim=1)[:, None]
            delta_boost = (minc - cur) / torch.clamp(minc, min=1e-9)
            even = torch.where(cur != minc, delta_boost,
                               torch.where(minc == maxc, -1.0,
                                           (maxc - minc)
                                           / torch.clamp(minc, min=1e-9)))
            even = torch.where(~has_v, -1.0, even)
            even = torch.where(any_present, even, 0.0)
            contrib = torch.where(c.sp_targeted[:, s][:, None], targeted,
                                  even)
            spread_total = spread_total + torch.where(
                has[:, None], contrib, 0.0)
        spread_counts = spread_total != 0.0
    else:
        spread_total = 0.0
        spread_counts = False

    aff_counts = sl.aff != 0.0
    pen_sc = torch.where(sl.pen, -1.0, 0.0)
    n_scorers = (1.0 + anti_counts + sl.pen + aff_counts + spread_counts)
    total = (binpack + anti + pen_sc + sl.aff + spread_total) / n_scorers
    if k.seed_nz:
        total = (torch.floor(total / _score_spec.SCORE_BIN)
                 * _score_spec.SCORE_BIN)
        jit_sl = _jitter(k.l2g(idx) if k.in_mesh else idx, c.gsalt)
    else:
        jit_sl = 0.0
    total = total + jit_sl
    score = torch.where(placeable, total, NEG_INF)
    exh = sl.feas & ~(fit & dev_fit)
    dim_ind = sl.feas[:, :, None] & ~fit_dims
    return score, placeable, exh, dim_ind


def _rerank(k, c: _Inputs, st: _Carry, mid: _Mid):
    """Fresh re-rank of the shortlist against post-commit state, the
    cutoff audit (TR3) and the incremental counters.  Returns the next
    wave's window, tables and counters, and `ok_next` on the card."""
    i32 = torch.int32
    sl, TKl = st.sl, k.TKl
    _, _, exh_pre, dim_pre = _sl_eval(k, c, sl, mid.used_pre,
                                      mid.dev_used_pre, st.sp_used)
    f_score, f_place, exh_post, dim_post = _sl_eval(k, c, sl, st.used,
                                                    st.dev_used, st.sp_used)
    # only shortlist nodes changed (TR1-guarded), so the full-N counters
    # advance by the shortlist delta
    d_exh = (exh_post.to(i32) - exh_pre.to(i32)).sum(dim=1)
    d_dim = (dim_post.to(i32) - dim_pre.to(i32)).sum(dim=1)
    nexh_next = (mid.n_exh_g + d_exh).to(i32)
    ndim_next = (mid.dim_exh_g + d_dim).to(i32)
    # the lex tie-break key: GLOBAL ids under the elastic remap (as the
    # building extraction and cut_i), local slots otherwise
    sl_key = k.l2g(sl.idx).to(i32) if k.elastic else sl.idx
    w_s, w_i = _lex_topk(f_score, sl_key, TKl)
    # TR3: the re-ranked TKl-th key must still dominate the era cutoff
    ls, li = w_s[:, TKl - 1], w_i[:, TKl - 1]
    tr3_g = (ls > sl.cut_s) | ((ls == sl.cut_s) & (li <= sl.cut_i))
    if k.want_tables:
        vnode0 = sl.vn[0]
        tabs_s, tabs_i = [], []
        for v in range(k.Vs + 1):
            vmask = (vnode0 == v) if v < k.Vs else (vnode0 < 0)
            ts, ti = _lex_topk(torch.where(vmask, f_score, NEG_INF),
                               sl_key, k.TW)
            tabs_s.append(ts)
            tabs_i.append(ti)
        tab_s = torch.stack(tabs_s, dim=1)
        tab_i = torch.stack(tabs_i, dim=1)
        if k.in_mesh and not k.elastic:
            tab_i = tab_i + k.off
    else:
        tab_s, tab_i = c.no_tab_s, c.no_tab_i
    gany_next = torch.where(sl.comp, f_place.any(dim=1), True)
    ok_next = ((tr3_g | sl.comp) | ~mid.act_next_g).all()
    if k.in_mesh and not k.elastic:
        w_i = w_i + k.off
    return (w_s, w_i, tab_s, tab_i, nexh_next, ndim_next, gany_next,
            ok_next)


def _wave_rerank(k, c: _Inputs, st: _Carry, mid: _Mid, do: bool):
    """The wave's end after its rerank decision: with `do` the rerank
    (`_rerank`), else an empty window; the shortlist's carry takes the
    next wave's window, tables and counters.  Returns (carry, ok_next on
    the card, None without the rerank)."""
    f32, i32, device = torch.float32, torch.int32, k.device
    SL = st.sl
    if do:
        (nw_s, nw_i, ntb_s, ntb_i, n_nexh, n_ndim, n_gany,
         ok_next) = _rerank(k, c, st, mid)
    else:
        nw_s = torch.full((k.Gp, k.TKl), NEG_INF, dtype=f32, device=device)
        nw_i = torch.zeros((k.Gp, k.TKl), dtype=i32, device=device)
        ntb_s = torch.full(SL.tb_s.shape, NEG_INF, dtype=f32, device=device)
        ntb_i = torch.zeros(SL.tb_i.shape, dtype=i32, device=device)
        n_nexh, n_ndim = SL.nexh, SL.ndim
        n_gany = torch.zeros(k.Gp, dtype=torch.bool, device=device)
        ok_next = None
    sl = SL._replace(win_s=nw_s, win_i=nw_i.to(i32), tb_s=ntb_s,
                     tb_i=ntb_i.to(i32), nfeas=mid.n_feas_g, nexh=n_nexh,
                     ndim=n_ndim, gany=n_gany)
    return st._replace(sl=sl), ok_next


def _drain(gen):
    """The return value of a wave generator that asks for nothing (a
    solve off the mesh)."""
    try:
        req = next(gen)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a captured wave asked for {req[0]!r}")


def _eager_body(k, c: _Inputs, st: _Carry, take_carried, early, rot, wave):
    """A wave body op by op (`_wave_body`, after the full pass's
    scoring)."""
    prep = sc = None
    if not take_carried:
        prep = _wave_prep(k, c, st)
        sc = _wave_scores(k, c, st, prep)
    return (yield from _wave_body(k, c, st, sc, prep, take_carried, early,
                                  rot, wave))


class _GraphWaves:
    """A single-lane solve's waves as replays of its plan's graphs
    (`wave_graph`).  The plan's buffers (`_graph_bufs`) hold the solve's
    inputs (`c`), the carry, what a wave body hands its rerank (`mid`),
    the fused kernel's outputs (`kout`) and the wave index.  Each wave
    replays the full pass's prep ("prep"), calls the fused kernel
    eagerly through `wave_kernel.fused_wave` into `kout`, replays the
    body ("body", by carried window and spread's early half) and, after
    the rerank decision, the wave's end ("rerank", by the decision).  A
    stretch is captured where a solve of the plan first needs it;
    `captures` counts this solve's."""

    def __init__(self, k, c, plan):
        self.k, self.c, self.plan, self.b = k, c, plan, plan.bufs
        self.captures = 0

    def _run(self, key, pure, commit):
        seg, captured = self.plan.segment(key, pure, commit)
        self.captures += captured
        return seg.replay()

    def start(self, used0, dev_used0, sp_used0) -> _Carry:
        k, b = self.k, self.b
        names = b.per_solve
        torch._foreach_copy_(
            [getattr(b.c, n) for n in names]
            + [b.st.used, b.st.dev_used, b.st.sp_used],
            [getattr(self.c, n) for n in names]
            + [used0, dev_used0, sp_used0])

        def pure():
            return _init_carry(k, b.c, b.st.used, b.st.dev_used,
                               b.st.sp_used)

        def commit(out):
            wave_graph.copy_nest(b.st, out)
            b.wave_t.zero_()
        self._run("init", pure, commit)
        return b.st

    def body(self, take_carried: bool, early: bool):
        k, b = self.k, self.b
        prep = None
        if not take_carried:
            prep = self._run("prep", lambda: _wave_prep(k, b.c, b.st),
                             lambda out: None)
            _wave_scores(k, self.c, b.st, prep, out=b.kout)
        rot = b.wave_t if k.seed_nz else 0

        def pure():
            sc = None if take_carried else _wk.results(b.kout, k.R)
            return _drain(_wave_body(k, b.c, b.st, sc, prep, take_carried,
                                     early, rot, 0))

        def commit(out):
            st, mid, _ = out
            if mid is not None:
                wave_graph.copy_nest(b.mid, mid)
            wave_graph.copy_nest(b.st, st)
            b.wave_t.add_(1)
        _, mid, flags = self._run(("body", take_carried, early), pure,
                                  commit)
        return b.st, (None if mid is None else b.mid), flags

    def rerank(self, do: bool):
        k, b = self.k, self.b

        def pure():
            return _wave_rerank(k, b.c, b.st, b.mid, do)
        _, ok_next = self._run(("rerank", do), pure,
                               lambda out: wave_graph.copy_nest(b.st,
                                                                out[0]))
        return b.st, ok_next

    def finish(self, st: _Carry) -> _Carry:
        """The carry's results as tensors of their own: the next solve
        of the plan rewrites the buffers."""
        return st._replace(**{f: getattr(st, f).clone() for f in (
            "used", "dev_used", "out_idx", "out_ok", "out_score",
            "out_nfeas", "out_nexh", "out_dimexh")})


def _graph_bufs(k, c: _Inputs, st: _Carry):
    """A new plan's buffers, shaped as the solve's tensors: `c` (its
    per-solve fields copied at each solve's start, the signature's
    constants once), the carry (`st` the first solve's initial carry),
    what a body hands its rerank, the fused kernel's outputs and the
    wave index."""
    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=k.device)
    names = [n for n, t in c._asdict().items()
             if isinstance(t, torch.Tensor) and n not in _GRAPH_SKIP]
    i32 = torch.int32
    mid = None
    if k.use_sl:
        mid = _Mid(used_pre=like(st.used), dev_used_pre=like(st.dev_used),
                   n_feas_g=empty(k.Gp, i32), n_exh_g=empty(k.Gp, i32),
                   dim_exh_g=empty((k.Gp, k.R), i32),
                   act_next_g=empty(k.Gp, torch.bool))
    return types.SimpleNamespace(
        c=_Inputs(**({n: None for n in c._fields} | {
            n: (getattr(c, n).clone() if n in _GRAPH_CONST
                else like(getattr(c, n))) for n in names})),
        per_solve=[n for n in names if n not in _GRAPH_CONST],
        st=_Carry(*(None if x is None else x._make(like(y) for y in x)
                    if isinstance(x, tuple) else like(x) for x in st)),
        mid=mid,
        kout=_wk.out_buffers(
            k.pallas_mode, k.Gp, k.Np, k.R, k.device, k.TK, k.NE,
            k.Vs if (k.want_tables and k.pallas_mode == "topk") else 0),
        wave_t=torch.zeros((), dtype=torch.int64, device=k.device))


def solve_steps(avail, reserved, used0, valid, node_dc, attr_rank,
                ask_res, ask_desired, distinct, dc_ok, host_ok, coll0,
                penalty,
                c_op, c_col, c_rank, a_op, a_col, a_rank, a_weight, a_host,
                sp_col, sp_weight, sp_targeted, sp_desired, sp_implicit,
                sp_used0, dev_cap, dev_used0, dev_ask, p_ask, n_place,
                seed=0, *, has_spread=True, group_count_hint=0,
                max_waves=0, wave_mode="scan", has_distinct=True,
                has_devices=True, stack_commit=False, pallas_mode="off",
                shortlist_c=0, mesh_axis=None, mesh_shards=0,
                has_preempt=False, ev_res=None, ev_prio=None, ask_prio=None,
                mesh_hosts=0, mesh_nt=0, tile_np=0, node_gid=None,
                owner_map=None, slot_map=None, learned=None, mesh_regions=0,
                region_bias=None, wave_ranges=True, single_lane=False):
    """The wave solve as a generator.  With the shortlist on it yields
    ("carried", ok) at each wave's start and ("rerank", pre_ok) at each
    wave's end, and takes the decision sent back; it returns the
    SolveResult.  `pallas_mode` picks the wave scorer: "off" (the
    spec-driven torch scorer), "score" / "topk" (the fused wave kernel's
    modes) or "auto" (`wave_kernel.resolve_mode` on CUDA, "off" on the
    CPU).  `group_count_hint` sizes the wave window (0: K // 8).
    `has_preempt` runs the eviction pass over the planes `ev_res`
    [Np, E, R], `ev_prio` [Np, E] and `ask_prio` [Gp].  `learned` /
    `region_bias` ([Gp, Np] f32) add their scorers and pin the
    spec-driven scorer with the shortlist off.

    `mesh_axis` (with `mesh_shards`) runs the solve as one shard of a
    mesh (module docstring): "nodes", ("hosts", "chips") with
    `mesh_hosts`, or ("regions", "hosts", "chips") with `mesh_regions`
    and `mesh_hosts` hosts a region.  The contiguous layout gives shard
    i the global ids i * Np + local; `tile_np` > 0 is the elastic
    layout, where `node_gid` [Np] maps local slots to global ids and
    `owner_map` / `slot_map` [T + 1] (a -1 sentinel row last) map a
    global id's tile to its shard and local tile slot; `mesh_nt` is the
    global padded node axis (default Np * mesh_shards).

    `single_lane` (set by the drivers of one solve, `solve_kernel` and
    `solve_lanes` with one lane) lets the waves run as CUDA graphs
    (`wave_graph`): on a CUDA device, with the fused wave kernel, and
    without the eviction pass or a mesh, a solve whose signature (shapes
    and options, `_graph_sig`) was seen before replays the wave's
    fixed-shape stretches captured from it; the kernel itself is called
    eagerly each wave.  The answers are those of the eager waves.

    The result's `n_syncs` counts the points where the host waits for
    the card: one read of each wave's flags (its next entry test and
    the carried window's premise), the rerank's test, the eviction
    pass's gate and `nonzero` and, in mesh mode, the rescore count's
    sum; `n_graphed` counts the waves whose body replayed a graph,
    `n_conflict_kernel` those whose conflict check and commits ran on
    the node-segmented CUDA kernels (`seg_kernel`: above 2,048
    placements a wave, on CUDA, off the mesh; counted from the commit
    kernel's launches, replays included) and `n_captures` the graphs
    this solve captured.  `filtered_pairs`
    counts the real [group, node] pairs (the groups with placements, the
    valid nodes) that the static feasibility rules out; it is summed on
    the card in the prologue and read with the first wave's flags, so it
    costs no sync of its own (0 in mesh mode, and in a solve with no
    wave).  Under a torch profiler the prologue, from the solve's entry
    to its first wave, is a `nomad.solve.prologue` range, closed before
    the first yield; each sync is a `nomad.wave.sync` range around the
    blocking call alone and each wave a `nomad.wave.full` or
    `nomad.wave.carried` range from its kind's decision to the next
    wave's (`_WaveRanges`).
    `wave_ranges` False (solves in lock-step) and mesh mode open no
    range: `solve_lanes` or `solve_shards` opens the waves."""
    if wave_mode not in ("scan", "while"):
        raise ValueError(f"solve_kernel: unknown wave_mode {wave_mode!r}")
    device = avail.device
    _exact_matmul_on(device)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    seed = int(seed)
    n_place = int(n_place)
    max_waves = max_waves or MAX_WAVES
    Np, R = avail.shape
    Gp = ask_res.shape[0]
    S = sp_col.shape[1]
    K = p_ask.shape[0]

    # ---------- mesh mode: this shard's place on the node axis ----------
    in_mesh = mesh_axis is not None
    elastic = in_mesh and tile_np > 0
    rg = _WaveRanges(wave_ranges and not in_mesh)
    rg.prologue()
    g_of_local = _g2l = _l2g = off = None
    if in_mesh:
        if mesh_shards < 1:
            raise ValueError("mesh_axis requires mesh_shards")
        if isinstance(mesh_axis, tuple):
            n_reg = mesh_regions if len(mesh_axis) == 3 else 1
            if len(mesh_axis) not in (2, 3) or n_reg < 1 \
                    or mesh_shards % n_reg or mesh_hosts < 1 \
                    or (mesh_shards // n_reg) % mesh_hosts:
                raise ValueError(
                    f"mesh_axis {mesh_axis!r} needs mesh_regions and "
                    f"mesh_hosts dividing the shards: regions="
                    f"{mesh_regions} hosts={mesh_hosts} "
                    f"shards={mesh_shards}")
        if elastic and (node_gid is None or owner_map is None
                        or slot_map is None):
            raise ValueError("tile_np > 0 needs node_gid/owner_map/"
                             "slot_map tables")
        my_lin = int((yield ("axis_index", mesh_axis)))
        if elastic:
            g_of_local = node_gid.to(i64)                  # [Np]
            om_l, sm_l = owner_map.to(i64), slot_map.to(i64)
            n_tiles_s = owner_map.shape[0] - 1             # sentinel row

            def _g2l(gid):
                """global id -> (owned here, local slot with non-owned
                ids pinned to the dropped slot Np, that slot clamped for
                gathers); dead-slot ids land on the sentinel owner -1."""
                gid = gid.to(i64)
                t = torch.clamp(torch.div(gid, tile_np,
                                          rounding_mode="floor"),
                                0, n_tiles_s)
                own = (om_l[t] == my_lin) & (gid >= 0)
                loc = torch.where(own, sm_l[t] * tile_np
                                  + torch.remainder(gid, tile_np), Np)
                return own, loc, loc.clamp(0, Np - 1)
        else:
            off = my_lin * Np
            g_of_local = off + torch.arange(Np, dtype=i64, device=device)

            def _g2l(gid):
                loc = gid.to(i64) - off
                own = (loc >= 0) & (loc < Np)
                loc = torch.where(own, loc, Np)
                return own, loc, loc.clamp(0, Np - 1)

        def _l2g(idx):
            return g_of_local[idx.to(i64)]
    # the global padded node axis clamps the candidate window (the
    # elastic layout's slack slots are not part of it)
    NT = (mesh_nt or Np * mesh_shards) if in_mesh else Np

    per_group = group_count_hint if group_count_hint > 0 else K // 8
    w_cap = _MERGED_W_CAP if Gp <= MERGED_GP_MAX else _WIDE_W_CAP
    TK = min(max(WAVE_K, min(2 * per_group, w_cap)) + TOP_K, NT)
    W = max(TK - TOP_K, 1)          # effective per-group wave width
    # each shard surfaces its top min(TK, Np) keys to the merge
    TKl = min(TK, Np)
    # the hand-written shortlist twin and the CUDA wave kernel do not
    # implement the learned / region terms: with a plane both stay off
    planes = learned is not None or region_bias is not None
    C = (0 if (has_distinct or planes)
         else resolve_shortlist_c(Np, TKl, shortlist_c))
    use_sl = C > 0
    NE = C if use_sl else TKl       # full-wave extraction width
    ks = torch.arange(K, device=device)
    gs = torch.arange(Gp, device=device)
    g_idx = p_ask.to(i64)
    attr_rank_l = attr_rank.to(i64)

    # ---------- in-kernel preemption planes ----------
    EV = 0
    ev_slot_ok = ev_res_f = ev_prio_i = None
    if has_preempt:
        if has_distinct:
            raise ValueError(
                "has_preempt does not compose with distinct_hosts batches "
                "(cross-group blocking is invisible to the eviction "
                "pass); callers keep the host preemption walk")
        if ev_res is None or ev_prio is None or ask_prio is None:
            raise ValueError("has_preempt needs ev_res/ev_prio/ask_prio")
        if R != 4:
            raise ValueError(f"the eviction pass expects R = 4, got {R}")
        EV = ev_prio.shape[1]
        ev_prio_i = ev_prio.to(i32)
        ev_res_f = ev_res.to(f32)
        # wave-invariant slot eligibility: a real slot whose priority is
        # at least EV_PRIORITY_DELTA below the ask's
        ev_slot_ok = ((ev_prio_i[None, :, :] >= 0)
                      & (ask_prio.to(i32)[:, None, None]
                         - ev_prio_i[None, :, :] >= EV_PRIORITY_DELTA))

    # ---------- static feasibility [Gp, Np] ----------
    feas, cons_filtered = static_feas(valid, node_dc, attr_rank, dc_ok,
                                      host_ok, c_op, c_col, c_rank)
    if in_mesh:
        cons_filtered = yield ("psum", cons_filtered)
        n_filt = None
    else:
        real_g = torch.zeros(Gp, dtype=torch.bool, device=device
                             ).index_fill_(0, g_idx[:n_place], True)
        n_filt = (real_g[:, None] & valid[None, :] & ~feas).sum()

    # affinity matches are placement-invariant: [Gp, Np]
    vals = attr_rank_l[:, a_col.to(i64)].permute(1, 0, 2)   # [Gp, Np, CA]
    match = _op_eval(vals, a_op, a_rank)
    weighted = match * a_weight[:, None, :]
    aff = torch.zeros((Gp, Np), dtype=f32, device=device)
    for a in range(weighted.shape[2]):
        aff = aff + weighted[:, :, a]
    aff_score = aff + a_host

    # ---------- hoisted spread lookups (wave-invariant) ----------
    # a gather of attr_rank[:, col] (the reference's one-hot matmul was a
    # TPU gather workaround giving the same integers)
    V = sp_desired.shape[2]
    if has_spread:
        vns, des = [], []
        for s in range(S):
            col = sp_col[:, s].to(i64)                      # [Gp]
            v = attr_rank_l[:, col.clamp(min=0)].T          # [Gp, Np]
            v = torch.where((col >= 0)[:, None], v, -1)
            if V <= _SELECT_SUM_MAX_V:
                d = torch.zeros((Gp, Np), dtype=f32, device=device)
                for val in range(V):
                    d = d + torch.where(v == val,
                                        sp_desired[:, s, val][:, None], 0.0)
            else:
                d = torch.gather(sp_desired[:, s], 1, v.clamp(min=0))
            d = torch.where(v >= 0, d, -1.0)
            d = torch.where(d < 0, sp_implicit[:, s][:, None], d)
            vns.append(v.to(i32))
            des.append(d)
        sp_vnode = torch.stack(vns)                         # [S, Gp, Np]
        sp_des = torch.stack(des)
    else:
        sp_vnode = sp_des = None

    # ---------- seeded tie-break jitter [Gp, Np] and rotation ----------
    # (the GLOBAL id in mesh mode, so a node scores alike however the
    # node axis is split); the per-group salts and the rank-wrap's
    # rotation offsets hash the seed once, on the host and the card
    gsalt = _jitter_salt(gs, seed)
    node_ids = (g_of_local if in_mesh
                else torch.arange(Np, dtype=i64, device=device))
    if seed == 0:
        jitter = torch.zeros((Gp, Np), dtype=f32, device=device)
    else:
        jitter = _jitter(node_ids[None, :], gsalt)
    if seed == 0 or stack_commit:
        g_off = torch.zeros(Gp, dtype=i64, device=device)
    else:
        g_hash = (_mul32(gs, 2654435761)
                  ^ (((seed & _U32) * 2246822519) & _U32))
        g_off = (g_hash >> 8) % W

    # ---------- fused wave kernel path (mode pick) ----------
    if planes:
        pallas_mode = "off"
    if pallas_mode == "auto":
        pallas_mode = _wk.resolve_mode(Np, Gp, TK, V, has_spread,
                                       on=device.type == "cuda")
    Vs = V
    want_tables = has_spread and Vs <= 8 and not stack_commit
    # per-value table widths: TKv the global window per value class, TW
    # the shard's extraction width
    TKv = -(-TK // (Vs + 1)) if want_tables else 0
    TW = min(TKv, Np) if want_tables else 0
    if in_mesh and pallas_mode == "topk" and want_tables and TW < TKv:
        # the topk kernel sizes its tables from TK, past a shard this
        # narrow; "score" is the same math with the extraction below
        pallas_mode = "score"
    if elastic and pallas_mode == "topk":
        # the topk kernel breaks ties by local slot, which under a tile
        # remap is not global-id order
        pallas_mode = "score"
    use_pk = pallas_mode != "off"
    pk_feas = pk_pen = pk_sp_has = pk_vnode = None
    if use_pk:
        # bitpacked static planes and int16 value ranks, once per solve
        pk_feas = pack_bool_u32(feas)
        pk_pen = pack_bool_u32(penalty)
        pk_sp_has = (sp_col >= 0).to(torch.int8) if has_spread else None
        pk_vnode = sp_vnode.to(torch.int16) if has_spread else None

    # the wave segments' shape and options (`k`) and tensors (`c`)
    k = types.SimpleNamespace(
        device=device, Np=Np, R=R, Gp=Gp, S=S, K=K, V=V, Vs=Vs, TK=TK,
        TKl=TKl, TKv=TKv, TW=TW, W=W, NE=NE, C=C, EV=EV, use_sl=use_sl,
        use_pk=use_pk, pallas_mode=pallas_mode, has_spread=has_spread,
        has_distinct=has_distinct, has_devices=has_devices,
        has_preempt=has_preempt, stack_commit=stack_commit,
        want_tables=want_tables, in_mesh=in_mesh, elastic=elastic,
        seed=seed, seed_nz=seed != 0, rg=rg, g2l=_g2l, l2g=_l2g, off=off,
        g_of_local=g_of_local)
    if _seg_path(k):
        _check_sort_keys(NT, Gp, V)
    c = _Inputs(
        avail=avail, reserved=reserved, valid=valid, attr_rank=attr_rank,
        attr_rank_l=attr_rank_l, ask_res=ask_res, ask_desired=ask_desired,
        distinct=distinct, coll0=coll0, penalty=penalty, feas=feas,
        aff_score=aff_score, sp_col=sp_col, sp_weight=sp_weight,
        sp_targeted=sp_targeted, sp_desired=sp_desired,
        sp_implicit=sp_implicit, sp_vnode=sp_vnode, sp_des=sp_des,
        dev_cap=dev_cap, dev_ask=dev_ask, g_idx=g_idx,
        in_batch=ks < n_place, g_off=g_off, gsalt=gsalt, jitter=jitter,
        pk_feas=pk_feas, pk_pen=pk_pen, pk_sp_has=pk_sp_has,
        pk_vnode=pk_vnode, learned=learned, region_bias=region_bias,
        ev_slot_ok=ev_slot_ok, ev_res_f=ev_res_f, ev_prio_i=ev_prio_i,
        ks=ks, gs=gs, offs_k=torch.arange(TOP_K, device=device),
        no_tab_s=torch.full((Gp, 1, 1), NEG_INF, dtype=f32, device=device),
        no_tab_i=torch.zeros((Gp, 1, 1), dtype=i32, device=device))

    # ---------- the waves: replayed graphs or op by op ----------
    gw = None
    if (single_lane and use_pk and not (in_mesh or has_preempt)
            and wave_graph.engages(device)):
        def make():
            return wave_graph.Plan(device, _graph_bufs(
                k, c, _init_carry(k, c, used0, dev_used0, sp_used0)))
        plan = wave_graph.PLANS.sight(_graph_sig(k, c, used0, dev_used0,
                                                 sp_used0), make)
        if plan is not None:
            gw = _GraphWaves(k, c, plan)
    try:
        if gw is not None:
            st = gw.start(used0, dev_used0, sp_used0)
        else:
            st = _init_carry(k, c, used0, dev_used0, sp_used0)
        rg.close()                  # the prologue ends before any yield
        # the first wave's entry test is known on the host
        go = n_place > 0 and K > 0
        sl_ok = False
        wave = n_resc = n_graphed = n_seg = filtered = 0
        for _ in range(max_waves):
            if not go:
                break
            take_carried = (yield ("carried", sl_ok)) if use_sl else False
            rg.step(take_carried)
            early = has_spread and wave < max(max_waves // 2, 1)
            commits0 = _sk.thread_launches("commit")
            if gw is not None:
                st, mid, flags = gw.body(take_carried, early)
                n_graphed += 1
            else:
                st, mid, flags = yield from _eager_body(
                    k, c, st, take_carried, early, 0 if seed == 0 else wave,
                    wave)
            if not take_carried:
                n_resc += 1
            # the body's commits launched the node-segmented kernel
            # (its own launch, or a replay of a graph that holds it)
            n_seg += _sk.thread_launches("commit") > commits0
            if wave == 0 and n_filt is not None:
                # the filtered pairs ride on the first wave's flags
                flags = torch.cat([flags.to(i64), n_filt.view(1)])
            # (as_tensor returns the flags tensor itself; it marks the
            # value a tensor for the analyzer's map of host syncs)
            with rg.sync():
                flags = torch.as_tensor(flags).tolist()
            if wave == 0 and n_filt is not None:
                filtered = flags.pop()
            go = flags[0]
            if use_sl:
                pre_ok = go and flags[1] and not (has_preempt and flags[2])
                # under lock-step a lane may rerank on a void premise:
                # its `ok` stays False and the next wave's full pass
                # rebuilds the window before anything reads it
                do = bool((yield ("rerank", pre_ok)))
                if gw is not None:
                    st, ok_next = gw.rerank(do)
                else:
                    st, ok_next = _wave_rerank(k, c, st, mid, do)
                sl_ok = False
                if do and pre_ok:
                    with rg.sync():
                        sl_ok = bool(torch.as_tensor(ok_next))
            wave += 1
        rg.close()
        unfinished = ~st.done & c.in_batch
        if gw is not None:
            st = gw.finish(st)
    finally:
        if gw is not None:
            gw.plan.release()

    if in_mesh:
        # per-shard full passes summed over the mesh (the byte model
        # charges a per-shard plane walk for each); two syncs, the
        # count's host copy onto the card and its sum's fetch
        if use_sl:
            with rg.sync():
                n_resc_t = torch.tensor(n_resc, device=device)
            with rg.sync():
                n_resc = int((yield ("psum", n_resc_t)))
        else:
            n_resc = wave * mesh_shards
    return SolveResult(choice=st.out_idx, choice_ok=st.out_ok,
                       score=st.out_score, n_feasible=st.out_nfeas,
                       n_exhausted=st.out_nexh,
                       dim_exhausted=st.out_dimexh, feas=feas,
                       cons_filtered=cons_filtered, used_final=st.used,
                       dev_used_final=st.dev_used, n_waves=wave,
                       unfinished=unfinished,
                       n_rescore=n_resc if (use_sl or in_mesh) else wave,
                       evict=st.out_evict if has_preempt else None,
                       commit_wave=st.out_wave if has_preempt else None,
                       n_syncs=rg.syncs, n_graphed=n_graphed,
                       n_conflict_kernel=n_seg,
                       n_captures=0 if gw is None else gw.captures,
                       filtered_pairs=filtered)


def _graph_sig(k, c: _Inputs, used0, dev_used0, sp_used0) -> tuple:
    """A solve's graph signature: its shapes and options, and the shape
    and dtype of every tensor its captured stretches read."""
    opts = (k.device, k.Np, k.R, k.Gp, k.S, k.K, k.V, k.TK, k.TKl, k.NE,
            k.C, k.W, k.pallas_mode, k.has_spread, k.has_distinct,
            k.has_devices, k.stack_commit, k.want_tables, k.seed_nz)
    return opts + tuple(
        (n, tuple(t.shape), t.dtype) for n, t in
        [*((n, t) for n, t in c._asdict().items()
           if isinstance(t, torch.Tensor) and n not in _GRAPH_SKIP),
         ("used0", used0), ("dev_used0", dev_used0),
         ("sp_used0", sp_used0)])
