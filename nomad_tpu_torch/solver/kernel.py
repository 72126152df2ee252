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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import score_spec as _score_spec
from . import wave_kernel as _wk
from ..utils.tracing import (NULL_SPAN, WAVE_CARRIED, WAVE_FULL, WAVE_SYNC,
                             device_range)
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


class _WaveRanges:
    """A wave solve's profiler ranges (`utils.tracing.device_range`) and
    its count of host syncs.  `sync()` counts one sync and returns its
    `nomad.wave.sync` range, to be held around the blocking call alone;
    `step(carried)` ends the open wave range and opens the next one at a
    wave's carried-window decision, `nomad.wave.carried` for a
    carried-shortlist wave and `nomad.wave.full` for a full pass; `close()`
    ends the last.  A wave's range so runs from its decision to the next
    wave's, and holds the next wave's entry test.  With `on` False
    nothing opens; syncs still count."""

    __slots__ = ("on", "syncs", "_open")

    def __init__(self, on: bool):
        self.on = on
        self.syncs = 0
        self._open = NULL_SPAN

    def sync(self):
        self.syncs += 1
        return device_range(WAVE_SYNC) if self.on else NULL_SPAN

    def step(self, carried: bool) -> None:
        self.close()
        if self.on:
            self._open = device_range(WAVE_CARRIED if carried
                                      else WAVE_FULL)
            self._open.__enter__()

    def close(self) -> None:
        self._open.__exit__(None, None, None)
        self._open = NULL_SPAN


class _SLState(NamedTuple):
    """Wave-loop carry for the shortlist-resident contention path (the
    reference's `_SLState`): per-entry planes gathered at the last full
    wave, the era cutoff key, and the next wave's pre-computed window,
    tables and counters, which `ok` allows the next wave to use."""
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
    ok: bool                    # next wave may skip the full pass


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


def _jitter(gid: torch.Tensor, gs: torch.Tensor, seed: int,
            syncs: _WaveRanges) -> torch.Tensor:
    """Seeded tie-break jitter for node ids `gid` [Gp, *] of groups `gs`
    [Gp]: the reference's uint32 hash, (h & 1023) * SCORE_BIN / 1023.
    `syncs` (the solve's `_WaveRanges`) counts and ranges the host copy
    of the step onto the card."""
    s32 = seed & _U32
    gsalt = (_mul32(gs, 7919) + s32) & _U32
    h = (_mul32(gid & _U32, 2654435761)
         + _mul32(gsalt, 40503)[:, None]) & _U32
    h = _mul32(h ^ (h >> 16), 2246822519)
    with syncs.sync():
        step = torch.tensor(_score_spec.SCORE_BIN / 1023.0,
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
    return solve_lanes([solve_steps(*args, **kw)])[0]


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
                region_bias=None, wave_ranges=True):
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

    The result's `n_syncs` counts the points where the host waits for
    the card: the truth tests of the wave loop and the rerank, the host
    copies of the seed's constants onto the card, the eviction pass's
    `nonzero` and, in mesh mode, the rescore count's sum.  Under a torch
    profiler each is a `nomad.wave.sync` range around the blocking call
    alone and each wave a `nomad.wave.full` or `nomad.wave.carried`
    range from its kind's decision to the next wave's (`_WaveRanges`).
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

    # affinity matches are placement-invariant: [Gp, Np]
    vals = attr_rank_l[:, a_col.to(i64)].permute(1, 0, 2)   # [Gp, Np, CA]
    match = _op_eval(vals, a_op, a_rank)
    weighted = match * a_weight[:, None, :]
    aff = torch.zeros((Gp, Np), dtype=f32, device=device)
    for k in range(weighted.shape[2]):
        aff = aff + weighted[:, :, k]
    aff_score = aff + a_host
    pen_score, pen_counts = _score_spec.static_terms(_TORCH_OPS, penalty)

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

    # ---------- seeded tie-break jitter [Gp, Np] ----------
    # (the GLOBAL id in mesh mode, so a node scores alike however the
    # node axis is split)
    node_ids = (g_of_local if in_mesh
                else torch.arange(Np, dtype=i64, device=device))
    if seed == 0:
        jitter = torch.zeros((Gp, Np), dtype=f32, device=device)
    else:
        jitter = _jitter(node_ids[None, :], gs, seed, rg)

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
    if use_pk:
        # bitpacked static planes and int16 value ranks, once per solve
        pk_feas = pack_bool_u32(feas)
        pk_pen = pack_bool_u32(penalty)
        pk_sp_has = (sp_col >= 0).to(torch.int8) if has_spread else None
        pk_vnode = sp_vnode.to(torch.int16) if has_spread else None

    def group_scores(used, dev_used, coll, sp_used, blocked):
        ctx = dict(
            used=used, dev_used=dev_used, coll=coll, sp_used=sp_used,
            blocked=blocked, avail=avail, reserved=reserved,
            ask_res=ask_res, ask_desired=ask_desired, dev_cap=dev_cap,
            dev_ask=dev_ask, feas=feas, pen_score=pen_score,
            pen_counts=pen_counts, aff_score=aff_score,
            has_devices=has_devices, has_spread=has_spread,
            sp_col=sp_col, sp_weight=sp_weight, sp_targeted=sp_targeted,
            vnode=sp_vnode, des=sp_des, S=S, V=V, shape=(Gp, Np),
            seed=seed, jitter=jitter, learned=learned,
            region_bias=region_bias)
        return _score_spec.evaluate_wave(_TORCH_OPS, ctx)

    # ---------- shortlist scoring twin ----------
    def _sl_eval(sl, used_x, dev_used_x, sp_used_x):
        """Exact score/indicator recompute for the <= C shortlist
        entries from gathered live state, term for term the full
        rescore restricted to these nodes.  Returns (score, placeable,
        exh_ind, dim_ind)."""
        idx = sl.idx.to(i64)
        u = used_x[idx]                                    # [Gp, C, R]
        av = avail[idx]
        rsv = reserved[idx]
        after = u + ask_res[:, None, :]
        fit_dims = after <= av
        fit = fit_dims.all(dim=-1)
        if has_devices:
            dev_fit = (dev_used_x[idx] + dev_ask[:, None, :]
                       <= dev_cap[idx]).all(dim=-1)
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
                           -(sl.coll + 1.0) / ask_desired[:, None], 0.0)
        anti_counts = sl.coll > 0

        if has_spread:
            spread_total = torch.zeros((Gp, C), dtype=f32, device=device)
            inf = float("inf")
            for s in range(S):
                has = sp_col[:, s] >= 0
                v = sl.vn[s]
                has_v = v >= 0
                used_vec = sp_used_x[:, s]
                cur = torch.where(v >= 0, torch.gather(
                    used_vec, 1, v.clamp(min=0).to(i64)), 0.0)
                desired = sl.de[s]
                boost = ((desired - (cur + 1.0))
                         / torch.clamp(desired, min=1e-9)
                         ) * sp_weight[:, s][:, None]
                targeted = torch.where(~has_v, -1.0,
                                       torch.where(desired <= 0, -1.0,
                                                   boost))
                present = used_vec > 0
                any_present = present.any(dim=1)[:, None]
                minc = torch.where(present, used_vec, inf).amin(
                    dim=1)[:, None]
                maxc = torch.where(present, used_vec, -inf).amax(
                    dim=1)[:, None]
                delta_boost = (minc - cur) / torch.clamp(minc, min=1e-9)
                even = torch.where(cur != minc, delta_boost,
                                   torch.where(minc == maxc, -1.0,
                                               (maxc - minc)
                                               / torch.clamp(minc,
                                                             min=1e-9)))
                even = torch.where(~has_v, -1.0, even)
                even = torch.where(any_present, even, 0.0)
                contrib = torch.where(sp_targeted[:, s][:, None], targeted,
                                      even)
                spread_total = spread_total + torch.where(
                    has[:, None], contrib, 0.0)
            spread_counts = spread_total != 0.0
        else:
            spread_total = 0.0
            spread_counts = False

        aff_counts = sl.aff != 0.0
        pen_sc = torch.where(sl.pen, -1.0, 0.0)
        n_scorers = (1.0 + anti_counts + sl.pen + aff_counts
                     + spread_counts)
        total = (binpack + anti + pen_sc + sl.aff
                 + spread_total) / n_scorers
        if seed != 0:
            total = (torch.floor(total / _score_spec.SCORE_BIN)
                     * _score_spec.SCORE_BIN)
            jit_sl = _jitter(_l2g(idx) if in_mesh else idx, gs, seed, rg)
        else:
            jit_sl = 0.0
        total = total + jit_sl
        score = torch.where(placeable, total, NEG_INF)
        exh = sl.feas & ~(fit & dev_fit)
        dim_ind = sl.feas[:, :, None] & ~fit_dims
        return score, placeable, exh, dim_ind

    def full_tables(score):
        """Per-value candidate tables from a full score plane: one class
        per value plus the missing-value class."""
        vnode = sp_vnode[0]
        tabs_s, tabs_i = [], []
        for v in range(Vs + 1):
            vmask = (vnode == v) if v < Vs else (vnode < 0)
            sv = torch.where(vmask, score, NEG_INF)
            if elastic:
                # gid-ordered ties; the ids leave GLOBAL
                ts, ti, _ = _gid_top(sv, g_of_local, TW)
                ti = ti.to(i32)
            else:
                ts, ti = _top_rows(sv, TW)
            tabs_s.append(ts)
            tabs_i.append(ti)
        return torch.stack(tabs_s, dim=1), torch.stack(tabs_i, dim=1)

    no_tab_s = torch.full((Gp, 1, 1), NEG_INF, dtype=f32, device=device)
    no_tab_i = torch.zeros((Gp, 1, 1), dtype=i32, device=device)
    if use_sl:
        vshape = (S, Gp, C) if has_spread else (1, 1, 1)
        tshape = (Gp, Vs + 1, TW) if want_tables else (Gp, 1, 1)
        SL = _SLState(
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
            gany=torch.zeros(Gp, dtype=torch.bool, device=device),
            ok=False)
    else:
        SL = None

    def full_wave(SL, used, dev_used, sp_used, done, out_idx, out_ok):
        """The full-N pass: rebuild coll/blocked from the committed
        outputs, score every (group, node) pair (fused kernel or torch
        scorer), extract the top-NE, window the first TK, reduce the
        explainability counters and, with the shortlist on, rebuild the
        carried shortlist from the same extraction."""
        committed = done & out_ok[:, 0]
        chosen = torch.where(committed, out_idx[:, 0], 0).to(i64)
        if in_mesh:
            # out_idx holds GLOBAL ids: rows of other shards drop
            chosen = _g2l(chosen)[1]
            coll = _add_drop(coll0, (g_idx, chosen), committed.to(f32), 1)
        else:
            coll = coll0.index_put((g_idx, chosen), committed.to(f32),
                                   accumulate=True)
        if has_distinct:
            dg_all = distinct[g_idx].to(i64)
            hit = _add_drop(
                torch.zeros((Gp, Np), dtype=i32, device=device),
                (dg_all.clamp(min=0), chosen),
                (committed & (dg_all >= 0)).to(i32), 1) > 0
            blocked = (hit[distinct.to(i64).clamp(min=0)]
                       & (distinct >= 0)[:, None])
        else:
            blocked = torch.zeros((Gp, Np), dtype=torch.bool, device=device)

        if use_pk:
            if has_spread:
                pres = sp_used > 0                          # [Gp, S, V]
                anyp = pres.any(dim=2)
                minc_w = torch.where(pres, sp_used, float("inf")).amin(2)
                maxc_w = torch.where(pres, sp_used, float("-inf")).amax(2)
                # rows with nothing present are pinned finite: their
                # contribution is masked to 0 either way
                spread_pack = (
                    pk_vnode, sp_des, sp_used, sp_weight, sp_targeted,
                    pk_sp_has, torch.where(anyp, minc_w, 0.0),
                    torch.where(anyp, maxc_w, 0.0), anyp.to(torch.int8))
            else:
                spread_pack = None
            pk = _wk.fused_wave(
                mode=pallas_mode, feas=pk_feas,
                blocked=pack_bool_u32(blocked) if has_distinct else None,
                aff=aff_score, pen=pk_pen, jitter=jitter, coll=coll,
                used=used, avail=avail, reserved=reserved,
                ask_res=ask_res, ask_desired=ask_desired,
                dev=(dev_used, dev_cap, dev_ask) if has_devices else None,
                spread=spread_pack, seed=seed, TK=TK, n_extract=NE,
                tables_v=Vs if (want_tables and pallas_mode == "topk")
                else 0)
            n_feas_g, n_exh_g = pk["n_feas"], pk["n_exh"]
            dim_exh_g, grp_any = pk["dim_exh"], pk["grp_any"]
            score = pk.get("score")          # None in "topk" mode
        else:
            score, placeable, feas_b, fit, fit_dims, dev_fit = \
                group_scores(used, dev_used, coll, sp_used, blocked)
            grp_any = placeable.any(dim=1)
            fv = feas_b & valid[None, :]
            n_feas_g = fv.sum(dim=1).to(i32)
            n_exh_g = (fv & ~(fit & dev_fit)).sum(dim=1).to(i32)
            dim_exh_g = (fv[:, :, None] & ~fit_dims).sum(dim=1).to(i32)

        if elastic:
            # under a tile remap local slot order is not global-id
            # order: extract by (score desc, GLOBAL id asc), carrying
            # the local slot
            ext_s, ext_g, ext_i = _gid_top(score, g_of_local, NE)
            ext_g, ext_i = ext_g.to(i32), ext_i.to(i32)
        elif use_pk and pallas_mode == "topk":
            ext_s, ext_i = pk["top_score"], pk["top_idx"]
        else:
            ext_s, ext_i = _top_rows(score, NE)            # [Gp, NE]
        top_score, top_idx = ext_s[:, :TKl], ext_i[:, :TKl]
        if elastic:
            top_idx = ext_g[:, :TKl]       # window keys are GLOBAL

        if want_tables:
            if use_pk and pallas_mode == "topk":
                tab_s, tab_i = pk["tab_s"], pk["tab_i"]
            else:
                tab_s, tab_i = full_tables(score)
            if in_mesh and not elastic:
                tab_i = tab_i + off
        else:
            tab_s, tab_i = no_tab_s, no_tab_i
        if in_mesh and not elastic:
            # window keys leave the shard with GLOBAL node ids
            top_idx = top_idx + off

        if use_sl:
            # rebuild the carried shortlist from this extraction (node-
            # ascending, so commit positions resolve by bisection); the
            # cutoff key freezes the best possible outsider for the era
            sl_i = torch.sort(ext_i, dim=1).values
            sl_l = sl_i.to(i64)
            if has_spread:
                bidx = sl_l.expand(S, Gp, C)
                vn = torch.gather(sp_vnode, 2, bidx)
                de = torch.gather(sp_des, 2, bidx)
            else:
                vn, de = SL.vn, SL.de
            SL = _SLState(
                idx=sl_i, feas=torch.gather(feas, 1, sl_l),
                pen=torch.gather(penalty, 1, sl_l),
                aff=torch.gather(aff_score, 1, sl_l), vn=vn, de=de,
                coll=torch.gather(coll, 1, sl_l),
                # the cutoff's tie-break key: the GLOBAL id under the
                # elastic remap (its extraction order), else the local
                # slot (the block map is monotonic)
                cut_s=ext_s[:, NE - 1],
                cut_i=(ext_g if elastic else ext_i)[:, NE - 1],
                comp=(n_feas_g - n_exh_g) <= C,
                nfeas=n_feas_g, nexh=n_exh_g, ndim=dim_exh_g,
                win_s=top_score, win_i=top_idx, tb_s=tab_s, tb_i=tab_i,
                gany=grp_any, ok=False)
        return (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
                dim_exh_g, grp_any, SL)

    def rerank(sl, used_pre, dev_used_pre, used, dev_used, sp_used,
               n_exh_g, dim_exh_g, act_next_g):
        """Fresh re-rank of the shortlist against post-commit state, the
        cutoff audit (TR3) and the incremental counters."""
        _, _, exh_pre, dim_pre = _sl_eval(sl, used_pre, dev_used_pre,
                                          sp_used)
        f_score, f_place, exh_post, dim_post = _sl_eval(sl, used, dev_used,
                                                        sp_used)
        # only shortlist nodes changed (TR1-guarded), so the full-N
        # counters advance by the shortlist delta
        d_exh = (exh_post.to(i32) - exh_pre.to(i32)).sum(dim=1)
        d_dim = (dim_post.to(i32) - dim_pre.to(i32)).sum(dim=1)
        nexh_next = (n_exh_g + d_exh).to(i32)
        ndim_next = (dim_exh_g + d_dim).to(i32)
        # the lex tie-break key: GLOBAL ids under the elastic remap (as
        # the building extraction and cut_i), local slots otherwise
        sl_key = _l2g(sl.idx).to(i32) if elastic else sl.idx
        w_s, w_i = _lex_topk(f_score, sl_key, TKl)
        # TR3: the re-ranked TKl-th key must still dominate the era cutoff
        ls, li = w_s[:, TKl - 1], w_i[:, TKl - 1]
        tr3_g = (ls > sl.cut_s) | ((ls == sl.cut_s) & (li <= sl.cut_i))
        if want_tables:
            vnode0 = sl.vn[0]
            tabs_s, tabs_i = [], []
            for v in range(Vs + 1):
                vmask = (vnode0 == v) if v < Vs else (vnode0 < 0)
                ts, ti = _lex_topk(torch.where(vmask, f_score, NEG_INF),
                                   sl_key, TW)
                tabs_s.append(ts)
                tabs_i.append(ti)
            tab_s = torch.stack(tabs_s, dim=1)
            tab_i = torch.stack(tabs_i, dim=1)
            if in_mesh and not elastic:
                tab_i = tab_i + off
        else:
            tab_s, tab_i = no_tab_s, no_tab_i
        gany_next = torch.where(sl.comp, f_place.any(dim=1), True)
        ok_next_t = ((tr3_g | sl.comp) | ~act_next_g).all()
        with rg.sync():
            ok_next = bool(ok_next_t)
        if in_mesh and not elastic:
            w_i = w_i + off
        return (w_s, w_i, tab_s, tab_i, nexh_next, ndim_next, gany_next,
                ok_next)

    # ---------- wave loop ----------
    used, dev_used, sp_used = used0, dev_used0, sp_used0
    done = torch.zeros(K, dtype=torch.bool, device=device)
    out_idx = torch.zeros((K, TOP_K), dtype=i32, device=device)
    out_ok = torch.zeros((K, TOP_K), dtype=torch.bool, device=device)
    out_score = torch.full((K, TOP_K), NEG_INF, dtype=f32, device=device)
    out_nfeas = torch.zeros(K, dtype=i32, device=device)
    out_nexh = torch.zeros(K, dtype=i32, device=device)
    out_dimexh = torch.zeros((K, R), dtype=i32, device=device)
    in_batch = ks < n_place
    if has_preempt:
        EVT = torch.zeros((Np, EV), dtype=torch.bool, device=device)
        out_evict = torch.zeros((K, EV), dtype=torch.bool, device=device)
        out_wave = torch.full((K,), -1, dtype=i32, device=device)
    wave = 0
    n_resc = 0
    offs_k = torch.arange(TOP_K, device=device)
    for _ in range(max_waves):
        active = ~done & in_batch
        active_any_t = active.any()
        with rg.sync():
            go = bool(active_any_t)
        if not go:
            break
        used_pre, dev_used_pre = used, dev_used

        take_carried = (yield ("carried", SL.ok)) if use_sl else False
        rg.step(take_carried)
        if take_carried:
            # shortlist wave: window and counters were pre-computed at
            # the end of the previous wave — no [Gp, Np] plane is read
            (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
             dim_exh_g, grp_any) = (SL.win_s, SL.win_i, SL.tb_s, SL.tb_i,
                                    SL.nfeas, SL.nexh, SL.ndim, SL.gany)
        else:
            (top_score, top_idx, tab_s, tab_i, n_feas_g, n_exh_g,
             dim_exh_g, grp_any, SL) = full_wave(
                 SL, used, dev_used, sp_used, done, out_idx, out_ok)
            n_resc += 1

        # ---- cross-shard candidate-key merge (mesh mode): each shard's
        # window keys (and value-table keys) merge into the exact top-TK
        # of the whole node axis; the counters sum over the mesh ----
        if in_mesh:
            top_score, top_idx = yield ("merge", top_score, top_idx, TK)
            if want_tables:
                tab_s, tab_i = yield ("merge", tab_s, tab_i, TKv)
            n_feas_out = yield ("psum", n_feas_g)
            n_exh_out = yield ("psum", n_exh_g)
            dim_exh_out = yield ("psum", dim_exh_g)
            grp_any = (yield ("psum", grp_any.to(i32))) > 0
        else:
            n_feas_out, n_exh_out, dim_exh_out = n_feas_g, n_exh_g, dim_exh_g

        # spread-aware candidate interleaving (slot 0): slot j of the
        # window draws from value class j mod (V+1), classes visited in
        # each group's preference order; holes compact to the tail
        if want_tables:
            has0 = sp_col[:, 0] >= 0                       # [Gp]
            vord = torch.argsort(0.0 - tab_s[:, :, 0], dim=1, stable=True)
            j = torch.arange(TK, device=device)
            vj = vord[:, j % (Vs + 1)]                     # [Gp, TK]
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
                      & active[None, :]).to(i32)            # [Gp, K]
        act_g = grp_onehot.sum(dim=1)
        rank = (torch.cumsum(grp_onehot, dim=1) - grp_onehot)[g_idx, ks]
        n_cand = (top_score > NEG_INF / 2).sum(dim=1)
        M = torch.clamp(torch.clamp(n_cand, max=W), 1, W)
        if seed == 0 or stack_commit:
            g_off = torch.zeros(Gp, dtype=i64, device=device)
        else:
            with rg.sync():
                g_seed = torch.tensor(seed & _U32, device=device)
            g_hash = _mul32(gs, 2654435761) ^ _mul32(g_seed, 2246822519)
            g_off = (g_hash >> 8) % W
        rot = 0 if seed == 0 else wave
        if stack_commit:
            cr = torch.zeros_like(rank)
        else:
            cr = (rank + g_off[g_idx] + rot) % M[g_idx]
        cand = top_idx[g_idx, cr].to(i64)                  # [K]
        cand_score = top_score[g_idx, cr]
        cand_ok = active & (cand_score > NEG_INF / 2)
        fail_now = active & ~grp_any[g_idx]

        # -- same-wave conflict checks over shared nodes --
        if K <= 2048 and not _FORCE_SORT_CONFLICTS:
            earlier = ks[None, :] < ks[:, None]            # [K, K]
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
        else:
            def _seg(key, ok):
                """Stable sort of `ok` members by key: per-element
                exclusive segment rank and a segmented exclusive-prefix
                summer (the reference's two-key (key, index) sort)."""
                keyc = torch.where(ok, key, 0x7FFFFFF0)
                s_key, s_ix = torch.sort(keyc, stable=True)
                is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                                 device=device),
                                      s_key[1:] != s_key[:-1]])
                start_pos = torch.cummax(torch.where(is_start, ks, 0),
                                         dim=0).values

                def summer(vals):
                    v = vals[s_ix]
                    cum = torch.cumsum(v, dim=0) - v       # exclusive
                    return torch.zeros_like(vals).index_put(
                        (s_ix,), cum - cum[start_pos])

                rank_s = torch.zeros(K, dtype=i64, device=device).index_put(
                    (s_ix,), ks - start_pos)
                return rank_s, summer

            _, prior_sum_node = _seg(cand, cand_ok)

            def prior_rank_any(key, m):
                rank_s, _ = _seg(key, m)
                return torch.where(m, rank_s, 0)

            def prior_rank(key, member):
                keyc = torch.where(member, key, 0x3FFFFFF0)
                rank_s, _ = _seg(keyc, cand_ok)
                return torch.where(member, rank_s, 0)

        ask_k = ask_res[g_idx]
        prior = prior_sum_node(ask_k * cand_ok[:, None])   # [K, R]
        if in_mesh:
            # each shard checks the fit of the candidates it owns; the
            # K-sized votes sum over the mesh (the [Np, R] planes stay)
            inb, loc, locc = _g2l(cand)
            fits_l = ((used[locc] + prior + ask_k)
                      <= avail[locc]).all(dim=-1) & inb
            fits = (yield ("psum", fits_l.to(i32))) > 0
        else:
            loc = cand
            fits = ((used[cand] + prior + ask_k) <= avail[cand]).all(dim=-1)
        if has_devices:
            dev_k = dev_ask[g_idx]
            prior_dev = prior_sum_node(dev_k * cand_ok[:, None])
            if in_mesh:
                dev_fits_l = ((dev_used[locc] + prior_dev + dev_k)
                              <= dev_cap[locc]).all(dim=-1) & inb
                dev_fits = (yield ("psum", dev_fits_l.to(i32))) > 0
            else:
                dev_fits = ((dev_used[cand] + prior_dev + dev_k)
                            <= dev_cap[cand]).all(dim=-1)
        else:
            dev_fits = torch.ones(K, dtype=torch.bool, device=device)
        if in_mesh and has_spread:
            # one [K, A] sum of the candidates' attribute rows serves the
            # spread quota and the commit below
            ar_cand = (yield ("psum", torch.where(
                inb[:, None], attr_rank[locc].to(i32), 0))).to(i64)

        # distinct_hosts: one commit per (node, distinct group) per wave
        if has_distinct:
            dg = distinct[g_idx].to(i64)
            dg_ok = prior_rank(cand * Gp + dg.clamp(min=0), dg >= 0) == 0
        else:
            dg_ok = torch.ones(K, dtype=torch.bool, device=device)

        # spread quota per (group, slot, value) for this wave
        sp_ok = torch.ones(K, dtype=torch.bool, device=device)
        for s in (range(S) if has_spread else range(0)):
            cols = sp_col[g_idx, s].to(i64)
            if in_mesh:
                vs = torch.gather(ar_cand, 1, cols.clamp(min=0)[:, None])[:, 0]
            else:
                vs = attr_rank_l[cand, cols.clamp(min=0)]
            has_s = (cols >= 0) & (vs >= 0)
            # non-members read some in-range slot (the reference's
            # clamped gather); members' ranks are < V by construction
            vsc = vs.clamp(0, V - 1)
            des_s = sp_desired[:, s]                       # [Gp, V]
            use_s = sp_used[:, s]
            des_eff = torch.where(des_s < 0, sp_implicit[:, s][:, None],
                                  des_s)
            present = use_s > 0
            maxc_q = torch.where(present, use_s, 0.0).amax(dim=1)[:, None]
            minc_q = torch.where(
                present, use_s,
                torch.where(present.any(dim=1)[:, None], float("inf"),
                            0.0)).amin(dim=1)[:, None]
            minc_q = torch.where(torch.isfinite(minc_q), minc_q, 0.0)
            # even spread: values may grow to a common level for the
            # first half of the wave budget, unbounded after it
            share = torch.ceil(act_g.to(f32) / V)[:, None]
            level = torch.maximum(maxc_q, minc_q + share)
            if wave < max(max_waves // 2, 1):
                even_q = torch.clamp(level - use_s, min=1.0)
            else:
                even_q = torch.full_like(use_s, float("inf"))
            quota = torch.where(sp_targeted[:, s][:, None],
                                torch.clamp(des_eff - use_s, min=1.0),
                                even_q)                    # [Gp, V]
            gv_key = (g_idx * V + vsc) * 2 + 1
            gv_rank = prior_rank(gv_key, has_s).to(f32)
            sp_ok = sp_ok & (~has_s | (gv_rank < quota[g_idx, vsc]))

        commit = cand_ok & fits & dev_fits & dg_ok & sp_ok
        cm = commit[:, None]

        # -- apply this wave's commits (duplicate nodes accumulate; in
        # mesh mode each shard adds only the rows it owns) --
        if in_mesh:
            used = _add_drop(used, (loc,), ask_k * cm)
            if has_devices:
                dev_used = _add_drop(dev_used, (loc,), dev_ask[g_idx] * cm)
        else:
            used = used.index_put((cand,), ask_k * cm, accumulate=True)
            if has_devices:
                dev_used = dev_used.index_put((cand,), dev_ask[g_idx] * cm,
                                              accumulate=True)
        if has_spread:
            scol = sp_col[g_idx].to(i64)                   # [K, S]
            if in_mesh:
                svals = torch.gather(ar_cand, 1, scol.clamp(min=0))
            else:
                svals = attr_rank_l[cand[:, None], scol.clamp(min=0)]
            okslot = (scol >= 0) & (svals >= 0) & cm
            # rows without a spread slot add 0 at an in-range position
            # (the reference's scatter drops them)
            sp_used = sp_used.index_put(
                (g_idx[:, None], torch.arange(S, device=device)[None, :],
                 svals.clamp(0, V - 1)), okslot.to(f32), accumulate=True)

        # -- eviction pass: after the normal commits, against post-commit
        # usage, for placements whose group has nothing placeable --
        if has_preempt:
            want = active & ~commit & ~grp_any[g_idx]
            want_g = torch.zeros(Gp, dtype=i32, device=device).index_add(
                0, g_idx, want.to(i32)) > 0
            want_any_t = want.any()
            with rg.sync():
                any_want = bool(want_any_t)
            if any_want:
                nv_s, nv_i, sel_freed, sel_mask = evict_pass(
                    used, EVT, want_g, ask_res=ask_res, avail=avail,
                    reserved=reserved, feas=feas, ev_slot_ok=ev_slot_ok,
                    ev_res=ev_res_f, ev_prio=ev_prio_i,
                    dev=(dev_used, dev_cap, dev_ask) if has_devices
                    else None, ids=g_of_local if in_mesh else None,
                    syncs=rg)
            else:
                nv_s = torch.full((Gp,), NEG_INF, dtype=f32, device=device)
                nv_i = torch.zeros(Gp, dtype=i64, device=device)
                sel_freed = torch.zeros((Gp, R), dtype=f32, device=device)
                sel_mask = torch.zeros((Gp, EV), dtype=torch.bool,
                                       device=device)
            if in_mesh:
                # each group's best eviction key (score, global id) from
                # every shard; the owner holds its victim set
                win_s, win_i = yield ("merge", nv_s[:, None],
                                      nv_i[:, None], 1)
                win_s, win_i = win_s[:, 0], win_i[:, 0]
            else:
                win_s, win_i = nv_s, nv_i
            ev_any_g = win_s > NEG_INF / 2
            e_cand = win_i[g_idx]                          # [K] global
            p_ok = want & ev_any_g[g_idx]
            # one eviction commit per node per wave, across groups: two
            # victim sets chosen apart must never both apply to one node
            ev_commit = p_ok & (prior_rank_any(e_cand, p_ok) == 0)
            ecm = ev_commit[:, None]
            ev_val = (ask_res[g_idx] - sel_freed[g_idx]) * ecm
            if in_mesh:
                e_inb, e_loc, e_locc = _g2l(e_cand)
                own = (e_inb & ev_commit)[:, None]
                # victims leave and the placement lands in one add
                used = _add_drop(used, (e_loc,), ev_val)
                if has_devices:
                    dev_used = _add_drop(dev_used, (e_loc,),
                                         dev_ask[g_idx] * ecm)
                em_l = sel_mask[g_idx] & own               # [K, EV]
                EVT = EVT | (_add_drop(
                    torch.zeros((Np, EV), dtype=i32, device=device),
                    (e_loc,), em_l.to(i32)) > 0)
                em = (yield ("psum", em_l.to(i32))) > 0
            else:
                used = used.index_put((e_cand,), ev_val, accumulate=True)
                if has_devices:
                    dev_used = dev_used.index_put(
                        (e_cand,), dev_ask[g_idx] * ecm, accumulate=True)
                em = sel_mask[g_idx] & ecm                 # [K, EV]
                EVT = EVT | (torch.zeros((Np, EV), dtype=i32, device=device)
                             .index_put((e_cand,), em.to(i32),
                                        accumulate=True) > 0)
            if has_spread:
                scol = sp_col[g_idx].to(i64)
                if in_mesh:
                    ar_ev = (yield ("psum", torch.where(
                        own, attr_rank[e_locc].to(i32), 0))).to(i64)
                    evals_ = torch.gather(ar_ev, 1, scol.clamp(min=0))
                else:
                    evals_ = attr_rank_l[e_cand[:, None], scol.clamp(min=0)]
                ok_es = (scol >= 0) & (evals_ >= 0) & ecm
                sp_used = sp_used.index_put(
                    (g_idx[:, None], torch.arange(S, device=device)[None, :],
                     evals_.clamp(0, V - 1)), ok_es.to(f32),
                    accumulate=True)
            # a group with no placeable node and no eviction option
            # fails; one with an option keeps retrying
            fail_now = fail_now & ~ev_any_g[g_idx]
        else:
            ev_commit = torch.zeros(K, dtype=torch.bool, device=device)

        # -- record results: a committed placement's fall-through top-K
        # is its group's candidate list starting at its own rank --
        offs = cr[:, None] + offs_k[None, :]               # < TK
        pk_idx = top_idx[g_idx[:, None], offs]
        pk_score = top_score[g_idx[:, None], offs]
        ok_row = (pk_score > NEG_INF / 2) & cm
        if has_preempt:
            # an eviction commit records its one node in slot 0 (the
            # victim set is node-specific: no fall-through) with the
            # post-eviction bin-pack score
            ecol = (offs_k == 0)[None, :]
            pk_idx = torch.where(ecm, torch.where(
                ecol, e_cand[:, None].to(i32), 0), pk_idx)
            pk_score = torch.where(ecm, torch.where(
                ecol, win_s[g_idx][:, None], NEG_INF), pk_score)
            ok_row = torch.where(ecm, ecol, ok_row)
        newly = commit | ev_commit | fail_now
        upd = newly[:, None]
        out_idx = torch.where(upd, pk_idx, out_idx)
        out_score = torch.where(upd, pk_score, out_score)
        out_ok = torch.where(upd, ok_row, out_ok)
        if has_preempt:
            out_evict = torch.where(upd, em & ecm, out_evict)
            out_wave = torch.where(commit | ev_commit, wave, out_wave)
        out_nfeas = torch.where(newly, n_feas_out[g_idx], out_nfeas)
        out_nexh = torch.where(newly, n_exh_out[g_idx], out_nexh)
        out_dimexh = torch.where(upd, dim_exh_out[g_idx], out_dimexh)
        done = done | newly

        if use_sl:
            # ---- end-of-wave shortlist maintenance: decide whether the
            # next wave may read the carried window ----
            active_next = active & ~newly
            act_next_g = torch.zeros(Gp, dtype=i32, device=device).index_add(
                0, g_idx, active_next.to(i32)) > 0
            next_any_t = active_next.any()
            with rg.sync():
                any_next = bool(next_any_t)
            cf = commit.to(f32)
            # TR1: every commit this wave landed inside the group's
            # shortlist (otherwise an outsider's score moved)
            # (in mesh mode only commits to this shard's nodes move its
            # scores: owned commits against the local shortlist)
            if in_mesh:
                tot = (cf * inb.to(f32)).sum()
                mark = _add_drop(torch.zeros(Np, dtype=f32, device=device),
                                 (loc,), cf)
            else:
                tot = cf.sum()
                mark = torch.zeros(Np, dtype=f32, device=device).index_put(
                    (cand,), cf, accumulate=True)
            tr1_g = mark[SL.idx.to(i64)].sum(dim=1) == tot
            g_committed = torch.zeros(Gp, dtype=f32, device=device
                                      ).index_add(0, g_idx, cf) > 0
            if has_spread:
                has_sp_g = (sp_col >= 0).any(dim=1)
            else:
                has_sp_g = torch.zeros(Gp, dtype=torch.bool, device=device)
            # spread groups shift all their node scores when they commit;
            # interleaved groups additionally need a complete shortlist
            sp_gate = has_sp_g & g_committed
            if want_tables:
                sp_gate = sp_gate | (sp_col[:, 0] >= 0)
            ok_pre_g = SL.comp | (tr1_g & ~sp_gate)
            pre_ok = False
            if any_next:
                pre_ok_t = (ok_pre_g | ~act_next_g).all()
                with rg.sync():
                    pre_ok = bool(pre_ok_t)
            if has_preempt and pre_ok:
                # an eviction lowers usage, which voids the monotone-
                # usage argument behind the carried window: any eviction
                # commit sends the next wave to a full rescore
                ev_any_t = ev_commit.any()
                with rg.sync():
                    pre_ok = not bool(ev_any_t)

            # own-group commit counts fold into the carried coll; window
            # entries outside the shortlist land in a dropped column
            sl_idx = SL.idx.to(i64)
            tloc = _g2l(top_idx)[1] if in_mesh else top_idx.to(i64)
            win_pos = torch.searchsorted(sl_idx, tloc)
            pos_hit = torch.gather(sl_idx, 1,
                                   win_pos.clamp(max=C - 1)) == tloc
            win_pos = torch.where(pos_hit, win_pos, C)
            cand_pos = win_pos[g_idx, cr]
            coll_pad = torch.cat([SL.coll, torch.zeros(
                (Gp, 1), dtype=f32, device=device)], dim=1)
            coll_pad = coll_pad.index_put((g_idx, cand_pos), cf,
                                          accumulate=True)
            SL = SL._replace(coll=coll_pad[:, :C])

            # under lock-step a lane may rerank on a void premise: its
            # `ok` stays False and the next wave's full pass rebuilds
            # the window before anything reads it
            if (yield ("rerank", pre_ok)):
                (nw_s, nw_i, ntb_s, ntb_i, n_nexh, n_ndim, n_gany,
                 sl_ok) = rerank(SL, used_pre, dev_used_pre, used, dev_used,
                                 sp_used, n_exh_g, dim_exh_g, act_next_g)
            else:
                nw_s = torch.full((Gp, TKl), NEG_INF, dtype=f32,
                                  device=device)
                nw_i = torch.zeros((Gp, TKl), dtype=i32, device=device)
                ntb_s = torch.full(SL.tb_s.shape, NEG_INF, dtype=f32,
                                   device=device)
                ntb_i = torch.zeros(SL.tb_i.shape, dtype=i32,
                                    device=device)
                n_nexh, n_ndim = SL.nexh, SL.ndim
                n_gany = torch.zeros(Gp, dtype=torch.bool, device=device)
                sl_ok = False
            SL = SL._replace(win_s=nw_s, win_i=nw_i.to(i32), tb_s=ntb_s,
                             tb_i=ntb_i.to(i32), nfeas=n_feas_g,
                             nexh=n_nexh, ndim=n_ndim, gany=n_gany,
                             ok=pre_ok and sl_ok)
        wave += 1
    rg.close()

    unfinished = ~done & in_batch
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
    return SolveResult(choice=out_idx, choice_ok=out_ok, score=out_score,
                       n_feasible=out_nfeas, n_exhausted=out_nexh,
                       dim_exhausted=out_dimexh, feas=feas,
                       cons_filtered=cons_filtered, used_final=used,
                       dev_used_final=dev_used, n_waves=wave,
                       unfinished=unfinished,
                       n_rescore=n_resc if (use_sl or in_mesh) else wave,
                       evict=out_evict if has_preempt else None,
                       commit_wave=out_wave if has_preempt else None,
                       n_syncs=rg.syncs)
