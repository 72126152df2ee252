"""The scoring spec, driven through torch ops.

The counterpart of `nomad_tpu.solver.score_spec`: one term function per
scoring term, holding its exact float-op sequence and constants, and
`evaluate_wave`, the term loop the wave scorer calls.  `TorchOps` is the
torch counterpart of the reference's `JaxOps` shim and keeps its float-op
sequence: f32 throughout, select-sum spread lookups for value
vocabularies up to `select_sum_max_v` (gather above), unpinned masked
min/max.  The reference's `learned` and `region` planes are not part of
this package.
"""
from __future__ import annotations

import torch

from .tensorize import R_CPU, R_MEM

#: masked / sentinel score (shared by every backend)
NEG_INF = -1e30

#: seeded-mode score quantum: seed != 0 bins scores into SCORE_BIN
#: steps and jitters within the bin (see kernel.solve_kernel)
SCORE_BIN = 0.05


class TorchOps:
    """Backend shim for the torch wave scorer.  Python float constants
    combine with float32 tensors in float32 (torch, like JAX, treats a
    Python scalar as weakly typed), so every term stays f32."""

    def __init__(self, select_sum_max_v: int = 16):
        self.select_sum_max_v = select_sum_max_v

    @staticmethod
    def f32(c):
        return c

    @staticmethod
    def asf32(x):
        return x

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def maximum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def floor(x):
        return torch.floor(x)

    @staticmethod
    def ones_bool(shape, device=None):
        return torch.ones(shape, dtype=torch.bool, device=device)

    @staticmethod
    def counts_cast(x):
        return x

    @staticmethod
    def seed_select(seed, exact, binned):
        # seed is a host int in the port: the branch is decided here
        return binned if seed != 0 else exact

    def spread_cur(self, used_vec, v, V):
        if V <= self.select_sum_max_v:
            # select-sum over the (small) value vocabulary, the reference
            # kernel's gather-free form
            cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for val in range(V):
                cur = cur + torch.where(v == val, used_vec[:, val][:, None],
                                        0.0)
            return cur
        return torch.where(v >= 0, torch.gather(
            used_vec, 1, torch.clamp(v, min=0).long()), 0.0)

    @staticmethod
    def present_minmax(present, used_vec):
        any_present = present.any(dim=1)[:, None]
        inf = float("inf")
        minc = torch.where(present, used_vec, inf).amin(dim=1)[:, None]
        maxc = torch.where(present, used_vec, -inf).amax(dim=1)[:, None]
        return any_present, minc, maxc

    @staticmethod
    def spread_sum(S, fn, shape, device=None):
        acc = torch.zeros(shape, dtype=torch.float32, device=device)
        for s in range(S):
            acc = acc + fn(s)
        return acc


# ======================================================= term functions

def term_feasibility(ops, ctx):
    """Hard placement masks (funcs.go checkers): resource fit per
    dimension, device fit, static feasibility minus per-wave blocking."""
    after = ctx["used"][None, :, :] + ctx["ask_res"][:, None, :]
    fit_dims = after <= ctx["avail"][None, :, :]
    fit = fit_dims.all(dim=-1)
    if ctx["has_devices"]:
        dev_fit = (ctx["dev_used"][None, :, :] + ctx["dev_ask"][:, None, :]
                   <= ctx["dev_cap"][None, :, :]).all(dim=-1)
    else:
        dev_fit = ops.ones_bool(ctx["shape"], device=after.device)
    feas_b = ctx["feas"] & ~ctx["blocked"]
    placeable = feas_b & fit & dev_fit
    return after, fit_dims, fit, dev_fit, feas_b, placeable


def term_binpack(ops, ctx):
    """Bin-pack (funcs.go:155 ScoreFit, normalized rank.go:441): the
    10**free exponential pressure on cpu+mem, clipped to [0, 18] and
    normalized; 0 where either denominator is empty."""
    f32 = ops.f32
    free_cpu = f32(1.0) - ctx["util_cpu"] / ops.maximum(ctx["denom_cpu"],
                                                        f32(1.0))
    free_mem = f32(1.0) - ctx["util_mem"] / ops.maximum(ctx["denom_mem"],
                                                        f32(1.0))
    raw = f32(20.0) - (f32(10.0) ** free_cpu + f32(10.0) ** free_mem)
    binpack = ops.where(ctx["ok_denoms"],
                        ops.clip(raw, f32(0.0), f32(18.0)) / f32(18.0),
                        f32(0.0))
    return binpack


def term_anti(ops, ctx):
    """Job anti-affinity (rank.go:462): -(collisions+1)/desired on
    nodes already carrying a sibling, appended only when colliding."""
    f32 = ops.f32
    coll = ctx["coll"]
    anti = ops.where(coll > 0,
                     -(coll + f32(1.0)) / ctx["ask_desired"][:, None],
                     f32(0.0))
    anti_counts = coll > 0
    return anti, anti_counts


def term_penalty(ops, ctx):
    """Node penalty (rank.go:532): a flat -1 scorer on penalized nodes.
    Wave-invariant — evaluated once per solve via `static_terms`."""
    f32 = ops.f32
    pen_score = ops.where(ctx["penalty"], f32(-1.0), f32(0.0))
    return pen_score


def term_spread(ops, ctx, s):
    """Spread scorer for ONE spread constraint `s` (spread.go): targeted
    boost toward declared desired counts, or the even-spread boost
    against the min/max occupancy band."""
    f32 = ops.f32
    col = ctx["sp_col"][:, s]
    has = col >= 0
    v = ctx["vnode"][s]
    has_v = v >= 0
    used_vec = ctx["sp_used"][:, s]
    cur = ops.spread_cur(used_vec, v, ctx["V"])
    # targeted scoring (desired counts, +1 for this placement)
    desired = ctx["des"][s]
    boost = ((desired - (cur + f32(1.0)))
             / ops.maximum(desired, f32(1e-9))
             ) * ops.asf32(ctx["sp_weight"][:, s])[:, None]
    targeted = ops.where(~has_v, f32(-1.0),
                         ops.where(desired <= 0, f32(-1.0), boost))
    # even-spread scoring (spread.go evenSpreadScoreBoost)
    present = used_vec > 0
    any_present, minc, maxc = ops.present_minmax(present, used_vec)
    delta_boost = (minc - cur) / ops.maximum(minc, f32(1e-9))
    even = ops.where(cur != minc, delta_boost,
                     ops.where(minc == maxc, f32(-1.0),
                               (maxc - minc) / ops.maximum(minc,
                                                           f32(1e-9))))
    even = ops.where(~has_v, f32(-1.0), even)
    even = ops.where(any_present, even, f32(0.0))
    contrib = ops.where(ctx["sp_targeted"][:, s][:, None], targeted,
                        even)
    return ops.where(has[:, None], contrib, f32(0.0))


def combine(ops, ctx, parts):
    """Append-then-average normalization (rank.go:667): the mean over
    the appended scorers, seed-binned and tie-break-jittered."""
    f32 = ops.f32
    n_scorers = ops.counts_cast(f32(1.0) + parts["anti_counts"]
                                + parts["pen_counts"]
                                + parts["aff_counts"]
                                + parts["spread_counts"])
    total = (parts["binpack"] + parts["anti"] + parts["pen_score"]
             + parts["aff_score"] + parts["spread_total"]) / n_scorers
    total = ops.seed_select(ctx["seed"], total,
                            ops.floor(total / f32(SCORE_BIN))
                            * f32(SCORE_BIN))
    total = total + ctx["jitter"]
    return total


# ============================================================= drivers
def static_terms(ops, penalty):
    """Wave-invariant spec terms, evaluated once per solve:
    (pen_score, pen_counts)."""
    pen_score = term_penalty(ops, {"penalty": penalty})
    return pen_score, penalty


def rescore_binpack(ops, after, avail, reserved):
    """Bin-pack for a post-delta usage plane `after` [Gp, Np, R]."""
    denom_cpu = avail[None, :, R_CPU]
    denom_mem = avail[None, :, R_MEM]
    util_cpu = after[:, :, R_CPU] + reserved[None, :, R_CPU]
    util_mem = after[:, :, R_MEM] + reserved[None, :, R_MEM]
    ok_denoms = (denom_cpu > 0) & (denom_mem > 0)
    return term_binpack(ops, {"util_cpu": util_cpu, "util_mem": util_mem,
                              "denom_cpu": denom_cpu,
                              "denom_mem": denom_mem,
                              "ok_denoms": ok_denoms})


def evaluate_wave(ops, ctx):
    """The term loop the wave scorer calls once per wave: masks, every
    term, combine.  Returns (score, placeable, feas_b, fit, fit_dims,
    dev_fit), the reference's `group_scores` contract; ctx keys as in
    `nomad_tpu.solver.score_spec.evaluate_wave` (without the optional
    learned / region planes)."""
    f32 = ops.f32
    after, fit_dims, fit, dev_fit, feas_b, placeable = \
        term_feasibility(ops, ctx)

    binpack = rescore_binpack(ops, after, ctx["avail"], ctx["reserved"])
    anti, anti_counts = term_anti(ops, ctx)

    if ctx["has_spread"]:
        spread_total = ops.spread_sum(
            ctx["S"], lambda s: term_spread(ops, ctx, s), ctx["shape"],
            device=after.device)
        spread_counts = spread_total != 0.0
    else:
        spread_total = f32(0.0)
        spread_counts = False

    aff_score = ctx["aff_score"]
    parts = {"binpack": binpack, "anti": anti,
             "anti_counts": anti_counts,
             "pen_score": ctx["pen_score"],
             "pen_counts": ctx["pen_counts"],
             "aff_score": aff_score, "aff_counts": aff_score != 0.0,
             "spread_total": spread_total,
             "spread_counts": spread_counts}
    total = combine(ops, ctx, parts)
    score = ops.where(placeable, total, f32(NEG_INF))
    return score, placeable, feas_b, fit, fit_dims, dev_fit
