"""The scoring spec, driven through torch ops and through numpy.

The counterpart of `nomad_tpu.solver.score_spec`: one term function per
scoring term, holding its exact float-op sequence and constants, and
`evaluate_wave`, the term loop the spec-driven backends call once per
wave.  Two backends drive it through an ops shim:

  * `TorchOps`, the torch wave scorer (`kernel.solve_steps`), the
    counterpart of the reference's `JaxOps`: f32 throughout, select-sum
    spread lookups for value vocabularies up to `select_sum_max_v`
    (gather above), unpinned masked min/max;
  * `NumpyOps`, the host twin (`host.host_solve_kernel`), the
    reference's own numpy shim: constants wrapped `np.float32`, gather
    spread lookups, masked min/max pinned finite, a Python seed branch.

The optional `learned` and `region` planes ([Gp, Np], precomputed
outside the solve) flow to these driven backends only; the hand-written
ones (the CUDA wave kernel, the shortlist twin, the native C++ engine)
do not implement them, so a solve handed a plane runs the driven scorer
(`TERMS` lists which backend carries which term).  With no plane the
combine path is byte-identical to a spec without the terms.
"""
from __future__ import annotations

import numpy as np
import torch

from .tensorize import R_CPU, R_MEM

#: the reference spec's version (`nomad_tpu.solver.score_spec`); the
#: term bodies and combine order here are that version's
SPEC_VERSION = "3.1"

#: masked / sentinel score (shared by every backend)
NEG_INF = -1e30

#: seeded-mode score quantum: seed != 0 bins scores into SCORE_BIN
#: steps and jitters within the bin (see kernel.solve_kernel)
SCORE_BIN = 0.05


class NumpyOps:
    """Backend shim for the numpy host twin: constants wrapped
    `np.float32`, gather-based spread `cur`, masked min/max pinned
    finite (the same results as the unpinned form, without
    RuntimeWarnings), and a Python-level seed branch.  Call signatures
    are `TorchOps`'s; `device` is ignored."""

    f32 = np.float32

    @staticmethod
    def asf32(x):
        return np.asarray(x, np.float32)

    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    clip = staticmethod(np.clip)
    floor = staticmethod(np.floor)

    @staticmethod
    def ones_bool(shape, device=None):
        return np.ones(shape, bool)

    @staticmethod
    def counts_cast(x):
        # the host pins the scorer count to f32 explicitly
        return x.astype(np.float32)

    @staticmethod
    def seed_select(seed, exact, binned):
        return binned if seed != 0 else exact

    @staticmethod
    def spread_cur(used_vec, v, V):
        f32 = np.float32
        return np.where(v >= 0, np.take_along_axis(
            used_vec, np.clip(v, 0, V - 1), axis=1), f32(0.0))

    @staticmethod
    def present_minmax(present, used_vec):
        f32 = np.float32
        any_present = present.any(axis=1)[:, None]
        minc = np.min(np.where(present, used_vec, np.inf),
                      axis=1)[:, None].astype(f32)
        maxc = np.max(np.where(present, used_vec, -np.inf),
                      axis=1)[:, None].astype(f32)
        # rows with no present value carry minc=inf / maxc=-inf; their
        # `even` term is masked to 0 by any_present downstream, but
        # inf/inf through the divides warns: pin them finite first
        minc = np.where(any_present, minc, f32(0.0))
        maxc = np.where(any_present, maxc, f32(0.0))
        return any_present, minc, maxc

    @staticmethod
    def spread_sum(S, fn, shape, device=None):
        # sequential accumulation, bitwise equal to the torch scorer's
        acc = np.zeros(shape, np.float32)
        for s in range(S):
            acc = acc + fn(s)
        return acc


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
    fit = fit_dims.all(-1)
    if ctx["has_devices"]:
        dev_fit = (ctx["dev_used"][None, :, :] + ctx["dev_ask"][:, None, :]
                   <= ctx["dev_cap"][None, :, :]).all(-1)
    else:
        dev_fit = ops.ones_bool(ctx["shape"], device=_device(after))
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


def term_learned(ops, ctx):
    """The learned-head slot: a [Gp, Np] score plane PRECOMPUTED outside
    the solve (model inference is not part of it), appended as one more
    scorer by `combine_learned`.  With no plane the term is statically
    absent."""
    learned = ctx["learned"]
    return learned


def term_region(ops, ctx):
    """Cross-region placement affinity: a [Gp, Np] plane PRECOMPUTED
    from each node's region and the asking job's home region (home >
    sibling > remote), appended as one more scorer by `combine_region`.
    With no plane the term is statically absent (appending an all-zeros
    plane would still flip -0.0 to +0.0)."""
    region_bias = ctx["region_bias"]
    return region_bias


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


def combine_learned(ops, ctx, parts):
    """`combine` with the learned plane appended as one more scorer,
    counted where nonzero like anti / pen / aff / spread.  A separate
    function so `combine` stays what the plane-free hand backends
    implement."""
    f32 = ops.f32
    learned = parts["learned"]
    n_scorers = ops.counts_cast(f32(1.0) + parts["anti_counts"]
                                + parts["pen_counts"]
                                + parts["aff_counts"]
                                + parts["spread_counts"]
                                + (learned != 0.0))
    total = (parts["binpack"] + parts["anti"] + parts["pen_score"]
             + parts["aff_score"] + parts["spread_total"]
             + learned) / n_scorers
    total = ops.seed_select(ctx["seed"], total,
                            ops.floor(total / f32(SCORE_BIN))
                            * f32(SCORE_BIN))
    total = total + ctx["jitter"]
    return total


def combine_region(ops, ctx, parts):
    """`combine` with the region plane appended as one more scorer,
    counted where nonzero."""
    f32 = ops.f32
    region_bias = parts["region"]
    n_scorers = ops.counts_cast(f32(1.0) + parts["anti_counts"]
                                + parts["pen_counts"]
                                + parts["aff_counts"]
                                + parts["spread_counts"]
                                + (region_bias != 0.0))
    total = (parts["binpack"] + parts["anti"] + parts["pen_score"]
             + parts["aff_score"] + parts["spread_total"]
             + region_bias) / n_scorers
    total = ops.seed_select(ctx["seed"], total,
                            ops.floor(total / f32(SCORE_BIN))
                            * f32(SCORE_BIN))
    total = total + ctx["jitter"]
    return total


def combine_learned_region(ops, ctx, parts):
    """Both optional planes at once: learned and region each append as
    one more scorer."""
    f32 = ops.f32
    learned = parts["learned"]
    region_bias = parts["region"]
    n_scorers = ops.counts_cast(f32(1.0) + parts["anti_counts"]
                                + parts["pen_counts"]
                                + parts["aff_counts"]
                                + parts["spread_counts"]
                                + (learned != 0.0)
                                + (region_bias != 0.0))
    total = (parts["binpack"] + parts["anti"] + parts["pen_score"]
             + parts["aff_score"] + parts["spread_total"]
             + learned + region_bias) / n_scorers
    total = ops.seed_select(ctx["seed"], total,
                            ops.floor(total / f32(SCORE_BIN))
                            * f32(SCORE_BIN))
    total = total + ctx["jitter"]
    return total


# ====================================================== term registry
#: One entry per scoring term, the reference's registry: its fingerprint
#: groups (group name -> the assignment-target aliases backends may
#: use), the function that carries its float ops, and the backends that
#: implement it.  "host" (the numpy twin) and "kernel" (the torch wave
#: scorer) are spec-driven; "shortlist", "pallas" (the fused wave kernel,
#: CUDA in this package) and "native" (the C++ engine) are hand-written.
#: A pure literal.
TERMS = (
    {"name": "feasibility", "fn": "term_feasibility",
     "groups": {}, "const_set": False,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "hard placement masks (no float ops; not fingerprinted)"},
    {"name": "binpack", "fn": "term_binpack",
     "groups": {"free": ("free_cpu", "free_mem"),
                "binpack": ("raw", "binpack")},
     "const_set": False,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "exponential cpu+mem bin-packing pressure"},
    {"name": "anti", "fn": "term_anti",
     "groups": {"anti": ("anti",)}, "const_set": False,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "job anti-affinity collision penalty"},
    {"name": "pen", "fn": "term_penalty",
     "groups": {"pen": ("pen", "pen_score", "pen_sc")},
     "const_set": False,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "flat node penalty scorer"},
    {"name": "spread", "fn": "term_spread",
     "groups": {"spread": ("cur", "boost", "targeted", "delta_boost",
                           "even", "contrib", "spread_total",
                           "sp_total", "minc", "maxc", "desired")},
     "const_set": True,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "targeted + even spread boosts (const-set compare)"},
    {"name": "learned", "fn": "term_learned",
     "groups": {"learned": ("learned",)}, "const_set": False,
     "backends": ("host", "kernel"),
     "doc": "reserved learned-head plane (driven backends only)"},
    {"name": "region", "fn": "term_region",
     "groups": {"region": ("region_bias",)}, "const_set": False,
     "backends": ("host", "kernel"),
     "doc": "cross-region placement affinity plane (driven backends "
            "only)"},
    {"name": "combine", "fn": "combine",
     "groups": {"n_scorers": ("n_scorers",), "total": ("total",)},
     "const_set": False,
     "backends": ("host", "kernel", "shortlist", "pallas", "native"),
     "doc": "append-then-average normalization + binning + jitter"},
)


def term_names():
    """Ordered term names."""
    return tuple(t["name"] for t in TERMS)


def _device(x):
    # numpy arrays before numpy 2.0 have no `.device`; NumpyOps ignores it
    return getattr(x, "device", None)


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
    `nomad_tpu.solver.score_spec.evaluate_wave`, the optional `learned` /
    `region_bias` planes included (None: the term is statically
    absent)."""
    f32 = ops.f32
    after, fit_dims, fit, dev_fit, feas_b, placeable = \
        term_feasibility(ops, ctx)

    binpack = rescore_binpack(ops, after, ctx["avail"], ctx["reserved"])
    anti, anti_counts = term_anti(ops, ctx)

    if ctx["has_spread"]:
        spread_total = ops.spread_sum(
            ctx["S"], lambda s: term_spread(ops, ctx, s), ctx["shape"],
            device=_device(after))
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
    # a static pick: with no plane the combine (and its float behavior)
    # is byte-identical to a spec without the term, where an all-zeros
    # plane would still flip -0.0 sums to +0.0
    has_learned = ctx.get("learned") is not None
    has_region = ctx.get("region_bias") is not None
    if has_learned:
        parts["learned"] = term_learned(ops, ctx)
    if has_region:
        parts["region"] = term_region(ops, ctx)
    if has_learned and has_region:
        total = combine_learned_region(ops, ctx, parts)
    elif has_learned:
        total = combine_learned(ops, ctx, parts)
    elif has_region:
        total = combine_region(ops, ctx, parts)
    else:
        total = combine(ops, ctx, parts)
    score = ops.where(placeable, total, f32(NEG_INF))
    return score, placeable, feas_b, fit, fit_dims, dev_fit
