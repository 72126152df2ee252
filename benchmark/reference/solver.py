"""The plain NumPy wave solve the benchmark judges the port by.

A frozen copy of the placement semantics that `nomad_tpu_torch` states
for its solve (its numpy twin `solver/host.py` `host_solve_kernel` and
the scoring terms of `solver/score_spec.py`, at commit e7763fa), cut to
what the benchmark's configurations use: constraints, affinities,
spreads, anti-affinity, node penalties and the resource fit, without
the eviction pass and the learned and region planes.  It imports
nothing of the port: later changes to the port cannot move it.

The arithmetic is float32, as the configurations state.  With
`precision="bf16"` every score plane is rounded to bfloat16 before it is
ranked: the control that a lower-precision solve must fail.

Top-k here is exact and breaks ties by the lower node index (a stable
descending sort), as the port's is at every width.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TOP_K = 4
WAVE_K = 32
MAX_WAVES = 12
NEG_INF = np.float32(-1e30)
MERGED_GP_MAX = 16
MERGED_W_CAP = 1024
WIDE_W_CAP = 256
SCORE_BIN = 0.05
R_CPU, R_MEM = 0, 1

OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_IS_SET, OP_NOT_SET = range(1, 9)

STATUS_FAILED, STATUS_COMMITTED, STATUS_RETRY = 0, 1, 2

f32 = np.float32
u32 = np.uint32


class Result(NamedTuple):
    choice: np.ndarray      # [K] node index of the first choice
    ok: np.ndarray          # [K] the first choice is a node
    score: np.ndarray       # [K] its score in the wave it was chosen
    status: np.ndarray      # [K] STATUS_*
    used: np.ndarray        # [Np, R] usage after the solve
    waves: int
    feas: np.ndarray        # [Gp, Np] static feasibility


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as f32."""
    b = np.ascontiguousarray(x, dtype=f32).view(np.uint32)
    with np.errstate(over="ignore"):
        r = (b + u32(0x7FFF) + ((b >> u32(16)) & u32(1))) & u32(0xFFFF0000)
    return r.view(f32)


def top_k(score: np.ndarray, k: int):
    """Exact descending top-k per row, ties to the lower index."""
    n = score.shape[1]
    k = min(k, n)
    if k >= n // 2:
        order = np.argsort(-score, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(score, order, axis=1), order
    kth = -np.partition(-score, k - 1, axis=1)[:, k - 1:k]
    above = score > kth
    tie = score == kth
    need = k - above.sum(axis=1, keepdims=True)
    take = above | (tie & (np.cumsum(tie, axis=1) <= need))
    idx = np.nonzero(take)[1].reshape(score.shape[0], k)
    vals = np.take_along_axis(score, idx, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(idx, order, axis=1))


def op_eval(vals, op, rank):
    """[Gp, Np, C] result of each constraint operator on attr ranks."""
    found = vals >= 0
    rk = rank[:, None, :]
    eq = found & (vals == rk)
    opb = op[:, None, :]
    res = np.ones_like(found)
    res = np.where(opb == OP_EQ, eq, res)
    res = np.where(opb == OP_NE, ~eq, res)
    res = np.where(opb == OP_LT, found & (vals < rk), res)
    res = np.where(opb == OP_LE, found & (vals <= rk), res)
    res = np.where(opb == OP_GT, found & (vals > rk), res)
    res = np.where(opb == OP_GE, found & (vals >= rk), res)
    res = np.where(opb == OP_IS_SET, found, res)
    res = np.where(opb == OP_NOT_SET, ~found, res)
    return res


def static_program(p):
    """Static feasibility, the affinity plane and the spread lookups."""
    attr_rank = p["attr_rank"]
    vals3 = attr_rank[:, p["c_col"]].transpose(1, 0, 2)
    ok3 = op_eval(vals3, p["c_op"], p["c_rank"])
    base = (p["valid"][None, :] & p["dc_ok"][:, p["node_dc"]]
            & p["host_ok"])
    feas = base & ok3.all(axis=2)
    avals3 = attr_rank[:, p["a_col"]].transpose(1, 0, 2)
    match3 = op_eval(avals3, p["a_op"], p["a_rank"])
    aff = ((match3 * p["a_weight"][:, None, :]).sum(axis=2)
           + np.asarray(p["a_host"], f32)).astype(f32)
    sp_col = p["sp_col"]
    S, V = sp_col.shape[1], p["sp_desired"].shape[2]
    Gp, Np = feas.shape
    vnode = np.full((S, Gp, Np), -1, np.int32)
    des = np.zeros((S, Gp, Np), f32)
    for s in range(S):
        col = sp_col[:, s]
        v = attr_rank[:, np.maximum(col, 0)].T.astype(np.int32)
        v = np.where((col >= 0)[:, None], v, -1)
        d = np.take_along_axis(np.asarray(p["sp_desired"][:, s], f32),
                               np.clip(v, 0, V - 1), axis=1)
        d = np.where(v >= 0, d, f32(-1.0))
        d = np.where(d < 0, np.asarray(p["sp_implicit"][:, s],
                                       f32)[:, None], d)
        vnode[s], des[s] = v, d
    return feas, aff, vnode, des


def _spread_term(p, sp_used, vnode, des, s, V):
    col = p["sp_col"][:, s]
    v = vnode[s]
    has_v = v >= 0
    used_vec = sp_used[:, s]
    cur = np.where(has_v, np.take_along_axis(
        used_vec, np.clip(v, 0, V - 1), axis=1), f32(0.0))
    desired = des[s]
    boost = ((desired - (cur + f32(1.0))) / np.maximum(desired, f32(1e-9))
             ) * np.asarray(p["sp_weight"][:, s], f32)[:, None]
    targeted = np.where(~has_v, f32(-1.0),
                        np.where(desired <= 0, f32(-1.0), boost))
    present = used_vec > 0
    anyp = present.any(axis=1)[:, None]
    minc = np.min(np.where(present, used_vec, np.inf),
                  axis=1)[:, None].astype(f32)
    maxc = np.max(np.where(present, used_vec, -np.inf),
                  axis=1)[:, None].astype(f32)
    minc = np.where(anyp, minc, f32(0.0))
    maxc = np.where(anyp, maxc, f32(0.0))
    delta = (minc - cur) / np.maximum(minc, f32(1e-9))
    even = np.where(cur != minc, delta,
                    np.where(minc == maxc, f32(-1.0),
                             (maxc - minc) / np.maximum(minc, f32(1e-9))))
    even = np.where(~has_v, f32(-1.0), even)
    even = np.where(anyp, even, f32(0.0))
    contrib = np.where(p["sp_targeted"][:, s][:, None], targeted, even)
    return np.where((col >= 0)[:, None], contrib, f32(0.0))


def _prior_sum(cand, ok, vals):
    """Per row, the sum of `vals` over earlier ok rows on the same node."""
    key = np.where(ok, cand, np.iinfo(np.int64).max)
    order = np.argsort(key, kind="stable")
    v = (vals * ok[:, None]).astype(np.float64)[order]
    cum = np.cumsum(v, axis=0) - v
    sk = key[order]
    start = np.ones(len(sk), bool)
    start[1:] = sk[1:] != sk[:-1]
    first = np.maximum.accumulate(np.where(start, np.arange(len(sk)), 0))
    out = np.empty_like(v)
    out[order] = cum - cum[first]
    return out.astype(f32)


def _prior_rank(key, member):
    """Per member row, how many earlier member rows share its key."""
    k = np.where(member, key, np.iinfo(np.int64).max)
    order = np.argsort(k, kind="stable")
    sk = k[order]
    start = np.ones(len(sk), bool)
    start[1:] = sk[1:] != sk[:-1]
    pos = np.arange(len(sk))
    first = np.maximum.accumulate(np.where(start, pos, 0))
    out = np.zeros(len(sk), np.int64)
    out[order] = pos - first
    return np.where(member, out, 0)


def solve(p, n_place, seed=0, *, has_spread=True, group_count_hint=0,
          max_waves=0, precision="f32") -> Result:
    """One batch's wave solve over the planes `p` (a dict of arrays, the
    names of the port's packed batch), from the usage `p["used0"]`."""
    lo = bf16 if precision == "bf16" else (lambda x: x)
    avail = np.asarray(p["avail"], f32)
    reserved = np.asarray(p["reserved"], f32)
    used = np.array(p["used0"], f32)
    ask_res = np.asarray(p["ask_res"], f32)
    dev_cap = np.asarray(p["dev_cap"], f32)
    dev_used = np.array(p["dev_used0"], f32)
    dev_ask = np.asarray(p["dev_ask"], f32)
    sp_used = np.array(p["sp_used0"], f32)
    valid = np.asarray(p["valid"], bool)
    attr_rank = p["attr_rank"]
    sp_col = p["sp_col"]
    distinct = np.asarray(p["distinct"])
    max_waves = max_waves or MAX_WAVES
    Np, R = avail.shape
    Gp = ask_res.shape[0]
    S = sp_col.shape[1]
    V = p["sp_desired"].shape[2]
    K = p["p_ask"].shape[0]
    per_group = group_count_hint if group_count_hint > 0 else K // 8
    w_cap = MERGED_W_CAP if Gp <= MERGED_GP_MAX else WIDE_W_CAP
    TK = min(max(WAVE_K, min(2 * per_group, w_cap)) + TOP_K, Np)
    W = max(TK - TOP_K, 1)
    ks = np.arange(K)
    gs = np.arange(Gp)
    g_idx = np.asarray(p["p_ask"], np.int64)

    feas, aff, vnode, des = static_program(p)
    penalty = np.asarray(p["penalty"], bool)
    pen_score = np.where(penalty, f32(-1.0), f32(0.0))
    coll0 = np.asarray(p["coll0"], f32)
    ask_desired = np.asarray(p["ask_desired"], f32)

    with np.errstate(over="ignore"):
        h = (np.arange(Np, dtype=u32)[None, :] * u32(2654435761)
             + (gs.astype(u32)[:, None] * u32(7919) + u32(seed))
             * u32(40503))
        h = (h ^ (h >> u32(16))) * u32(2246822519)
    jitter = (np.zeros((Gp, Np), f32) if seed == 0 else
              (h & u32(1023)).astype(f32) * f32(SCORE_BIN / 1023.0))

    def scores(coll, blocked):
        after = used[None, :, :] + ask_res[:, None, :]
        fit_dims = after <= avail[None, :, :]
        fit = fit_dims.all(-1)
        dev_fit = (dev_used[None, :, :] + dev_ask[:, None, :]
                   <= dev_cap[None, :, :]).all(-1)
        placeable = feas & ~blocked & fit & dev_fit
        dc = avail[None, :, R_CPU]
        dm = avail[None, :, R_MEM]
        free_c = f32(1.0) - (after[:, :, R_CPU] + reserved[None, :, R_CPU]
                             ) / np.maximum(dc, f32(1.0))
        free_m = f32(1.0) - (after[:, :, R_MEM] + reserved[None, :, R_MEM]
                             ) / np.maximum(dm, f32(1.0))
        raw = f32(20.0) - (f32(10.0) ** free_c + f32(10.0) ** free_m)
        binpack = np.where((dc > 0) & (dm > 0),
                           np.clip(raw, f32(0.0), f32(18.0)) / f32(18.0),
                           f32(0.0))
        binpack = lo(binpack)
        anti = lo(np.where(coll > 0,
                           -(coll + f32(1.0)) / ask_desired[:, None],
                           f32(0.0)))
        if has_spread:
            sp_total = np.zeros((Gp, Np), f32)
            for s in range(S):
                sp_total = sp_total + _spread_term(p, sp_used, vnode, des,
                                                   s, V)
            sp_total = lo(sp_total)
            sp_counts = sp_total != 0.0
        else:
            sp_total, sp_counts = f32(0.0), False
        n_sc = (f32(1.0) + (coll > 0) + penalty + (aff != 0.0)
                + sp_counts).astype(f32)
        total = lo((binpack + anti + pen_score + lo(aff) + sp_total) / n_sc)
        if seed != 0:
            total = np.floor(total / f32(SCORE_BIN)) * f32(SCORE_BIN)
        total = lo(lo(total) + jitter)
        return np.where(placeable, total, NEG_INF), placeable

    done = np.zeros(K, bool)
    out_idx = np.zeros((K, TOP_K), np.int64)
    out_ok = np.zeros((K, TOP_K), bool)
    out_score = np.full(K, NEG_INF, f32)
    wave = 0
    while wave < max_waves:
        active = ~done & (ks < n_place)
        if not active.any():
            break
        committed = done & out_ok[:, 0]
        chosen = np.where(committed, out_idx[:, 0], 0)
        coll = coll0.copy()
        np.add.at(coll, (g_idx, chosen), committed.astype(f32))
        dg_all = distinct[g_idx]
        hit = np.zeros((Gp, Np), bool)
        sel = committed & (dg_all >= 0)
        hit[np.maximum(dg_all[sel], 0), chosen[sel]] = True
        blocked = hit[np.maximum(distinct, 0)] & (distinct >= 0)[:, None]

        score, placeable = scores(coll, blocked)
        top_s, top_i = top_k(score, TK)
        if has_spread and V <= 8:
            has0 = sp_col[:, 0] >= 0
            vn = vnode[0]
            TKv = -(-TK // (V + 1))
            tabs_i, tabs_s = [], []
            for v in range(V + 1):
                vmask = (vn == v) if v < V else (vn < 0)
                ts, ti = top_k(np.where(vmask, score, NEG_INF), TKv)
                tabs_i.append(ti)
                tabs_s.append(ts)
            tab_i = np.stack(tabs_i, axis=1)
            tab_s = np.stack(tabs_s, axis=1)
            vord = np.argsort(-tab_s[:, :, 0], axis=1, kind="stable")
            j = np.arange(TK)
            vj = vord[:, j % (V + 1)]
            inter_i = tab_i[gs[:, None], vj, (j // (V + 1))[None, :]]
            inter_s = tab_s[gs[:, None], vj, (j // (V + 1))[None, :]]
            order = np.argsort((inter_s <= NEG_INF / 2).astype(np.int32),
                               axis=1, kind="stable")
            inter_i = np.take_along_axis(inter_i, order, axis=1)
            inter_s = np.take_along_axis(inter_s, order, axis=1)
            top_i = np.where(has0[:, None], inter_i, top_i)
            top_s = np.where(has0[:, None], inter_s, top_s)

        grp_any = placeable.any(axis=1)
        onehot = (g_idx[None, :] == gs[:, None]) & active[None, :]
        act_g = onehot.sum(axis=1)
        rank = (np.cumsum(onehot, axis=1) - onehot)[g_idx, ks]
        n_cand = (top_s > NEG_INF / 2).sum(axis=1)
        M = np.clip(np.minimum(n_cand, W), 1, W)
        with np.errstate(over="ignore"):
            g_hash = ((gs.astype(u32) * u32(2654435761))
                      ^ (u32(seed) * u32(2246822519)))
        g_off = (np.zeros(Gp, np.int64) if seed == 0 else
                 ((g_hash >> u32(8)) % u32(W)).astype(np.int64))
        rot = 0 if seed == 0 else wave
        cr = (rank + g_off[g_idx] + rot) % M[g_idx]
        cand = top_i[g_idx, cr].astype(np.int64)
        cand_ok = active & (top_s[g_idx, cr] > NEG_INF / 2)
        fail_now = active & ~grp_any[g_idx]

        res_k = ask_res[g_idx] * cand_ok[:, None]
        fits = ((used[cand] + _prior_sum(cand, cand_ok, res_k)
                 + ask_res[g_idx]) <= avail[cand]).all(axis=-1)
        dev_k = dev_ask[g_idx] * cand_ok[:, None]
        dev_fits = ((dev_used[cand] + _prior_sum(cand, cand_ok, dev_k)
                     + dev_ask[g_idx]) <= dev_cap[cand]).all(axis=-1)
        dg = distinct[g_idx]
        dg_ok = _prior_rank(cand * Gp + np.maximum(dg, 0),
                            (dg >= 0) & cand_ok) == 0
        sp_ok = np.ones(K, bool)
        for s in (range(S) if has_spread else ()):
            cols = sp_col[g_idx, s]
            vs = attr_rank[cand, np.maximum(cols, 0)]
            has_s = (cols >= 0) & (vs >= 0)
            vsc = np.maximum(vs, 0).astype(np.int64)
            des_s = np.asarray(p["sp_desired"][:, s], f32)
            use_s = sp_used[:, s]
            des_eff = np.where(des_s < 0, np.asarray(
                p["sp_implicit"][:, s], f32)[:, None], des_s)
            present = use_s > 0
            hi = np.max(np.where(present, use_s, f32(0.0)), axis=1)[:, None]
            lo_c = np.min(np.where(present, use_s, np.where(
                present.any(axis=1)[:, None], np.inf, 0.0)),
                axis=1)[:, None]
            lo_c = np.where(np.isfinite(lo_c), lo_c, 0.0).astype(f32)
            share = np.ceil(act_g.astype(f32) / V)[:, None]
            level = np.maximum(hi, lo_c + share)
            even_q = (np.maximum(f32(1.0), level - use_s)
                      if wave < max(max_waves // 2, 1)
                      else np.full_like(use_s, np.inf))
            quota = np.where(np.asarray(p["sp_targeted"][:, s])[:, None],
                             np.maximum(f32(1.0), des_eff - use_s), even_q)
            gv_rank = _prior_rank((g_idx * V + vsc) * 2 + 1,
                                  has_s & cand_ok).astype(f32)
            sp_ok &= ~has_s | (gv_rank
                               < quota[g_idx, np.minimum(vsc, V - 1)])

        commit = cand_ok & fits & dev_fits & dg_ok & sp_ok
        cm = commit[:, None]
        np.add.at(used, cand, ask_res[g_idx] * cm)
        np.add.at(dev_used, cand, dev_ask[g_idx] * cm)
        if has_spread:
            svals = attr_rank[cand[:, None], np.maximum(sp_col[g_idx], 0)]
            okslot = (sp_col[g_idx] >= 0) & (svals >= 0) & (svals < V) & cm
            np.add.at(sp_used, (g_idx[:, None], np.arange(S)[None, :],
                                np.clip(svals, 0, V - 1)),
                      okslot.astype(f32))
        offs = cr[:, None] + np.arange(TOP_K)[None, :]
        pk_i = top_i[g_idx[:, None], offs]
        pk_ok = (top_s[g_idx[:, None], offs] > NEG_INF / 2) & cm
        newly = commit | fail_now
        out_idx = np.where(newly[:, None], pk_i, out_idx)
        out_ok = np.where(newly[:, None], pk_ok, out_ok)
        out_score = np.where(newly, top_s[g_idx, cr], out_score)
        done |= newly
        wave += 1

    unfinished = ~done & (ks < n_place)
    status = np.where(out_ok[:, 0], STATUS_COMMITTED,
                      np.where(unfinished, STATUS_RETRY, STATUS_FAILED))
    return Result(choice=out_idx[:, 0], ok=out_ok[:, 0], score=out_score,
                  status=status,
                  used=used, waves=wave, feas=feas)
