"""The wave body's one-sort conflict check and commits (`seg_kernel`'s
plain version, which the CPU runs above 2,048 placements a wave) against
the [K, K] mask path and against accumulating `index_put`s.

Every case holds integer asks (the solve's resources are MHz and MB), K
above the mask path's 2,048, few, many or all-same candidate nodes, and
rows outside the check.  `make_case` is shared with
tests/test_torch_seg_kernel_gpu.py, which holds the CUDA kernels to the
plain version.  These tests import neither JAX nor the JAX package."""
import types

import numpy as np
import pytest
import torch

from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver import seg_kernel as sk

NP, GP, S, V, C = 10_240, 4, 2, 4, 1_152
LAYOUTS = {"few": 8, "many": NP, "same": 1}
CASES = [(K, layout) for K in (2049, 8192) for layout in LAYOUTS]


def make_case(K, layout, seed=0, device="cpu"):
    """One wave's conflict inputs: candidates `cand` [K] on
    LAYOUTS[layout] nodes, `ok` [K] (about 85% in the check), integer
    asks `ask` [K, 4], group and spread value per row, and the commit
    targets: usage [NP, 4], spread counts [GP, S, V], the shortlist's
    collocation counts [GP, C] and the full pass's [GP, NP]."""
    rng = np.random.default_rng(seed + 17 * K + len(layout))
    f32 = np.float32
    n = LAYOUTS[layout]
    x = {
        "cand": rng.integers(0, n, K),
        "ok": rng.random(K) < 0.85,
        "ask": rng.integers(1, 1000, (K, 4)).astype(f32),
        "g": rng.integers(0, GP, K),
        "v": rng.integers(-1, V, (K, S)),
        "dg": rng.integers(-1, GP, K),
        "p_ok": rng.random(K) < 0.5,
        "commit": rng.random(K) < 0.7,
        "pos": rng.integers(0, C + 1, K),
        "used": rng.integers(0, 50_000, (NP, 4)).astype(f32),
        "sp_used": rng.integers(0, 100, (GP, S, V)).astype(f32),
        "coll": rng.integers(0, 8, (GP, C)).astype(f32),
        "coll0": rng.integers(0, 8, (GP, NP)).astype(f32),
    }
    x = {k: torch.as_tensor(v, device=device) for k, v in x.items()}
    x["commit"] = x["commit"] & x["ok"]
    # the full pass's collocation rows: uncommitted ones at column 0
    x["chosen"] = torch.where(x["commit"], x["cand"], 0)
    return x


def helpers(K, x, seg):
    """The conflict helpers of `kernel._seg_conflicts`: the sort path
    when `seg`, else the [K, K] masks (whatever K)."""
    k = types.SimpleNamespace(K=K if seg else 0)
    c = types.SimpleNamespace(ks=torch.arange(K, device=x["cand"].device))
    return port_kernel._seg_conflicts(k, c, x["ok"], x["cand"])


def conflict_outputs(K, x, seg):
    """What the wave body asks of the helpers: the prior sums of the
    asks, the distinct-hosts and spread ranks and the eviction rank."""
    prior_sum, rank_any, rank, segs = helpers(K, x, seg)
    gv = (x["g"] * V + x["v"][:, 0].clamp(0, V - 1)) * 2 + 1
    return {
        "prior": prior_sum(x["ask"] * x["ok"][:, None]),
        "prior_raw": prior_sum(x["ask"]),
        "distinct": rank(x["cand"] * GP + x["dg"].clamp(min=0),
                         x["dg"] >= 0),
        "spread": rank(gv, x["v"][:, 0] >= 0),
        "evict": rank_any(x["cand"], x["p_ok"]),
    }, segs


def commit_outputs(x, segs):
    """The wave's commits through the one sort: usage, the marks of
    committed nodes, spread and collocation counts, and the full pass's
    collocation counts."""
    s_ar = torch.arange(S, device=x["cand"].device)
    cell = (x["g"][:, None] * S + s_ar[None, :]) * V + x["v"].clamp(0, V - 1)
    return {
        "used": sk.seg_add(segs, x["used"], x["ask"], x["commit"]),
        "mark": sk.seg_add(segs, torch.zeros_like(x["used"][:, 0]), None,
                           x["commit"]),
        "sp_used": sk.hist_add(x["sp_used"], cell,
                               (x["v"] >= 0) & x["commit"][:, None]),
        "coll": sk.hist_add(x["coll"], x["g"] * C + x["pos"],
                            x["commit"] & (x["pos"] < C)),
        "coll0": sk.hist_add(x["coll0"], x["g"] * NP + x["chosen"],
                             x["commit"]),
    }


def scatter_outputs(x):
    """The same commits as accumulating scatters (the [K, K] mask
    path's)."""
    cm = x["commit"]
    cf = cm.to(torch.float32)
    v = x["v"]
    okslot = (v >= 0) & cm[:, None]
    pad = torch.cat([x["coll"], torch.zeros((GP, 1))], dim=1)
    return {
        "used": x["used"].index_put((x["cand"],), x["ask"] * cm[:, None],
                                    accumulate=True),
        "mark": torch.zeros(NP).index_put((x["cand"],), cf,
                                          accumulate=True),
        "sp_used": x["sp_used"].index_put(
            (x["g"][:, None], torch.arange(S)[None, :], v.clamp(0, V - 1)),
            okslot.to(torch.float32), accumulate=True),
        "coll": pad.index_put((x["g"], x["pos"]), cf,
                              accumulate=True)[:, :C],
        "coll0": x["coll0"].index_put((x["g"], x["chosen"]), cf,
                                      accumulate=True),
    }


@pytest.mark.parametrize("K,layout", CASES)
def test_one_sort_conflicts_equal_the_mask_path(K, layout):
    """Prior sums and ranks over the one node sort equal the [K, K] mask
    path's, bit for bit, on every row (rows outside the check read 0 on
    both)."""
    x = make_case(K, layout)
    got, segs = conflict_outputs(K, x, seg=True)
    want, none = conflict_outputs(K, x, seg=False)
    assert none is None and segs is not None
    assert segs.key.dtype == torch.int32
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert torch.equal(got["prior"], got["prior_raw"])
    if layout == "same":
        # every row in the check on one node: the k-th of them has the
        # k earlier asks ahead of it
        ok = x["ok"]
        lead = torch.cumsum(x["ask"] * ok[:, None], 0) - x["ask"]
        assert torch.equal(got["prior"][ok], lead[ok])


@pytest.mark.parametrize("K,layout", CASES + [(512, "few")])
def test_one_sort_commits_equal_the_scatters(K, layout):
    """The commit reduce over the node sort and the commit counts equal
    `index_put(accumulate=True)` on usage, the node marks, the spread
    counts and both collocation counts (the counts at every K: the mask
    path commits them through `hist_add` too)."""
    x = make_case(K, layout)
    got = commit_outputs(x, sk.sort_segments(x["cand"], x["ok"]))
    want = scatter_outputs(x)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("nt,gp,v,raises", [
    (NP, GP, V, False), (NP, 1 << 18, V, True), (1, 1 << 28, 8, True)])
def test_sort_keys_past_int32_are_refused(nt, gp, v, raises):
    """The sort path's keys are int32: a solve whose node and distinct
    group key or spread value class could reach 2^31 - 1 is refused at
    set-up; the stream cells' sizes pass."""
    if raises:
        with pytest.raises(ValueError, match="int32 sort keys"):
            port_kernel._check_sort_keys(nt, gp, v)
    else:
        port_kernel._check_sort_keys(nt, gp, v)
