"""The spec terms driven through the port's `TorchOps`, term by term
against the JAX package's `NumpyOps` / `JaxOps` on the reference's
randomized planes, with the reference's own bounds: IEEE-exact terms
(anti, penalty, combine) bit-identical, binpack's 10**x within 4 ulp,
the spread accumulation within 2 ulp."""
import numpy as np
import pytest
import torch

from nomad_tpu.solver import score_spec as ss
from nomad_tpu_torch.solver import score_spec as ts
from test_score_spec import _jnp, _rand_parts, _rand_planes, _to_jax

TOPS = ts.TorchOps()


def _to_torch(ctx):
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in ctx.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_terms_bit_identical(seed):
    ctx = _rand_planes(seed)
    tctx = _to_torch(ctx)
    an, anc = ss.term_anti(ss.NumpyOps(), ctx)
    aj, _ = ss.term_anti(ss.JaxOps(), _to_jax(ctx))
    at, atc = ts.term_anti(TOPS, tctx)
    np.testing.assert_array_equal(at.numpy(), an)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(atc.numpy(), anc)

    pn = ss.term_penalty(ss.NumpyOps(), {"penalty": ctx["penalty"]})
    pt = ts.term_penalty(TOPS, {"penalty": tctx["penalty"]})
    np.testing.assert_array_equal(pt.numpy(), pn)

    rng = np.random.default_rng(seed + 100)
    parts = _rand_parts(rng, 6, 33)
    for s in (0, 3):
        cctx = {"seed": s, "jitter": ctx["jitter"]}
        cn = ss.combine(ss.NumpyOps(), cctx, parts)
        cj = ss.combine(ss.JaxOps(), _to_jax(cctx), _to_jax(parts))
        ct = ts.combine(TOPS, _to_torch(cctx), _to_torch(parts))
        np.testing.assert_array_equal(ct.numpy(), cn)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binpack_within_pow_ulp(seed):
    ctx = _rand_planes(seed)
    after = ctx["used"][None, :, :] + ctx["ask_res"][:, None, :]
    bn = ss.rescore_binpack(ss.NumpyOps(), after, ctx["avail"],
                            ctx["reserved"])
    bj = ss.rescore_binpack(ss.JaxOps(), _jnp().asarray(after),
                            ctx["avail"], ctx["reserved"])
    bt = ts.rescore_binpack(TOPS, torch.as_tensor(after),
                            torch.as_tensor(ctx["avail"]),
                            torch.as_tensor(ctx["reserved"])).numpy()
    np.testing.assert_array_max_ulp(bt, bn, maxulp=4)
    np.testing.assert_array_max_ulp(bt, np.asarray(bj), maxulp=4)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("V", [8, 32])
def test_spread_both_gather_regimes(seed, V):
    """V=8: TorchOps' select-sum `cur`, as JaxOps; V=32: the gather."""
    Gp, Np, S = 6, 33, 3
    ctx = _rand_planes(seed, V=V)
    ctx["V"] = V
    cj, ct = _to_jax(ctx), _to_torch(ctx)
    outn = ss.NumpyOps().spread_sum(
        S, lambda s: ss.term_spread(ss.NumpyOps(), ctx, s), (Gp, Np))
    jops = ss.JaxOps()
    outj = jops.spread_sum(S, lambda s: ss.term_spread(jops, cj, s),
                           (Gp, Np))
    outt = TOPS.spread_sum(S, lambda s: ts.term_spread(TOPS, ct, s),
                           (Gp, Np)).numpy()
    np.testing.assert_array_max_ulp(outt, outn, maxulp=2)
    np.testing.assert_array_max_ulp(outt, np.asarray(outj), maxulp=2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("has_spread", [True, False])
def test_evaluate_wave_cross_backend(seed, has_spread):
    """The full term loop: every mask bit-equal to both reference shims,
    finite scores under the reference's tight allclose."""
    Gp, Np, S, V = 6, 33, 3, 8
    planes = _rand_planes(seed, Gp=Gp, Np=Np, S=S, V=V)
    planes.pop("learned")
    pen = planes.pop("penalty")
    outs = []
    for ops, conv, mod in ((ss.NumpyOps(), np.asarray, ss),
                           (ss.JaxOps(), _jnp().asarray, ss),
                           (TOPS, torch.as_tensor, ts)):
        ctx = {k: conv(v) if isinstance(v, np.ndarray) else v
               for k, v in planes.items()}
        pen_score, pen_counts = mod.static_terms(ops, conv(pen))
        ctx.update(pen_score=pen_score, pen_counts=pen_counts, S=S, V=V,
                   shape=(Gp, Np), seed=seed, has_devices=True,
                   has_spread=has_spread, learned=None)
        outs.append([np.asarray(o) for o in mod.evaluate_wave(ops, ctx)])
    (score_t, *masks_t) = outs[2]
    for ref_out in outs[:2]:
        score_r, *masks_r = ref_out
        for mt, mr in zip(masks_t, masks_r):
            np.testing.assert_array_equal(mt, mr)
        fin_t = score_t > ss.NEG_INF / 2
        np.testing.assert_array_equal(fin_t, score_r > ss.NEG_INF / 2)
        np.testing.assert_allclose(score_t[fin_t], score_r[fin_t],
                                   rtol=2e-5, atol=2e-6)
