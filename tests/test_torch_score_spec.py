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


# ------------------------------------------ the numpy shim and the planes
NOPS = ts.NumpyOps()


def test_registry_and_version_match_reference():
    """TERMS (every entry's name, function, fingerprint groups, const-set
    flag and backends; the docs are prose), term_names and SPEC_VERSION
    are the reference's, and every listed function exists here."""
    keys = ("name", "fn", "groups", "const_set", "backends")
    assert [{k: t[k] for k in keys} for t in ts.TERMS] == \
        [{k: t[k] for k in keys} for t in ss.TERMS]
    assert ts.term_names() == ss.term_names()
    assert ts.SPEC_VERSION == ss.SPEC_VERSION
    for t in ts.TERMS:
        assert callable(getattr(ts, t["fn"])), t["fn"]
    assert ts.NEG_INF == ss.NEG_INF and ts.SCORE_BIN == ss.SCORE_BIN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_ops_terms_bit_identical(seed):
    """The port's NumpyOps drives every term exactly as the reference's:
    anti, penalty, binpack, spread (both gather regimes)."""
    ctx = _rand_planes(seed)
    for a, b in zip(ts.term_anti(NOPS, ctx), ss.term_anti(ss.NumpyOps(),
                                                          ctx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.static_terms(NOPS, ctx["penalty"]),
                    ss.static_terms(ss.NumpyOps(), ctx["penalty"])):
        np.testing.assert_array_equal(a, b)
    after = ctx["used"][None, :, :] + ctx["ask_res"][:, None, :]
    np.testing.assert_array_equal(
        ts.rescore_binpack(NOPS, after, ctx["avail"], ctx["reserved"]),
        ss.rescore_binpack(ss.NumpyOps(), after, ctx["avail"],
                           ctx["reserved"]))
    for V in (8, 32):
        c = _rand_planes(seed, V=V)
        c["V"] = V
        np.testing.assert_array_equal(
            NOPS.spread_sum(3, lambda s: ts.term_spread(NOPS, c, s),
                            (6, 33)),
            ss.NumpyOps().spread_sum(
                3, lambda s: ss.term_spread(ss.NumpyOps(), c, s), (6, 33)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["combine_learned", "combine_region",
                                "combine_learned_region"])
def test_plane_combines_match_reference(seed, fn):
    """The three plane combines, seeded and not, bit-identical to the
    reference's numpy and jax combines through both of the port's
    shims; zero plane entries count as no scorer."""
    ctx = _rand_planes(seed)
    rng = np.random.default_rng(seed + 200)
    parts = _rand_parts(rng, 6, 33)
    learned = ctx["learned"].copy()
    learned[rng.random(learned.shape) < 0.3] = 0.0
    region = np.array([0.5, 0.2, 0.0], np.float32)[
        rng.integers(0, 3, learned.shape)]
    parts = dict(parts, learned=learned, region=region)
    for s in (0, 3):
        cctx = {"seed": s, "jitter": ctx["jitter"]}
        ref = getattr(ss, fn)(ss.NumpyOps(), cctx, parts)
        refj = getattr(ss, fn)(ss.JaxOps(), _to_jax(cctx), _to_jax(parts))
        np.testing.assert_array_equal(ref, np.asarray(refj))
        np.testing.assert_array_equal(getattr(ts, fn)(NOPS, cctx, parts),
                                      ref)
        got = getattr(ts, fn)(TOPS, _to_torch(cctx), _to_torch(parts))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("planes", ["none", "learned", "region", "both"])
def test_evaluate_wave_planes_cross_backend(seed, planes):
    """The full term loop with each optional plane: the port's NumpyOps
    bit-equal to the reference's, its TorchOps masks bit-equal and finite
    scores under the reference's tight allclose."""
    Gp, Np, S, V = 6, 33, 3, 8
    planes_ = _rand_planes(seed, Gp=Gp, Np=Np, S=S, V=V)
    learned = planes_.pop("learned")
    region = np.array([0.5, 0.2, 0.0], np.float32)[
        np.random.default_rng(seed).integers(0, 3, (Gp, Np))]
    pen = planes_.pop("penalty")
    use_l = planes in ("learned", "both")
    use_r = planes in ("region", "both")
    outs = []
    for ops, conv, mod in ((ss.NumpyOps(), np.asarray, ss),
                           (NOPS, np.asarray, ts),
                           (TOPS, torch.as_tensor, ts)):
        ctx = {k: conv(v) if isinstance(v, np.ndarray) else v
               for k, v in planes_.items()}
        pen_score, pen_counts = mod.static_terms(ops, conv(pen))
        ctx.update(pen_score=pen_score, pen_counts=pen_counts, S=S, V=V,
                   shape=(Gp, Np), seed=seed, has_devices=True,
                   has_spread=True,
                   learned=conv(learned) if use_l else None,
                   region_bias=conv(region) if use_r else None)
        outs.append([np.asarray(o) for o in mod.evaluate_wave(ops, ctx)])
    ref, port_np, port_t = outs
    for a, b in zip(port_np, ref):
        np.testing.assert_array_equal(a, b)
    for mt, mr in zip(port_t[1:], ref[1:]):
        np.testing.assert_array_equal(mt, mr)
    fin = ref[0] > ss.NEG_INF / 2
    np.testing.assert_array_equal(port_t[0] > ss.NEG_INF / 2, fin)
    np.testing.assert_allclose(port_t[0][fin], ref[0][fin], rtol=2e-5,
                               atol=2e-6)


def test_zero_plane_is_noop_and_none_keeps_combine():
    """No plane: evaluate_wave takes `combine` itself; an all-zeros plane
    counts as no scorer and adds zero (placements unmoved), as in the
    reference."""
    Gp, Np, S, V = 6, 33, 3, 8
    planes_ = _rand_planes(0, Gp=Gp, Np=Np, S=S, V=V)
    planes_.pop("learned")
    pen = planes_.pop("penalty")
    pen_score, pen_counts = ts.static_terms(NOPS, pen)
    base = dict(planes_, pen_score=pen_score, pen_counts=pen_counts, S=S,
                V=V, shape=(Gp, Np), seed=3, has_devices=True,
                has_spread=True)
    none = ts.evaluate_wave(NOPS, dict(base, learned=None,
                                       region_bias=None))[0]
    zeros = np.zeros((Gp, Np), np.float32)
    for key in ("learned", "region_bias"):
        z = ts.evaluate_wave(NOPS, dict(base, **{key: zeros}))[0]
        np.testing.assert_array_equal(np.abs(z), np.abs(none))
