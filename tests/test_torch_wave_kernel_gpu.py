"""The fused wave CUDA kernel against its plain torch version, on the
card.  These tests import neither JAX nor the JAX package, so they also
run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wave_kernel_gpu.py

Without a GPU they skip (the kernel has no CPU or interpret mode).  The
input builders here are shared with test_torch_wave_kernel.py, which holds
the plain version against the JAX package's Pallas kernel."""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.solver import wave_kernel as wk


def make_inputs(seed, Gp, Np, S=1, V=4, D=0, blocked=False, wave_seed=3):
    """Numpy inputs for one wave at realistic magnitudes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cap = np.stack([4000 + (np.arange(Np) % 8) * 1000,
                    8192 + (np.arange(Np) % 4) * 4096,
                    np.full(Np, 100_000), np.full(Np, 1000)], 1).astype(f32)
    used = (rng.integers(0, 30, Np)[:, None]
            * np.array([200, 256, 300, 0])).astype(f32)
    ask = np.stack([400 + (np.arange(Gp) % 4) * 150,
                    256 + (np.arange(Gp) % 4) * 128,
                    np.full(Gp, 300), np.zeros(Gp)], 1).astype(f32)
    x = dict(
        feas=rng.random((Gp, Np)) < 0.85, pen=rng.random((Gp, Np)) < 0.1,
        blocked=(rng.random((Gp, Np)) < 0.1) if blocked else None,
        aff=(rng.random((Gp, Np)) < 0.2).astype(f32) * f32(0.35),
        jitter=(rng.integers(0, 1024, (Gp, Np)).astype(f32)
                * f32(0.05 / 1023.0)) if wave_seed else
        np.zeros((Gp, Np), f32),
        coll=rng.integers(0, 3, (Gp, Np)).astype(f32)
        * (rng.random((Gp, Np)) < 0.2),
        used=used, avail=cap,
        reserved=rng.integers(0, 2, (Np, 4)).astype(f32) * f32(100),
        ask_res=ask, ask_desired=rng.integers(1, 20, Gp).astype(f32))
    if D:
        x["dev"] = (rng.integers(0, 4, (Np, D)).astype(f32),
                    np.full((Np, D), 4.0, f32),
                    (rng.random((Gp, D)) < 0.5).astype(f32))
    if S:
        vnode = rng.integers(-1, V, (S, Gp, Np))
        sp_used = rng.integers(0, 6, (Gp, S, V)).astype(f32)
        pres = sp_used > 0
        anyp = pres.any(2)
        x["spread"] = (
            vnode.astype(np.int16),
            np.where(vnode >= 0, rng.integers(0, 8, vnode.shape),
                     -1).astype(f32),
            sp_used, rng.uniform(0.2, 1.0, (Gp, S)).astype(f32),
            rng.random((Gp, S)) < 0.5,
            (rng.random((Gp, S)) < 0.9).astype(np.int8),
            np.where(anyp, np.where(pres, sp_used, np.inf).min(2),
                     0).astype(f32),
            np.where(anyp, sp_used.max(2), 0).astype(f32),
            anyp.astype(np.int8))
    x["seed"] = wave_seed
    return x


def port_kwargs(x, device="cpu"):
    from nomad_tpu_torch.solver.masks import pack_bool_u32

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    kw = {k: (t(v) if isinstance(v, np.ndarray) else v)
          for k, v in x.items() if k not in ("dev", "spread")}
    for k in ("feas", "pen", "blocked"):
        if kw[k] is not None:
            kw[k] = pack_bool_u32(kw[k])
    kw["dev"] = tuple(t(a) for a in x["dev"]) if "dev" in x else None
    kw["spread"] = (tuple(t(a) for a in x["spread"])
                    if "spread" in x else None)
    return kw


def assert_wave_same(got, want):
    for c in ("n_feas", "n_exh", "grp_any", "dim_exh"):
        np.testing.assert_array_equal(np.asarray(got[c]), want[c], c)
    for s_key, i_key in (("score", None), ("top_score", "top_idx"),
                         ("tab_s", "tab_i")):
        if s_key not in want:
            assert s_key not in got
            continue
        gs = np.asarray(got[s_key])
        assert gs.shape == want[s_key].shape, s_key
        np.testing.assert_array_max_ulp(gs, want[s_key], maxulp=4)
        if i_key is not None:
            np.testing.assert_array_equal(np.asarray(got[i_key]),
                                          want[i_key], i_key)


CASES = [
    # name, shape kwargs, call kwargs
    ("score-single-tile", dict(Gp=8, Np=64), dict(mode="score", TK=20)),
    ("score-multi-tile-dev-blocked",
     dict(Gp=256, Np=2048, D=2, blocked=True), dict(mode="score", TK=36)),
    ("topk-single-tile", dict(Gp=8, Np=64, S=0),
     dict(mode="topk", TK=20)),
    ("topk-extract-wider", dict(Gp=8, Np=256, D=1),
     dict(mode="topk", TK=36, n_extract=128)),
    ("topk-tables-multi-tile",
     dict(Gp=256, Np=2048, V=4, blocked=True),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ("topk-tables-unseeded", dict(Gp=4, Np=128, V=8, wave_seed=0),
     dict(mode="topk", TK=36, tables_v=8)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,call", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_gpu(name, shape, call):
    """The CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                    "or interpret mode)")
    x = make_inputs(len(name), **shape)
    kw = port_kwargs(x, "cuda")
    before = wk.fused_wave.launches
    got = wk.fused_wave(**kw, **call)
    want = wk.fused_wave_plain(**kw, **call)
    torch.cuda.synchronize()
    assert wk.fused_wave.launches == before + 1
    assert_wave_same({k: v.cpu() for k, v in got.items()},
                     {k: v.cpu().numpy() for k, v in want.items()})
