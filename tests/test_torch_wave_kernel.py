"""The fused wave kernel's plain torch version (`fused_wave_plain`)
against the JAX package's Pallas `fused_wave`, which runs in Pallas
interpret mode on the CPU: score mode, topk mode, per-value tables,
single- and multi-tile layouts, `n_extract > TK`, device and blocked
planes.  Counters and indices exact, scores within 4 ulp (the
reference's own cross-backend bound for 10**x).

The CUDA kernel itself runs only on a GPU: test_torch_wave_kernel_gpu.py
holds it against the plain version there, on the same cases."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wave_kernel_gpu import (CASES, assert_wave_same,
                                        make_inputs, port_kwargs)

from nomad_tpu.solver import masks as ref_masks
from nomad_tpu.solver import pallas_kernel as PK
from nomad_tpu_torch.solver import wave_kernel as wk


def run_ref(x, **call):
    kw = {k: v for k, v in x.items() if k not in ("dev", "spread")}
    for k in ("feas", "pen", "blocked"):
        if kw[k] is not None:
            kw[k] = jnp.asarray(ref_masks.np_pack_bool_u32(kw[k]))
    for k in ("aff", "jitter", "coll", "used", "avail", "reserved",
              "ask_res", "ask_desired"):
        kw[k] = jnp.asarray(kw[k])
    kw["dev"] = (tuple(jnp.asarray(a) for a in x["dev"])
                 if "dev" in x else None)
    if "spread" in x:
        sp = list(x["spread"])
        sp[0] = sp[0].astype(np.int32)       # the reference kernel's type
        kw["spread"] = tuple(jnp.asarray(a) for a in sp)
    kw["seed"] = jnp.int32(x["seed"])
    out = PK.fused_wave(**kw, **call)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name,shape,call", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_reference_fused_wave(name, shape, call):
    x = make_inputs(len(name), **shape)
    want = run_ref(x, **call)
    got = wk.fused_wave_plain(**port_kwargs(x), **call)
    assert_wave_same(got, want)


def test_multi_tile_case_is_multi_tile():
    """The reference really tiles the large cases (and not the small)."""
    assert PK.pick_tile(2048, 256) < 2048
    assert PK.pick_tile(64, 8) == 64


def test_wrapper_routes_cpu_tensors_to_plain_without_counting():
    x = make_inputs(5, Gp=4, Np=64)
    kw = port_kwargs(x)
    before = wk.fused_wave.launches
    got = wk.fused_wave(mode="topk", TK=12, **kw)
    want = wk.fused_wave_plain(mode="topk", TK=12, **kw)
    assert wk.fused_wave.launches == before
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_resolve_mode_matches_reference():
    for args in ((64, 4, 36, 4, True), (10240, 4, 36, 4, True),
                 (10240, 128, 260, 4, True), (1024, 8, 36, 32, True),
                 (1024, 8, 36, 32, False), (96, 2, 36, 4, False)):
        assert (wk.resolve_mode(*args, on=True)
                == PK.resolve_mode(*args, enabled_hint=True)), args
        assert wk.resolve_mode(*args, on=False) == "off"
