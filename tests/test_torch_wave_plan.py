"""The CUDA fused wave's launch plan (`wave_kernel.launch_plan`), checked
on the CPU: the geometry the kernels get at the main path's shapes and at
the shapes of the GPU tests.  No GPU and no JAX needed."""
import pytest
from test_torch_wave_kernel_gpu import CASES

from nomad_tpu_torch.solver import wave_kernel as wk

#: the main path's two shapes (chip_smoke.py phase 3 and 4)
MAIN = [("topk", dict(Gp=4, Np=10240, NE=128, TK=36, tables_v=4)),
        ("score", dict(Gp=128, Np=10240, TK=260, NE=384))]


def shapes():
    out = list(MAIN)
    for name, shape, call in CASES:
        Vs = call.get("tables_v", 0)
        out.append((call["mode"], dict(
            Gp=shape["Gp"], Np=shape["Np"],
            NE=call.get("n_extract", 0) or call["TK"], TK=call["TK"],
            tables_v=Vs)))
    # wider shortlists and clusters than the smoke drives
    out += [("topk", dict(Gp=4, Np=10240, NE=1024, TK=256, tables_v=16)),
            ("topk", dict(Gp=1, Np=102400, NE=256, TK=256, tables_v=4)),
            ("score", dict(Gp=1, Np=64, TK=4, NE=4))]
    return out


def plan_of(mode, s):
    return wk.launch_plan(mode, s["Gp"], s["Np"], NE=s["NE"], TK=s["TK"],
                          tables_v=s["tables_v"] if mode == "topk" else 0)


@pytest.mark.parametrize("mode,shape", shapes(),
                         ids=[f"{m}-{s['Gp']}x{s['Np']}-{s['NE']}"
                              for m, s in shapes()])
def test_plan_fits_the_card(mode, shape):
    p = plan_of(mode, shape)
    assert p["smem"] <= wk.SMEM_LIMIT
    gx, gy = p["grid"]
    if mode == "score":
        assert 1 <= p["groups_per_block"] <= wk.SCORE_MAX_GB
        assert gx * p["stripe"] >= shape["Np"]
        assert gy * p["groups_per_block"] >= shape["Gp"]
        assert (gy - 1) * p["groups_per_block"] < shape["Gp"]
        return
    assert p["merge_smem"] <= wk.SMEM_LIMIT
    assert p["tile"] == wk.TOPK_TILE and gy == shape["Gp"]
    assert gx == p["n_tiles"] and (gx - 1) * p["tile"] < shape["Np"] \
        <= gx * p["tile"]
    assert 1 <= p["merge_batch"] <= p["n_tiles"]
    assert p["merge_smem"] == (p["merge_batch"] + 1) * (
        16 * p["merge_width"] + 8)
    NE = shape["NE"]
    for t, width in enumerate(p["partial_widths"]):
        Tt = min(p["tile"], shape["Np"] - t * p["tile"])
        assert width >= min(NE, Tt)
    if shape["tables_v"]:
        assert p["merge_grid"] == (shape["Gp"], shape["tables_v"] + 2)
        for t, width in enumerate(p["table_partial_widths"]):
            Tt = min(p["tile"], shape["Np"] - t * p["tile"])
            assert width >= min(p["TKv"], Tt)


def test_topk_grid_fills_the_card_on_the_main_path():
    p = wk.launch_plan("topk", 4, 10240, NE=128, TK=36, tables_v=4)
    gx, gy = p["grid"]
    assert gx * gy >= wk.N_SMS
    assert p["merge_batch"] == p["n_tiles"]      # one merge batch


def test_score_grid_on_the_main_path():
    p = wk.launch_plan("score", 128, 10240, NE=384, TK=260)
    gx, gy = p["grid"]
    assert gx * gy >= wk.N_SMS
    assert p["groups_per_block"] > 1             # node rows are reused


def test_topk_row_wider_than_the_merge_raises():
    with pytest.raises(ValueError, match="at most"):
        wk.launch_plan("topk", 1, 1 << 20, NE=wk.MERGE_MAX_WIDTH + 1,
                       TK=256)


def test_merge_width_covers_every_row():
    for NE, TK, Vs in ((4, 4, 0), (36, 36, 4), (128, 36, 4), (300, 36, 4),
                       (1024, 256, 16), (20, 200, 1)):
        p = wk.launch_plan("topk", 4, 10240, NE=NE, TK=TK, tables_v=Vs)
        w = p["merge_width"]
        assert w >= max(p["NE"], p["TKv"], 32) and w & (w - 1) == 0


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        wk.launch_plan("bogus", 4, 1024)
