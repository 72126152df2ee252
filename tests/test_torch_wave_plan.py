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
    out += MESH
    return out


#: a mesh shard's shapes (chip_smoke.py phase 11: 50,176 padded nodes
#: over 8 shards, 6,272 a shard, not a power of two): L0's rich solve
#: (topk with tables), L1's stream (topk over the shortlist, and the
#: pinned score mode), the elastic layout's 8,192 slots, and a
#: 5,120-node cluster on 8 shards (640)
MESH = [("topk", dict(Gp=1, Np=6272, NE=132, TK=132, tables_v=2)),
        ("topk", dict(Gp=1, Np=6272, NE=256, TK=132, tables_v=0)),
        ("score", dict(Gp=1, Np=6272, TK=132, NE=256)),
        ("score", dict(Gp=1, Np=8192, TK=132, NE=256)),
        ("score", dict(Gp=4, Np=640, TK=68, NE=128)),
        ("topk", dict(Gp=4, Np=640, NE=128, TK=68, tables_v=4))]


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


@pytest.mark.parametrize("mode,shape", MESH,
                         ids=[f"{m}-{s['Gp']}x{s['Np']}" for m, s in MESH])
def test_mesh_shard_widths_cover_the_ragged_edge(mode, shape):
    """At a shard width that is no multiple of the stripe or tile, the
    last stripe / tile is partial: the grid still covers every node
    exactly once and the last tile's lists are cut to its length."""
    p = plan_of(mode, shape)
    Np = shape["Np"]
    if mode == "score":
        assert p["grid"][0] == -(-Np // p["stripe"])
        assert Np % p["stripe"] == 0 or \
            (p["grid"][0] - 1) * p["stripe"] < Np < p["grid"][0] * p["stripe"]
        return
    T = p["tile"]
    last = Np - (p["n_tiles"] - 1) * T
    assert 0 < last <= T and p["n_tiles"] * T >= Np
    assert p["partial_widths"][-1] == min(p["TKt"], last)
    assert sum(min(T, Np - t * T) for t in range(p["n_tiles"])) == Np
