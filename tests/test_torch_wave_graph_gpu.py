"""The wave loop's CUDA graphs on the card: a single-lane solve's first
sighting of a signature runs eagerly, its second captures the wave's
fixed-shape stretches, later ones replay them, and every `SolveResult`
field equals the eager solve's.  Replays with another seed, placement
count and wave count, after `apply_delta` and after `repack`, held at
once, and under the profiler.  These tests import neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wave_graph_gpu.py

Without a GPU they skip (graphs are captured on a CUDA device only)."""
import re

import numpy as np
import pytest
import torch

from test_torch_resident_gpu import make_ask, make_nodes
from nomad_tpu_torch import mock
from nomad_tpu_torch.solver import resident as res_mod
from nomad_tpu_torch.solver import wave_graph
from nomad_tpu_torch.solver import wave_kernel as wk
from nomad_tpu_torch.solver.kernel import solve_lanes
from nomad_tpu_torch.solver.resident import ResidentSolver
from nomad_tpu_torch.solver.tensorize import ClusterDelta

FIELDS = ("choice", "choice_ok", "score", "n_feasible", "n_exhausted",
          "dim_exhausted", "feas", "cons_filtered", "used_final",
          "dev_used_final", "n_waves", "unfinished", "n_rescore",
          "n_syncs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs are captured on a "
                    "CUDA device only)")
    wave_graph.PLANS.clear()
    yield
    wave_graph.PLANS.clear()


def solver(n_nodes, gp, kp, pallas):
    return ResidentSolver(make_nodes(n_nodes),
                          [make_ask("probe", 4, spread=True)], gp=gp, kp=kp,
                          pallas=pallas, device="cuda")


def solve(rs, pb, seed, graphs, kw):
    """One single-lane solve of `pb` against the solver's usage, with
    the graph path allowed or not."""
    return solve_lanes([res_mod._solve_steps(
        rs._dev_node, rs._used, rs._dev_used,
        res_mod._batch(rs._stack_args([pb]), 0), pb.n_place, seed,
        single_lane=graphs, **kw)])[0]


def assert_same(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), name
        else:
            assert x == y, name


def chunks(rs, tag, counts, n_asks=1):
    """Batches of one signature: `n_asks` asks each, other counts."""
    return [rs.pack_batch([make_ask(f"{tag}{b}a{a}", c // n_asks,
                                    cpu=600 + 40 * a)
                           for a in range(n_asks)])
            for b, c in enumerate(counts)]


def three_ways(rs, pb, seed, kw):
    """Eager, capture, replay from a fresh cache, each against the same
    usage."""
    wave_graph.PLANS.clear()
    out = [solve(rs, pb, seed, True, kw) for _ in range(3)]
    assert [r.n_graphed for r in out] == [0] + [out[0].n_waves] * 2
    assert out[0].n_captures == 0 and out[1].n_captures > 0
    assert out[2].n_captures == 0
    assert_same(out[0], out[1])
    assert_same(out[0], out[2])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", ["score", "topk"])
def test_stream_chunk_eager_capture_replay(cuda, pallas):
    """The c2-stream chunk's shape cut to 1,024 nodes: one group, 4,096
    placements (the sort-based conflict path), several waves; the
    fused kernel still launches once a full pass through
    `wave_kernel.fused_wave`.  A replay with another seed and placement
    count (and so another wave count) equals that solve's eager run."""
    rs = solver(1000, 1, 4096, pallas)
    pbs = chunks(rs, "s", [3600, 2200])
    kw = rs._solve_kw(pbs, False)
    before = wk.fused_wave.launches
    out = three_ways(rs, pbs[0], 3210000011, kw)
    assert wk.fused_wave.launches - before == 3 * out[0].n_rescore
    assert out[0].n_waves >= 2
    eager = solve(rs, pbs[1], 77, False, kw)
    replay = solve(rs, pbs[1], 77, True, kw)
    assert replay.n_graphed == replay.n_waves
    assert pbs[1].n_place != pbs[0].n_place
    assert_same(eager, replay)


@pytest.mark.cuda
def test_constrained_shape_on_conflict_kernels(cuda):
    """The c3-stream chunk's shape cut to 4,000 nodes: 4 groups with a
    datacenter spread, 8,192 placements a wave, so the conflict check
    and the commits run on the node-segmented kernels (`seg_kernel`)
    inside the captured body.  Eager, capture and replay place alike,
    every wave counts in `n_conflict_kernel`, a replay counts the
    kernels' launches as the eager solve does, and a pipelined stream
    folds the waves into `solver.waves_conflict_kernel`."""
    from nomad_tpu_torch.solver import seg_kernel as sk
    from nomad_tpu_torch.utils.metrics import global_metrics
    rs = ResidentSolver(make_nodes(4000),
                        [make_ask("probe", 4, spread=True)], gp=4, kp=8192,
                        pallas="score", device="cuda")

    def chunk(tag):
        return rs.pack_batch([make_ask(f"{tag}{a}", 2048, cpu=600 + 40 * a,
                                       spread=True) for a in range(4)])
    pb = chunk("c")
    kw = rs._solve_kw([pb], False)
    out = three_ways(rs, pb, 3240000001, kw)
    assert out[0].n_waves >= 2
    assert all(r.n_conflict_kernel == r.n_waves for r in out)
    launched = []
    for graphs in (False, True):
        before = sk.LAUNCHES.copy()
        again = solve(rs, pb, 3240000001, graphs, kw)
        torch.cuda.synchronize()
        assert again.n_graphed == (again.n_waves if graphs else 0)
        launched.append(sk.LAUNCHES - before)
    # usage and the node marks a wave at least
    assert launched[0] == launched[1]
    assert launched[0]["commit"] >= 2 * out[0].n_waves
    counters = global_metrics.dump()["counters"]
    c0 = {n: counters.get(n, 0)
          for n in ("solver.waves", "solver.waves_conflict_kernel")}
    rs.solve_stream_pipelined([chunk("p"), chunk("q")], seeds=[1, 2])
    st = rs.last_pipeline_stats
    assert st["waves_conflict_kernel"] == st["waves"] > 0
    counters = global_metrics.dump()["counters"]
    assert (counters["solver.waves_conflict_kernel"]
            - c0["solver.waves_conflict_kernel"]
            == counters["solver.waves"] - c0["solver.waves"])


@pytest.mark.cuda
def test_fused_round_shape_eager_capture_replay(cuda):
    """A fused round's shape: 40 groups on 2,048 nodes, "score" mode."""
    rs = solver(2000, 64, 1024, "score")
    (pb,) = chunks(rs, "f", [800], n_asks=40)
    three_ways(rs, pb, 5, rs._solve_kw([pb], False))


@pytest.mark.cuda
def test_replays_after_delta_and_repack(cuda):
    """A delta changes the resident planes in place and a repack moves
    them: the graphs read the solve's copies, so replays stay equal to
    the eager solves."""
    rs = solver(1000, 1, 4096, "score")
    pbs = chunks(rs, "d", [3000, 2600])
    kw = rs._solve_kw(pbs, False)
    three_ways(rs, pbs[0], 9, kw)
    d = ClusterDelta()
    for k in range(64):
        a = mock.alloc()
        a.id = f"d-{k}"
        tr = a.allocated_resources.tasks["web"]
        tr.cpu, tr.memory_mb, tr.networks = 1500, 2048, []
        a.allocated_resources.shared.networks = []
        d.place.append((rs.template.node_ids[k * 7], a))
    assert rs.apply_delta(d) == "delta"
    assert_same(solve(rs, pbs[1], 10, False, kw),
                solve(rs, pbs[1], 10, True, kw))
    rs.repack()
    pbs = chunks(rs, "r", [3000, 2600])
    kw = rs._solve_kw(pbs, False)
    eager = solve(rs, pbs[1], 11, False, kw)
    replay = solve(rs, pbs[1], 11, True, kw)
    assert replay.n_graphed == replay.n_waves
    assert_same(eager, replay)


@pytest.mark.cuda
def test_results_held_at_once_and_profiled_replay(cuda):
    """Two graphed solves held at once keep their own answers (a result
    never aliases the plan's buffers); a replay under the profiler gives
    the same answers and its kernels reach the trace."""
    from torch.profiler import ProfilerActivity, profile
    rs = solver(1000, 1, 4096, "score")
    pbs = chunks(rs, "h", [3400, 2000])
    kw = rs._solve_kw(pbs, False)
    three_ways(rs, pbs[0], 1, kw)
    held = [solve(rs, pb, s, True, kw) for pb, s in zip(pbs, (21, 22))]
    assert all(r.n_graphed == r.n_waves for r in held)
    for r, pb, s in zip(held, pbs, (21, 22)):
        assert_same(r, solve(rs, pb, s, False, kw))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = solve(rs, pbs[0], 21, True, kw)
        torch.cuda.synchronize()
    assert traced.n_graphed == traced.n_waves
    assert_same(traced, held[0])
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(re.search(r"wave_\w+_kernel", n) for n in names)
    assert len(names) > 10 * traced.n_waves


@pytest.mark.cuda
def test_stream_counts_its_graphed_waves(cuda):
    """A pipelined stream of one signature: the first chunk eager, the
    rest replayed; `last_pipeline_stats` and the registry count them."""
    from nomad_tpu_torch.utils.metrics import global_metrics
    rs = solver(1000, 1, 4096, "score")
    pbs = chunks(rs, "p", [3000, 3100, 3200, 3300])
    c0 = global_metrics.dump()["counters"].get("solver.waves_graphed", 0)
    rs.solve_stream_pipelined(pbs, seeds=[1, 2, 3, 4])
    st = rs.last_pipeline_stats
    waves = [int(np.asarray(w)[0]) for w in rs.last_waves]
    assert st["waves_graphed"] == sum(waves[1:])
    assert st["graph_captures"] > 0
    c1 = global_metrics.dump()["counters"]["solver.waves_graphed"]
    assert c1 - c0 == st["waves_graphed"]
