"""The wave loop's CUDA-graph path (`solver/wave_graph.py`), on the CPU.

A CPU solve never captures: its waves run op by op, and the counters of
graphed waves and captures stay 0.  With `wave_graph.EMULATE` the graph
path runs here all the same (the plan's buffers, the per-solve copies,
the stretches' commits and the result's clones), a replay re-running
the captured function: a signature's first solve runs eagerly, its
second captures, later ones replay, and every answer equals the eager
path's.  The card's own captures are held to the same answers by
`tests/test_torch_wave_graph_gpu.py`.
"""
import numpy as np
import pytest
import torch

from test_torch_resident import SIDES, make_ask, make_nodes, probes
from nomad_tpu_torch.solver import resident as port_resident
from nomad_tpu_torch.solver import wave_graph
from nomad_tpu_torch.utils.metrics import global_metrics

PORT = SIDES[1]
COUNTERS = ("solver.waves", "solver.waves_graphed", "solver.graph_captures")


@pytest.fixture(autouse=True)
def _fresh_plans(monkeypatch):
    for k in ("NOMAD_TPU_SHORTLIST_C", "NOMAD_TPU_FUSED_LANES",
              "NOMAD_TPU_DELTA_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    wave_graph.PLANS.clear()
    yield
    wave_graph.PLANS.clear()


def solver(pallas="score", n_nodes=48):
    """A tight cluster, so that batches take several waves."""
    return PORT.solver(make_nodes(PORT, n_nodes, cpu=4000, mem=8192),
                       probes(PORT), gp=4, kp=64, pallas=pallas)


def batches(rs, tag, n=3, spread=True):
    """n batches of one signature: the same padded shapes, other asks,
    placement counts and seeds."""
    out = []
    for b in range(n):
        asks = [make_ask(PORT, f"{tag}a{b}", 30 + 4 * b, cpu=1500),
                make_ask(PORT, f"{tag}b{b}", 12 + b, cpu=900,
                         spread=spread and b == 1)]
        out.append(rs.pack_batch(asks))
    return out


def stream(rs, pbs, seeds):
    """The stream's answers and counts, from the seeded usage."""
    rs.reset_usage()
    out = rs.solve_stream(pbs, seeds=seeds)
    return {"out": out, "usage": rs.usage(),
            "waves": [int(w) for w in rs.last_waves],
            "syncs": [int(s) for s in rs.last_syncs],
            "graphed": [int(g) for g in rs.last_graphed],
            "captures": [int(c) for c in rs.last_captures]}


def assert_same(a, b):
    for x, y in zip(a["out"] + a["usage"], b["out"] + b["usage"]):
        np.testing.assert_array_equal(x, y)
    assert (a["waves"], a["syncs"]) == (b["waves"], b["syncs"])


def counters():
    c = global_metrics.dump()["counters"]
    return {k: c.get(k, 0.0) for k in COUNTERS}


def test_cpu_solve_never_captures():
    """On the CPU the graph path never engages, with the fused wave
    kernel's plain twin as with the torch scorer: no plan, no capture,
    no graphed wave, and the registry's counters of them stay 0."""
    for pallas in ("score", "off"):
        rs = solver(pallas)
        pbs = batches(rs, pallas)
        before = counters()
        for seeds in ([1, 2, 3], [4, 5, 6]):
            got = stream(rs, pbs, seeds)
            assert got["graphed"] == got["captures"] == [0, 0, 0]
        after = counters()
        assert after["solver.waves"] > before["solver.waves"]
        for k in ("solver.waves_graphed", "solver.graph_captures"):
            assert after[k] == before[k]
        assert len(wave_graph.PLANS) == 0


@pytest.mark.parametrize("pallas,spread", [("score", False),
                                           ("score", True),
                                           ("topk", True)])
def test_emulated_graph_waves_equal_the_eager_waves(monkeypatch, pallas,
                                                    spread):
    """The same stream three times from a fresh cache: the signature's
    first solve eager, the second capturing, the rest replaying, each
    with its own seed and placement count, equal to the eager path in
    every answer, usage, wave and sync count."""
    rs = solver(pallas)
    pbs = batches(rs, "e", spread=spread)
    eager = [stream(rs, pbs, s) for s in ([11, 12, 13], [0, 7, 8])]
    monkeypatch.setattr(wave_graph, "EMULATE", True)
    first = stream(rs, pbs, [11, 12, 13])
    assert first["graphed"][0] == first["captures"][0] == 0
    assert first["graphed"][1:] == first["waves"][1:]
    assert first["captures"][1] > 0
    assert_same(first, eager[0])
    again = stream(rs, pbs, [11, 12, 13])
    assert again["graphed"] == again["waves"]
    assert_same(again, eager[0])
    # a seed of 0 is another signature: seen once, then captured
    other = stream(rs, pbs, [0, 7, 8])
    assert other["graphed"][0] == 0
    assert_same(other, eager[1])


def test_emulated_results_hold_no_buffer(monkeypatch):
    """Results held at once stay as they were: a solve's result never
    aliases its plan's buffers, which the next solve rewrites."""
    monkeypatch.setattr(wave_graph, "EMULATE", True)
    rs = solver()
    pbs = batches(rs, "h")

    def solve(pb, seed):
        return port_resident._solve_one(
            rs._dev_node, rs._used, rs._dev_used,
            port_resident._batch(rs._stack_args([pb]), 0), pb.n_place,
            seed, **rs._solve_kw(pbs, False))
    held = [solve(pb, s) for pb, s in zip(pbs * 2, [3, 4, 5, 6, 7, 8])]
    assert [r.n_graphed > 0 for r in held] == [False] + [True] * 5
    monkeypatch.setattr(wave_graph, "EMULATE", False)
    for r, pb, s in zip(held, pbs * 2, [3, 4, 5, 6, 7, 8]):
        e = solve(pb, s)
        for name in ("choice", "choice_ok", "score", "n_feasible",
                     "n_exhausted", "dim_exhausted", "used_final",
                     "dev_used_final", "unfinished"):
            np.testing.assert_array_equal(getattr(r, name),
                                          getattr(e, name), err_msg=name)
        assert (r.n_waves, r.n_rescore, r.n_syncs) == (
            e.n_waves, e.n_rescore, e.n_syncs)
    (plan,) = wave_graph.PLANS._plans.values()
    bufs = {t.untyped_storage().data_ptr() for t in wave_graph.leaves(
        [plan.bufs.c, plan.bufs.st, plan.bufs.mid,
         plan.bufs.kout, plan.bufs.wave_t])}
    for r in held:
        for t in wave_graph.leaves(tuple(r)):
            assert t.untyped_storage().data_ptr() not in bufs


def test_lanes_in_lock_step_stay_eager(monkeypatch):
    """Lanes in lock-step would share the carry: a lane stream runs its
    waves op by op even where graphs engage."""
    monkeypatch.setattr(wave_graph, "EMULATE", True)
    rs = solver()
    pbs = batches(rs, "l", n=4)
    for _ in range(3):
        rs.solve_stream_async(pbs, seeds=[1, 2, 3, 4], lanes=2)
        assert list(rs.last_graphed) == [0, 0, 0, 0]
    assert len(wave_graph.PLANS) == 0


def test_plans_sight_capture_and_evict():
    """A signature's first sighting gives no plan, its second builds
    one; a plan serves one solve at a time; the cache keeps PLANS_MAX
    plans, the least recently used dropped first."""
    plans = wave_graph.Plans()
    cpu = torch.device("cpu")

    def make():
        return wave_graph.Plan(cpu, None)
    assert plans.sight("a", make) is None
    p = plans.sight("a", make)
    assert p is not None
    assert plans.sight("a", make) is None         # held by a solve
    p.release()
    assert plans.sight("a", make) is p
    p.release()
    for i in range(wave_graph.PLANS_MAX + 2):
        plans.sight(i, make)
        plans.sight(i, make).release()
    assert len(plans) == wave_graph.PLANS_MAX
    assert plans.sight("a", make) is None         # evicted: seen anew
    assert plans.sight("a", make) is not p


def test_copy_nest_orders_overlapping_copies():
    """A commit whose source is another target's old value copies that
    value first: the copies run in any order."""
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    wave_graph.copy_nest((a, b), (b, a))
    assert (a.item(), b.item()) == (2.0, 1.0)
    with pytest.raises(ValueError):
        wave_graph.copy_nest((a, b), (a,))
