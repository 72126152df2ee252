"""The port's profiler ranges and sync counters, on the CPU.

Under `torch.profiler` a solve opens a `nomad.solve.prologue` range from
its entry to its first wave, and the wave loop `nomad.wave.full` /
`nomad.wave.carried` ranges and, around each host sync, a
`nomad.wave.sync` range (`utils.tracing`).  They must nest on their
thread, count what the solver reports (`last_waves`, `n_syncs`), leave
the answers as they are, and cost nothing without a profiler.  Each
device dispatch, of a `ResidentSolver` or of a worker's `Solver`, folds
its waves, full passes and syncs into the process registry
(`solver.waves`, `solver.waves_full`, `solver.syncs`), which /v1/metrics
serves.
"""
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from test_torch_resident import SIDES, make_ask, make_nodes, probes
from nomad_tpu_torch.solver.solve import (Solver, _run_kernel, _to_host,
                                          solve_trace_attrs)
from nomad_tpu_torch.utils import tracing
from nomad_tpu_torch.utils.metrics import global_metrics

PORT = SIDES[1]
WAVES = (tracing.WAVE_FULL, tracing.WAVE_CARRIED)
PROLOGUE = tracing.SOLVE_PROLOGUE
COUNTERS = ("solver.waves", "solver.waves_full", "solver.syncs")


@pytest.fixture(autouse=True)
def _serial_defaults(monkeypatch):
    for k in ("NOMAD_TPU_SHORTLIST_C", "NOMAD_TPU_FUSED_LANES",
              "NOMAD_TPU_DELTA_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)


def solver(n_nodes=48):
    """A tight cluster, so that batches take several waves and the
    carried shortlist."""
    return PORT.solver(make_nodes(PORT, n_nodes, cpu=4000, mem=8192),
                       probes(PORT), gp=4, kp=64)


def chunks(tag, n=3):
    return [[make_ask(PORT, f"{tag}a{b}", 40, cpu=1500),
             make_ask(PORT, f"{tag}b{b}", 16, cpu=900, spread=b == 1)]
            for b in range(n)]


def traced(fn):
    """fn()'s result and the `nomad.` ranges it opened, (start, end,
    name) by start, outer first."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    rows = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.name.startswith("nomad.")]
    return out, sorted(rows, key=lambda r: (r[0], -r[1]))


def parents(rows):
    """(name, innermost enclosing range's name or None) of each range,
    asserting that no two ranges overlap without one holding the
    other."""
    stack, out = [], []
    for a, b, name in rows:
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            assert b <= stack[-1][1], (name, stack[-1][2])
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def counters():
    c = global_metrics.dump()["counters"]
    return {k: c.get(k, 0.0) for k in COUNTERS}


def advance(before):
    after = counters()
    return {k: after[k] - before[k] for k in COUNTERS}


def total(x):
    return int(sum(int(np.sum(v)) for v in x))


def pipelined(rs, tag):
    def pack(asks):
        merged, keys = rs.merge_asks(asks)
        return rs.pack_batch_cached(merged, job_keys=keys)
    rs.reset_usage()
    out = rs.solve_stream_pipelined(chunks(tag), seeds=[7, 8, 9],
                                    pack=pack)
    return out, rs.usage()[0]


def test_device_range_is_the_null_span_without_a_profiler():
    """Off: the helper hands back the shared null span.  On: a host op,
    not a user annotation (for which a CUDA trace would add a device
    event spanning the range's kernels, counted as device time)."""
    assert tracing.device_range(tracing.WAVE_SYNC) is tracing.NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rng = tracing.device_range(tracing.WAVE_SYNC)
        assert rng is not tracing.NULL_SPAN
        with rng:
            pass
    assert tracing.device_range(tracing.WAVE_SYNC) is tracing.NULL_SPAN
    ev = [e for e in prof.events() if e.name == tracing.WAVE_SYNC]
    assert len(ev) == 1 and not ev[0].is_user_annotation


def test_pipelined_stream_wave_ranges_nest_and_count_the_solve():
    """wave > sync: one prologue range a solve and one wave range a
    wave by kind, each at the top of its thread's ranges, and one sync
    range a counted sync, each inside a wave (the first wave's entry
    test is known on the host, and the seed's constants cross no more);
    the counters and the pipeline's stats advance by the same amounts."""
    rs = solver()
    before = counters()
    _, rows = traced(lambda: pipelined(rs, "p"))
    moved = advance(before)
    tree = parents(rows)
    names = [n for n, _ in tree]
    waves, syncs = total(rs.last_waves), total(rs.last_syncs)
    full = total(rs.last_rescore_waves)
    assert set(names) <= {*WAVES, tracing.WAVE_SYNC, PROLOGUE}
    assert names.count(PROLOGUE) == 3
    assert names.count(tracing.WAVE_FULL) == full
    assert names.count(tracing.WAVE_CARRIED) == waves - full > 0
    assert names.count(tracing.WAVE_SYNC) == syncs > waves
    for name, parent in tree:
        assert parent in ({None} if name in (*WAVES, PROLOGUE)
                          else {None, *WAVES}), (name, parent)
    # a wave's range runs on to the next wave's decision, so no sync
    # lies outside every wave
    outside = [n for n, p in tree if n == tracing.WAVE_SYNC and p is None]
    assert outside == []
    st = rs.last_pipeline_stats
    assert (st["waves"], st["syncs"]) == (waves, syncs)
    assert (st["waves_graphed"], st["graph_captures"]) == (0, 0)
    assert st["n_dispatches"] == 3 and st["pack_s"] > 0
    assert moved == {"solver.waves": waves, "solver.waves_full": full,
                     "solver.syncs": syncs}
    assert rs.trace_attrs()["syncs_total"] == syncs


def test_answers_are_the_same_with_and_without_a_profiler():
    rs = solver()
    plain, used = pipelined(rs, "q")
    plain_counts = (rs.last_waves, rs.last_syncs)
    (prof, used_p), rows = traced(lambda: pipelined(rs, "q"))
    assert rows
    for a, b in zip(plain, prof):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(used, used_p)
    assert (rs.last_waves, rs.last_syncs) == plain_counts


def test_lane_stream_opens_one_wave_range_a_lock_stepped_wave():
    """Lanes in lock-step open no ranges of their own: solve_lanes opens
    one wave range for each wave of a chunk of lanes, which lasts as
    long as its longest lane; the lanes' syncs still count."""
    rs = solver()
    batches = [rs.pack_batch(c) for c in chunks("l", 4)]
    before = counters()
    _, rows = traced(lambda: rs.solve_stream_async(
        batches, seeds=[1, 2, 3, 4], lanes=2))
    moved = advance(before)
    tree = parents(rows)
    names = [n for n, _ in tree]
    waves = np.asarray(rs.last_waves)
    assert sum(names.count(w) for w in WAVES) == \
        int(waves.reshape(2, 2).max(axis=1).sum()) > 0
    assert tracing.WAVE_SYNC not in names
    assert moved["solver.waves"] == waves.sum()
    assert moved["solver.syncs"] == total(rs.last_syncs) > waves.sum()


def test_parallel_stream_counts_its_waves_and_syncs():
    rs = solver()
    batches = [rs.pack_batch(c) for c in chunks("r", 2)]
    before = counters()
    _, rows = traced(lambda: rs.solve_parallel(batches))
    moved = advance(before)
    names = [n for n, _ in parents(rows)]
    assert moved["solver.waves"] == sum(n in WAVES for n in names) > 0
    assert moved["solver.syncs"] == names.count(tracing.WAVE_SYNC)


def test_solve_span_attributes_carry_the_syncs():
    """A stream's `trace_attrs` and a device solve's span attributes
    (the server's `solve` span) carry the syncs: one read of each
    wave's flags at least, and no graphed wave on the CPU."""
    rs = solver()
    rs.solve_stream([rs.pack_batch(chunks("s", 1)[0])], seeds=[3])
    assert rs.trace_attrs()["syncs_total"] == int(rs.last_syncs[0]) > 0
    pb = rs.pack_batch(chunks("t", 1)[0])
    res = _to_host(_run_kernel(pb, "cpu", host_mode="never"))
    attrs = solve_trace_attrs(pb, res, "cpu")
    assert attrs["syncs"] == res.n_syncs >= attrs["waves"] > 0
    assert attrs["graphed"] == attrs["captures"] == 0


def test_worker_solver_folds_its_device_solves_only():
    """A worker's `Solver` folds each device solve's counts as its span
    attributes give them, once the result is fetched; a solve that the
    host twin answers folds nothing."""
    nodes = make_nodes(PORT, 32, cpu=4000, mem=8192)
    asks = [make_ask(PORT, "wa", 24, cpu=1500),
            make_ask(PORT, "wb", 12, cpu=900, spread=True)]
    before = counters()
    out = Solver(device="cpu", host="never").solve(nodes, asks)
    moved = advance(before)
    t = out.trace
    assert t["backend"] == "device"
    assert moved == {"solver.waves": t["waves"],
                     "solver.waves_full": t["rescore_waves"],
                     "solver.syncs": t["syncs"]}
    assert t["syncs"] >= t["waves"] > 0
    before = counters()
    out = Solver(device="cpu", host="always").solve(nodes, asks)
    assert out.trace["backend"] == "host"
    assert advance(before) == dict.fromkeys(COUNTERS, 0.0)


def test_what_if_solve_chrome_trace_carries_the_wave_ranges(tmp_path):
    """The solver profile's artifact: a what-if solve of a worker's plan
    view on the device route, profiled on its own thread and exported
    as a Chrome trace, holds its waves' and syncs' ranges."""
    nodes = make_nodes(PORT, 32, cpu=4000, mem=8192)
    asks = [make_ask(PORT, "pa", 24, cpu=1500)]
    view = Solver(device="cpu", host="never").plan_view()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = view.solve(nodes, asks)
    path = tmp_path / "solver.trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name") for e in
             json.loads(path.read_text())["traceEvents"]]
    assert sum(n in WAVES for n in names) == out.trace["waves"] > 0
    assert names.count(tracing.WAVE_SYNC) == out.trace["syncs"]
