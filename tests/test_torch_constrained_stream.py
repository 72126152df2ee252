"""The constrained resident stream (the benchmark's `c3-stream` cell) on
the CPU at a small size, and the solve's prologue range and its
`solver.solves` / `solver.pairs_filtered` counters.

The cell's entry (`benchmark/drivers/stream_constrained.py`) runs the
port's `ResidentSolver` stream on the config-3 job (two constraints, a
rack affinity, a datacenter spread) and judges one pass with the plain
NumPy reference (`benchmark/reference/stream_constrained.py`).  The cell
is cut here to 600 nodes, its residents in proportion, and passes of 64
evals in chunks of 16.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import gen, harness, port
from benchmark.reference import server as ref_server
from nomad_tpu_torch.solver import kernel, resident, solve, tensorize
from nomad_tpu_torch.solver.resident import ResidentSolver
from nomad_tpu_torch.utils import tracing
from nomad_tpu_torch.utils.metrics import global_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = harness.load_spec(ROOT)
CELL = harness.workload(SPEC, "c3-stream")
PROLOGUE = tracing.SOLVE_PROLOGUE
SEED = 2**31 + 23


def small_cell(nodes=600):
    """(cfg, mix, limits) of `c3-stream` at test size."""
    cfg = harness.load_json(ROOT, harness.config_file(SPEC, CELL["config"]))
    mix = harness.load_json(harness.HERE, "traffic",
                            f"{CELL['traffic']}.json")
    limits = harness.load_json(harness.HERE, "limits",
                               f"{CELL['name']}.json")
    per_node = cfg["resident"]["allocs"] // cfg["nodes"]["count"]
    cfg["nodes"]["count"] = nodes
    cfg["resident"]["allocs"] = nodes * per_node
    mix.update(evals_per_pass=64, evals_per_chunk=16, job_sets=2)
    return cfg, mix, limits


def run_small(seed=SEED, trace=0, control=""):
    cfg, mix, limits = small_cell()
    return harness.run_cell(ROOT, SPEC, CELL, seed, 0.5, trace, "cpu",
                            time.perf_counter(), control=control, cfg=cfg,
                            mix=mix, limits=limits)


@contextlib.contextmanager
def planted(edit):
    """Every batch the port packs, edited by `edit(pb)` before it is
    cached or solved."""
    real = tensorize.Tensorizer.repack_asks

    def repack(self, *a, **kw):
        pb = real(self, *a, **kw)
        if pb is not None:
            edit(pb)
        return pb
    tensorize.Tensorizer.repack_asks = repack
    try:
        yield
    finally:
        tensorize.Tensorizer.repack_asks = real


def drop_zone_constraint(pb):
    """The job's second constraint (`${attr.zone} >= z1`) left out."""
    pb.c_op = pb.c_op.copy()
    pb.c_op[:, 1] = 0


def halve_affinity(pb):
    pb.a_weight = pb.a_weight * 0.5


def drop_spread(pb):
    pb.sp_col = np.full_like(pb.sp_col, -1)


# ------------------------------------------------- the cell, end to end
@pytest.mark.parametrize("seed", [SEED, 3230000001])
def test_small_cell_agrees_with_the_reference(seed):
    r = run_small(seed)
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert r["correct"], checks
    assert checks["choice_mismatch"] == 0
    assert checks["constraint_violations"] == 0
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", [drop_zone_constraint, halve_affinity,
                                   drop_spread])
def test_a_planted_fault_in_the_planes_is_not_correct(fault):
    with planted(fault):
        r = run_small()
    assert not r["correct"], r["checks"]


def test_the_bf16_control_is_not_correct():
    r = run_small(control="bf16")
    c = r["checks"]["choice_mismatch"]
    assert not r["correct"] and c["value"] > c["limit"], r["checks"]


def test_traced_run_reads_the_prologue_and_the_waves_a_solve():
    r = run_small(trace=1)
    m = r["metrics"]
    assert m["prologue_ms.constrained"]["value"] > 0
    assert m["waves_per_solve.constrained"]["value"] >= 1
    assert {"pack_ms.stream", "wave_ms.stream", "syncs_per_wave.stream",
            "wave_graph_share.stream"} <= set(m)


def test_readers_find_nothing_in_a_program_without_them(monkeypatch):
    monkeypatch.setattr(global_metrics, "dump",
                        lambda: {"counters": {"solver.waves": 8.0}})
    assert harness.reader("waves_per_solve.constrained").read({}) is None
    assert harness.reader("prologue_ms.constrained").read(
        {"layer": {"prologue_s": []}}) is None


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys\nimport benchmark.reference.stream_constrained\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "nomad_tpu",
                         "nomad_tpu_torch", "torch"}


# -------------------------------------- the prologue range and counters
def small_world(cfg_name, nodes=256, evals=4):
    """A ResidentSolver on the config's cluster cut to `nodes`, its
    plain cluster and job, and one merged batch of `evals` jobs."""
    cfg = harness.load_json(harness.HERE, "configs", f"{cfg_name}.json")
    cfg["nodes"]["count"] = nodes
    cfg["resident"]["allocs"] = nodes * 2
    cl = gen.cluster(cfg, SEED)
    spec = gen.job(cfg, "probe")
    maker = port.JobMaker(spec)
    probe = port.asks(maker.make("probe"))
    rs = ResidentSolver(port.nodes(cl), probe, gp=len(probe),
                        kp=1 << (64 * evals - 1).bit_length(),
                        device="cpu")
    asks = sum((port.asks(maker.make(f"{cfg_name}-j{e}"))
                for e in range(evals)), [])
    merged, keys = rs.merge_asks(asks)
    return rs, cl, spec, rs.pack_batch(merged, job_keys=keys)


def plain_filtered(cl, spec, rows):
    """The plain count: each row's nodes that the job does not allow."""
    return rows * sum(not ref_server.feasible(spec, n) for n in cl.nodes)


def counted(fn):
    keys = ("solver.solves", "solver.pairs_filtered")
    c0 = global_metrics.dump()["counters"]
    out = fn()
    c1 = global_metrics.dump()["counters"]
    return out, {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in keys}


def test_counters_equal_the_plain_count_of_a_constrained_solve():
    rs, cl, spec, pb = small_world("c3-10k-constrained-stream")
    pb2 = rs.pack_batch([dataclasses.replace(a, count=8)
                         for a in rs.merge_asks(port.asks(
                             port.JobMaker(spec).make("other")))[0]])
    _, moved = counted(lambda: rs.solve_stream([pb, pb2], seeds=[5, 6]))
    want = plain_filtered(cl, spec, pb.n_asks) + plain_filtered(
        cl, spec, pb2.n_asks)
    assert want > 0
    assert moved == {"solver.solves": 2, "solver.pairs_filtered": want}
    assert int(np.sum(rs.last_filtered)) == want


def test_a_device_solve_span_carries_its_filtered_pairs():
    _, cl, spec, _ = small_world("c3-10k-constrained-stream", nodes=64)
    asks = port.asks(port.JobMaker(spec).make("span"))
    out, moved = counted(lambda: solve.Solver(
        device="cpu", host="never").solve(port.nodes(cl), asks))
    want = plain_filtered(cl, spec, len(asks))
    assert out.trace["backend"] == "device"
    assert out.trace["filtered_pairs"] == want > 0
    assert moved == {"solver.solves": 1, "solver.pairs_filtered": want}


def test_a_bin_pack_solve_filters_no_pair():
    rs, _, _, pb = small_world("c2-10k-binpack")
    _, moved = counted(lambda: rs.solve_stream([pb], seeds=[3]))
    assert moved == {"solver.solves": 1, "solver.pairs_filtered": 0}


def test_the_prologue_opens_only_under_a_profiler(monkeypatch):
    rs, _, _, pb = small_world("c3-10k-constrained-stream")
    opened = []
    real = kernel.device_range

    def spy(name):
        rng = real(name)
        opened.append((name, rng is tracing.NULL_SPAN))
        return rng
    monkeypatch.setattr(kernel, "device_range", spy)
    rs.solve_stream([pb], seeds=[4])
    assert (PROLOGUE, True) in opened
    assert not [o for o in opened if not o[1]]


def test_the_prologue_closes_before_the_first_wave_and_yield():
    """One prologue range a solve, at the top of its thread's ranges,
    ended before the solve's first wave opens; and ended when the
    generator first yields (a range opened then starts after it)."""
    rs, _, _, pb = small_world("c3-10k-constrained-stream")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rs.solve_stream([pb], seeds=[4])
        gen_ = resident._solve_steps(
            rs._dev_node, rs._used, rs._dev_used,
            resident._batch(rs._stack_args([pb]), 0), pb.n_place, 4,
            **rs._solve_kw([pb], False))
        first = next(gen_)
        with tracing.device_range("nomad.test.probe"):
            pass
        gen_.close()
    rows = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("nomad.")),
                  key=lambda r: (r[0], -r[1]))
    pro = [r for r in rows if r[2] == PROLOGUE]
    waves = [r for r in rows if r[2] in (tracing.WAVE_FULL,
                                         tracing.WAVE_CARRIED)]
    probe = [r for r in rows if r[2] == "nomad.test.probe"]
    assert first[0] == "carried"
    assert len(pro) == 2 and waves and len(probe) == 1
    assert pro[0][1] <= waves[0][0]
    assert pro[1][1] <= probe[0][0]
    for a, b, name in rows:
        if name != PROLOGUE:
            assert not any(p0 < a < p1 for p0, p1, _ in pro), name
