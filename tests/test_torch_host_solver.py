"""The port's host route of the solve against the JAX package, on the CPU.

`nomad_tpu_torch.solver.host` is the port's own copy of the reference's
numpy twin.  On the reference's differential scenarios
(tests/test_host_solver.py `SCENARIOS`, `make_nodes`, `make_asks`) and
its overcommitted eviction worlds (tests/test_preempt_kernel.py):

  * the port's `host_solve_kernel` equals the reference's bit for bit,
    every SolveResult field, with `stack_commit`, the eviction keywords
    and the learned / region planes;
  * the port's twin equals the port's torch `solve_kernel` on the CPU
    (`pallas_mode="off"`) under the reference's `assert_same`;
  * the planes, each and both, through the port's twin and its torch
    solve equal the reference's twin and its jnp solve;
  * `prefer_host` equals the reference's on a grid of shapes;
  * `HostResidentSolver` streams equal the reference's batch for batch
    (numpy and native engines), and with `device_parity=True` the
    port's `ResidentSolver(device="cpu")`;
  * `Solver(device="cpu", host=...)` routes as the reference's: "auto"
    takes the twin below the gate and says so in its trace
    (`backend == "host"`), "never" the torch solve, "always" the twin,
    with the reference's `Solver(host=...)` placements.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_host_solver import SCENARIOS, assert_same, make_asks, make_nodes
from test_preempt_kernel import packed_overcommit
from test_torch_preempt_kernel import port_preempt
from test_torch_solver import _placements_by_index
from test_torch_tensorize import build

from nomad_tpu.solver import host as ref_host
from nomad_tpu.solver.kernel import _APPROX_MIN_NP as REF_APPROX_MIN_NP
from nomad_tpu.solver.kernel import solve_kernel as ref_solve_kernel
from nomad_tpu.solver.resident import ResidentSolver as RefResidentSolver
from nomad_tpu.solver.solve import Solver as RefSolver
from nomad_tpu.solver.solve import _kernel_args as ref_kernel_args
from nomad_tpu.solver.tensorize import Tensorizer
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.solver import host
from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver import solve as port_solve
from nomad_tpu_torch.solver.resident import ResidentSolver
from nomad_tpu_torch.solver.tensorize import (PlacementAsk,
                                              packed_from_numpy)


def assert_bitwise(res, ref):
    """Every SolveResult field of the reference's twin, bit for bit."""
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None:
            assert getattr(res, f) is None, f
            continue
        np.testing.assert_array_equal(np.asarray(getattr(res, f)),
                                      np.asarray(r), err_msg=f)


def packed(style, n_nodes, count, devices):
    pb = Tensorizer().pack(make_nodes(n_nodes, devices=devices),
                           make_asks(style, count=count))
    return pb, bool((pb.sp_col[:, 0] >= 0).any())


def torch_solve(pb, seed=0, **kw):
    """The port's torch solve_kernel on the reference batch's state."""
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    res = port_kernel.solve_kernel(
        *port_solve._kernel_args(packed_from_numpy(arrays, "cpu")), seed,
        **kw)
    return port_solve._to_host(res)


def _ev_kw(pb):
    return dict(has_preempt=True, ev_res=pb.ev_res, ev_prio=pb.ev_prio,
                ask_prio=pb.ask_prio)


@pytest.mark.parametrize("stack_commit", [False, True])
@pytest.mark.parametrize("style,n_nodes,count,seed,devices", SCENARIOS)
def test_twin_bitwise_matches_reference_twin(style, n_nodes, count, seed,
                                             devices, stack_commit):
    pb, has_spread = packed(style, n_nodes, count, devices)
    args = ref_kernel_args(pb)
    kw = dict(has_spread=has_spread, stack_commit=stack_commit)
    assert_bitwise(host.host_solve_kernel(*args, seed, **kw),
                   ref_host.host_solve_kernel(*args, seed, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_twin_eviction_pass_bitwise_matches_reference(seed):
    """The eviction keywords: victim masks and commit waves included."""
    pb, *_ = packed_overcommit(seed, spread=(seed % 2 == 0))
    args = ref_kernel_args(pb)
    ref = ref_host.host_solve_kernel(*args, **_ev_kw(pb))
    assert np.asarray(ref.evict).any(), "workload must force evictions"
    res = host.host_solve_kernel(*args, **_ev_kw(pb))
    assert_bitwise(res, ref)
    # and the port's torch eviction pass on the same state
    assert_same(port_preempt(pb), res)


@pytest.mark.parametrize("style,n_nodes,count,seed,devices", SCENARIOS)
def test_twin_matches_torch_solve(style, n_nodes, count, seed, devices):
    pb, has_spread = packed(style, n_nodes, count, devices)
    res = host.host_solve_kernel(*ref_kernel_args(pb), seed,
                                 has_spread=has_spread)
    dev = torch_solve(pb, seed, has_spread=has_spread, pallas_mode="off")
    assert_same(dev, res)
    for f in ("n_exhausted", "dim_exhausted", "cons_filtered"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(res, f), f)
    assert int(dev.n_waves) == int(res.n_waves)


def _planes(pb, which, seed=7):
    """A learned plane with zero entries ("counted when nonzero") and a
    three-level region plane (home > sibling > remote), from a seed."""
    Gp, Np = pb.ask_res.shape[0], pb.avail.shape[0]
    rng = np.random.default_rng(seed)
    out = {}
    if which in ("learned", "both"):
        lp = (0.5 * rng.standard_normal((Gp, Np))).astype(np.float32)
        lp[rng.random((Gp, Np)) < 0.25] = 0.0
        out["learned"] = lp
    if which in ("region_bias", "both"):
        levels = np.array([0.5, 0.2, 0.0], np.float32)
        out["region_bias"] = levels[rng.integers(0, 3, (Gp, Np))]
    return out


@pytest.mark.parametrize("which", ["learned", "region_bias", "both"])
@pytest.mark.parametrize("style,n_nodes,count,seed", [
    ("binpack", 30, 6, 3), ("constrained", 60, 6, 0),
    ("distinct", 24, 6, 0)])
def test_planes_match_reference(which, style, n_nodes, count, seed):
    pb, has_spread = packed(style, n_nodes, count, False)
    planes = _planes(pb, which)
    args = ref_kernel_args(pb)
    ref_twin = ref_host.host_solve_kernel(*args, seed,
                                          has_spread=has_spread, **planes)
    twin = host.host_solve_kernel(*args, seed, has_spread=has_spread,
                                  **planes)
    assert_bitwise(twin, ref_twin)
    ref_jnp = ref_solve_kernel(*args, seed, has_spread=has_spread,
                               **planes)
    dev = torch_solve(pb, seed, has_spread=has_spread,
                      **{k: torch.as_tensor(v) for k, v in planes.items()})
    assert_same(dev, ref_jnp)
    assert_same(dev, twin)
    base = host.host_solve_kernel(*args, seed, has_spread=has_spread)
    assert not np.array_equal(
        np.where(twin.choice_ok, twin.choice, -1),
        np.where(base.choice_ok, base.choice, -1)) or \
        not np.array_equal(twin.score, base.score), \
        "the planes must move the solve on this scenario"


def test_prefer_host_matches_reference():
    """A grid of shapes on both sides of each of the gate's bounds."""
    for n_nodes_padded in (8, 128, 1024, 2048, 4095, 4096, 8192, 16384):
        for n_asks in (0, 1, 4, 16, 64, 255, 256, 257):
            for n_place in (1, 100, 512, 1024, 1025, 5000):
                shape = (n_nodes_padded, n_asks, n_place)
                assert host.prefer_host(*shape) == \
                    ref_host.prefer_host(*shape), shape


def test_prefer_host_gate():
    """The reference test's cases (tests/test_host_solver.py:176)."""
    assert port_kernel._APPROX_MIN_NP == REF_APPROX_MIN_NP
    assert (host.HOST_MAX_PLACE, host.HOST_MAX_CELLS) == \
        (ref_host.HOST_MAX_PLACE, ref_host.HOST_MAX_CELLS)
    assert host.prefer_host(128, 4, 100)
    assert host.prefer_host(1024, 16, 512)
    assert not host.prefer_host(port_kernel._APPROX_MIN_NP, 4, 100)
    assert not host.prefer_host(16384, 64, 100)
    assert not host.prefer_host(128, 4, 5000)


def _stream_batches(solvers, n_batches=3):
    out = [[] for _ in solvers]
    for b in range(n_batches):
        asks = make_asks("constrained", count=4)
        for a in asks:
            a.job.id = f"job-{b}"        # distinct jobs per batch
        for i, s in enumerate(solvers):
            out[i].append(s.pack_batch(asks))
    return out


def assert_streams_equal(a, b, scores=True):
    """Choices, ok flags and statuses equal; scores too, unless one side
    is a device stream, whose compact payload carries scores rounded to
    bfloat16 (the reference's own comparison, test_host_solver.py
    :145, reads no score)."""
    c_a, ok_a, s_a, st_a = a
    c_b, ok_b, s_b, st_b = b
    np.testing.assert_array_equal(ok_a, ok_b)
    np.testing.assert_array_equal(np.where(ok_a, c_a, -1),
                                  np.where(ok_b, c_b, -1))
    np.testing.assert_array_equal(st_a, st_b)
    if scores:
        np.testing.assert_array_equal(s_a, s_b)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("device_parity", [False, True])
def test_host_stream_matches_reference(use_native, device_parity):
    """Carried usage across a multi-batch stream, seeded and unseeded,
    batch for batch against the reference's twin of the same engine."""
    nodes = make_nodes(50)
    probe = make_asks("constrained", count=4)
    kw = dict(gp=8, kp=32, use_native=use_native,
              device_parity=device_parity)
    ref = ref_host.HostResidentSolver(nodes, probe, **kw)
    assert ref._native == use_native
    hs = host.HostResidentSolver(nodes, probe, **kw)
    for seeds in (None, [3, 5, 9]):
        ref.reset_usage()
        hs.reset_usage()
        b_ref, b_hs = _stream_batches([ref, hs])
        for pr, ph in zip(b_ref, b_hs):
            # batch for batch: one solve_stream per batch
            assert_streams_equal(hs.solve_stream([ph], seeds=seeds and
                                                 seeds[:1]),
                                 ref.solve_stream([pr], seeds=seeds and
                                                  seeds[:1]))
            np.testing.assert_array_equal(hs.usage()[0], ref.usage()[0])
            np.testing.assert_array_equal(hs.usage()[1], ref.usage()[1])
        # and the whole stream in one call
        ref.reset_usage()
        hs.reset_usage()
        assert_streams_equal(hs.solve_stream(b_hs, seeds=seeds),
                             ref.solve_stream(b_ref, seeds=seeds))
        np.testing.assert_array_equal(hs.usage()[0], ref.usage()[0])


@pytest.mark.parametrize("use_native", [False, True])
def test_host_stream_device_parity_matches_resident_solver(use_native):
    """With device_parity the host stream equals the port's torch stream
    (`ResidentSolver(device="cpu")`) and the reference's jit stream."""
    nodes = make_nodes(50)
    probe = make_asks("constrained", count=4)
    rs = ResidentSolver(nodes, probe, gp=8, kp=32, device="cpu")
    ref = RefResidentSolver(nodes, probe, gp=8, kp=32)
    hs = host.HostResidentSolver(nodes, probe, gp=8, kp=32,
                                 use_native=use_native, device_parity=True)
    for seeds in (None, [3, 5, 9]):
        for s in (rs, ref, hs):
            s.reset_usage()
        b_rs, b_ref, b_hs = _stream_batches([rs, ref, hs])
        out_hs = hs.solve_stream(b_hs, seeds=seeds)
        assert_streams_equal(rs.solve_stream(b_rs, seeds=seeds), out_hs,
                             scores=False)
        assert_streams_equal(ref.solve_stream(b_ref, seeds=seeds), out_hs,
                             scores=False)
        np.testing.assert_allclose(rs.usage()[0], hs.usage()[0], rtol=1e-5)


def test_host_stream_pack_batch_cached():
    """The whole-eval batch cache of the resident module serves the host
    solver too: the same stateless job shape packs once."""
    nodes = make_nodes(20)
    probe = make_asks("binpack", count=2)
    hs = host.HostResidentSolver(nodes, probe, use_native=False)
    a = hs.pack_batch_cached(make_asks("binpack", count=2))
    b = hs.pack_batch_cached(make_asks("binpack", count=2))
    assert a is b and len(hs._eval_cache) == 1


# ----------------------------------------------------------- routing
def _route_spy(monkeypatch):
    calls = {"host": 0, "device": 0}
    real_host, real_dev = port_solve.host_solve_kernel, \
        port_solve.solve_kernel

    def spy_host(*a, **kw):
        calls["host"] += 1
        return real_host(*a, **kw)

    def spy_dev(*a, **kw):
        calls["device"] += 1
        return real_dev(*a, **kw)
    monkeypatch.setattr(port_solve, "host_solve_kernel", spy_host)
    monkeypatch.setattr(port_solve, "solve_kernel", spy_dev)
    return calls


@pytest.mark.parametrize("mode,route", [("auto", "host"),
                                        ("never", "device"),
                                        ("always", "host")])
@pytest.mark.parametrize("style,kw", [
    ("rich", {"with_allocs": True, "n_nodes": 70}),
    ("distinct", {"n_nodes": 24}),
    ("binpack", {"n_nodes": 12, "count": 30})])
def test_solver_routes_like_reference(monkeypatch, mode, route, style, kw):
    calls = _route_spy(monkeypatch)
    r_nodes, r_asks, r_allocs = build("ref", style, **kw)
    p_nodes, p_asks, p_allocs = build("port", style, **kw)
    out = port_solve.Solver(device="cpu", host=mode).solve(
        p_nodes, p_asks, p_allocs)
    assert calls == {"host": int(route == "host"),
                     "device": int(route == "device")}
    assert out.trace["backend"] == route
    ref = RefSolver(host=mode).solve(r_nodes, r_asks, r_allocs)
    assert (_placements_by_index(p_nodes, out)
            == _placements_by_index(r_nodes, ref))
    for p, r in zip(out.placements, ref.placements):
        assert p.score == pytest.approx(r.score, rel=2e-5, abs=2e-5)


def _port_pb(pb):
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    return port_solve.PackedBatch(**arrays)


def test_auto_route_reads_problem_size_only(monkeypatch):
    """Below the gate "auto" takes the twin and from a node axis of the
    gate's width the device solve, whether or not a GPU is present."""
    calls = _route_spy(monkeypatch)
    small = _port_pb(Tensorizer().pack(make_nodes(4),
                                       make_asks("binpack", count=2)))
    wide = _port_pb(Tensorizer().pack(make_nodes(2100),
                                      make_asks("binpack", count=2)))
    assert wide.avail.shape[0] == port_kernel._APPROX_MIN_NP
    for gpu in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: gpu)
        port_solve._run_kernel(small, "cpu")
        assert calls == {"host": 1, "device": 0}
        res = port_solve._to_host(port_solve._run_kernel(wide, "cpu"))
        assert calls == {"host": 1, "device": 1}
        assert res.choice_ok[:wide.n_place, 0].all()
        calls.update(host=0, device=0)
    with pytest.raises(ValueError, match="host="):
        port_solve.Solver(device="cpu", host="sometimes")


def test_host_result_passes_fetch_untouched():
    """A twin's result holds numpy arrays: `_to_host` hands every field
    through as it is, and it is told apart from a device result."""
    pb, has_spread = packed("binpack", 20, 4, False)
    res = host.host_solve_kernel(*ref_kernel_args(pb), 0,
                                 has_spread=has_spread)
    fetched = port_solve._to_host(res)
    for f in res._fields:
        assert getattr(fetched, f) is getattr(res, f), f
    assert port_solve._backend(res) == "host"
    dev = port_kernel.solve_kernel(
        *port_solve._kernel_args(_port_pb(pb), "cpu"), has_spread=has_spread)
    assert port_solve._backend(dev) == "device"
    attrs = port_solve.solve_trace_attrs(_port_pb(pb), res, "cpu",
                                         backend="host")
    assert attrs["backend"] == "host"
    assert attrs["waves"] == attrs["rescore_waves"] == int(res.n_waves)


def test_async_host_route_solves_at_dispatch(monkeypatch):
    """A host-routed solve_async runs the twin to completion at dispatch;
    wait() then only runs the fixup."""
    calls = _route_spy(monkeypatch)
    solver = port_solve.Solver(device="cpu")
    nodes = [port_mock.node() for _ in range(6)]
    job = port_mock.job()
    tg = job.task_groups[0]
    tg.count = 2
    pending = solver.solve_async(nodes, [PlacementAsk(job=job, tg=tg,
                                                      count=2)])
    assert calls["host"] == 1
    assert isinstance(pending._res.choice, np.ndarray)
    out = pending.wait()
    assert calls == {"host": 1, "device": 0}
    assert out.trace["backend"] == "host"
    assert sum(p.node is not None for p in out.placements) == 2
