"""The port's native (C++) host engine, on the CPU.

`nomad_tpu_torch/solver/native/host_solve.cc` is built with the system
g++ at first use into `nomad_tpu_torch/_build/`.  It must give the
port's numpy twin (`host.host_solve_kernel`) and the reference's native
engine the same solve: placements, flags, usage and every counter bit
for bit, scores within the reference's 2e-5 (numpy's f32 power and
libm's powf may differ by an ulp) — the reference's `assert_bitwise`
(tests/test_native_solver.py:22) on its scenarios plus the config-1
shape.  A source that does not compile raises at build: nothing answers
in the engine's place.
"""
import os
import subprocess

import numpy as np
import pytest

from test_host_solver import make_asks, make_nodes
from test_native_solver import SCENARIOS, assert_bitwise

from nomad_tpu import mock as ref_mock
from nomad_tpu.solver import native as ref_native
from nomad_tpu.solver.host import HostResidentSolver as RefHost
from nomad_tpu.solver.solve import _kernel_args
from nomad_tpu.solver.tensorize import Tensorizer
from nomad_tpu_torch.solver import host, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def packed(style, n_nodes, count, devices=False, n_groups=3,
           allocs=False):
    nodes = make_nodes(n_nodes, devices=devices)
    by_node = None
    if allocs:
        # coll0 + penalty + live usage from allocs_by_node
        by_node = {}
        for n in nodes[:10]:
            a = ref_mock.alloc(node=n)
            for tr in a.allocated_resources.tasks.values():
                tr.networks = []
            by_node[n.id] = [a]
    pb = Tensorizer().pack(nodes, make_asks(style, count=count,
                                            n_groups=n_groups), by_node)
    return _kernel_args(pb), bool((pb.sp_col[:, 0] >= 0).any())


@pytest.mark.parametrize("style,n_nodes,count,seed,devices", SCENARIOS)
@pytest.mark.parametrize("stack_commit", [False, True])
def test_native_matches_numpy_twin_and_reference(style, n_nodes, count,
                                                 seed, devices,
                                                 stack_commit):
    args, has_spread = packed(style, n_nodes, count, devices)
    kw = dict(has_spread=has_spread, stack_commit=stack_commit)
    res_n = native.native_solve_kernel(*args, seed, **kw)
    assert_bitwise(res_n, host.host_solve_kernel(*args, seed, **kw))
    assert ref_native.available()
    assert_bitwise(res_n, ref_native.native_solve_kernel(*args, seed, **kw))


def test_native_matches_with_existing_usage():
    args, _ = packed("binpack", 30, 6, allocs=True)
    res_n = native.native_solve_kernel(*args, has_spread=False)
    assert_bitwise(res_n, host.host_solve_kernel(*args, has_spread=False))
    assert_bitwise(res_n, ref_native.native_solve_kernel(
        *args, has_spread=False))


def test_native_stream_matches_numpy_stream():
    """HostResidentSolver on the native engine streams exactly like the
    numpy twin (same host hint, carried usage), and like the reference's
    native stream."""
    nodes = make_nodes(50)
    probe = make_asks("constrained", count=4)
    kw = dict(gp=8, kp=32)
    hn = host.HostResidentSolver(nodes, probe, use_native=True, **kw)
    hp = host.HostResidentSolver(nodes, probe, use_native=False, **kw)
    hr = RefHost(nodes, probe, use_native=True, **kw)
    assert hn._native and not hp._native and hr._native
    for seeds in (None, [3, 5, 9]):
        for s in (hn, hp, hr):
            s.reset_usage()
        bn, bp, br = [], [], []
        for b in range(3):
            asks = make_asks("constrained", count=4)
            for a in asks:
                a.job.id = f"job-{b}"
            bn.append(hn.pack_batch(asks))
            bp.append(hp.pack_batch(asks))
            br.append(hr.pack_batch(asks))
        c_n, ok_n, s_n, st_n = hn.solve_stream(bn, seeds=seeds)
        for other, batches in ((hp, bp), (hr, br)):
            c_o, ok_o, s_o, st_o = other.solve_stream(batches, seeds=seeds)
            np.testing.assert_array_equal(ok_n, ok_o)
            np.testing.assert_array_equal(np.where(ok_n, c_n, -1),
                                          np.where(ok_o, c_o, -1))
            np.testing.assert_array_equal(st_n, st_o)
            np.testing.assert_array_equal(hn.usage()[0], other.usage()[0])


def test_native_randomized_fuzz():
    """Random sizes and seeds across the feature grid, against the
    port's numpy twin and the reference's engine."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        style = ["binpack", "constrained", "devices",
                 "distinct"][trial % 4]
        args, has_spread = packed(style, int(rng.integers(8, 70)),
                                  int(rng.integers(1, 12)),
                                  devices=style == "devices",
                                  n_groups=int(rng.integers(1, 5)))
        seed = int(rng.integers(0, 10))
        res_n = native.native_solve_kernel(*args, seed,
                                           has_spread=has_spread)
        assert_bitwise(res_n, host.host_solve_kernel(
            *args, seed, has_spread=has_spread))
        assert_bitwise(res_n, ref_native.native_solve_kernel(
            *args, seed, has_spread=has_spread))


def test_build_is_keyed_on_source_and_flags():
    """The engine lives in nomad_tpu_torch/_build/ under a name keyed on
    the source's hash and the flags (-ffp-contract=off among them); the
    repository tracks no built artifact of the port."""
    path = native.build()
    assert path.parent == native._BUILD_DIR
    assert path.parent.name == "_build"
    assert path.name.startswith("host_solve_") and path.exists()
    assert "-ffp-contract=off" in native.GXX_FLAGS
    assert native.library_path() == path
    tracked = subprocess.run(
        ["git", "ls-files", "nomad_tpu_torch"], cwd=REPO,
        capture_output=True, text=True)
    if tracked.returncode == 0:
        assert not [f for f in tracked.stdout.split()
                    if f.endswith(".so")]


def test_broken_source_raises_at_build(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message
    from the engine's entry points and from a native
    HostResidentSolver; the numpy twin does not answer instead."""
    broken = tmp_path / "host_solve.cc"
    broken.write_text(native._SRC.read_text().replace(
        "constexpr int TOP_K = 4;", "constexpr int TOP_K = ;", 1))
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    calls = []
    monkeypatch.setattr(host, "host_solve_kernel",
                        lambda *a, **kw: calls.append(1))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    args, has_spread = packed("binpack", 12, 2)
    with pytest.raises(RuntimeError, match="TOP_K"):
        native.native_solve_kernel(*args, has_spread=has_spread)
    nodes = make_nodes(12)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.HostResidentSolver(nodes, make_asks("binpack", count=2))
    assert not calls
    assert not list((tmp_path / "_build").glob("*.so"))
    # the numpy engine is a choice of its own, not a fallback
    hp = host.HostResidentSolver(nodes, make_asks("binpack", count=2),
                                 use_native=False)
    assert not hp._native
