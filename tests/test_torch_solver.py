"""The port's one-device solve against the JAX package, on the CPU.

`solve_kernel` in modes off / score / topk runs on the reference's
differential scenarios (tests/test_host_solver.py, test_shortlist.py),
handed the same packed state through `packed_from_numpy`, and must match
the reference's numpy host twin and its jit kernel under `assert_same`,
with the wave and rescore counts and the explainability counters exact.
`Solver(device="cpu", host="never").solve` must place like the
reference's `Solver(host="never").solve` on an identically built
cluster.  The
package must not pull in JAX or the JAX package, and must never fall
back to the CPU quietly."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_host_solver import SCENARIOS, assert_same, make_asks, make_nodes
from test_shortlist import contended_problem
from test_torch_tensorize import build

from nomad_tpu import mock as ref_mock
from nomad_tpu.solver.host import host_solve_kernel
from nomad_tpu.solver.kernel import solve_kernel as ref_solve_kernel
from nomad_tpu.solver.solve import Solver as RefSolver
from nomad_tpu.solver.solve import _kernel_args as ref_kernel_args
from nomad_tpu.solver.tensorize import PlacementAsk, Tensorizer
from nomad_tpu.structs import Spread
from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver import wave_kernel as wk
from nomad_tpu_torch.solver.solve import Solver, _kernel_args
from nomad_tpu_torch.solver.tensorize import packed_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_solve(pb, seed=0, **kw):
    """The port's solve_kernel on the reference batch's state."""
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    res = port_kernel.solve_kernel(
        *_kernel_args(packed_from_numpy(arrays, "cpu")), seed, **kw)
    return res._replace(**{k: v.numpy() for k, v in res._asdict().items()
                           if isinstance(v, torch.Tensor)})


def assert_identical(res, ref, rescore=True):
    assert_same(res, ref)
    for f in ("n_exhausted", "dim_exhausted", "cons_filtered"):
        np.testing.assert_array_equal(getattr(res, f),
                                      np.asarray(getattr(ref, f)), f)
    assert res.n_waves == int(ref.n_waves)
    if rescore:
        assert res.n_rescore == int(ref.n_rescore)


def packed(style, n_nodes, count, devices):
    pb = Tensorizer().pack(make_nodes(n_nodes, devices=devices),
                           make_asks(style, count=count))
    return pb, bool((pb.sp_col[:, 0] >= 0).any())


@pytest.mark.parametrize("mode", ["off", "score", "topk"])
@pytest.mark.parametrize("style,n_nodes,count,seed,devices", SCENARIOS)
def test_solve_matches_host_twin(style, n_nodes, count, seed, devices,
                                 mode):
    pb, has_spread = packed(style, n_nodes, count, devices)
    res = port_solve(pb, seed, has_spread=has_spread, pallas_mode=mode)
    host = host_solve_kernel(*ref_kernel_args(pb), seed,
                             has_spread=has_spread)
    assert_identical(res, host)


@pytest.mark.parametrize("mode", ["off", "score", "topk"])
@pytest.mark.parametrize("style,n_nodes,count,seed,devices", [
    ("constrained", 60, 6, 7, False),
    ("binpack", 12, 30, 0, False),
])
def test_solve_matches_reference_kernel(style, n_nodes, count, seed,
                                        devices, mode):
    """Same mode on both sides, shortlist on (no distinct_hosts)."""
    pb, has_spread = packed(style, n_nodes, count, devices)
    kw = dict(has_spread=has_spread, has_distinct=False, pallas_mode=mode)
    res = port_solve(pb, seed, **kw)
    ref = ref_solve_kernel(*ref_kernel_args(pb), seed, **kw)
    assert_identical(res, ref)


@pytest.mark.parametrize("mode", ["off", "topk"])
@pytest.mark.parametrize("seed", [0, 3])
def test_shortlist_escape_hatch_reproduces_rescores(mode, seed):
    """Contended shortlists (C=40 < Np=64) drain and escape: the port
    takes the same carried / full waves as the reference kernel."""
    nodes, asks = contended_problem()
    pb = Tensorizer().pack(nodes, asks)
    kw = dict(has_spread=False, has_distinct=False, pallas_mode=mode,
              shortlist_c=40)
    res = port_solve(pb, seed, **kw)
    ref = ref_solve_kernel(*ref_kernel_args(pb), seed, **kw)
    assert_identical(res, ref)
    assert_identical(res, host_solve_kernel(*ref_kernel_args(pb), seed,
                                            has_spread=False),
                     rescore=False)
    assert res.n_rescore < res.n_waves


def test_shortlist_spread_interleave_matches():
    """Complete shortlists carry spread groups through the per-value
    interleave."""
    nodes = []
    for i in range(24):
        n = ref_mock.node(datacenter=f"dc{i % 3}")
        n.node_resources.cpu = 2200
        n.node_resources.memory_mb = 4096
        n.compute_class()
        nodes.append(n)
    asks = []
    for g in range(3):
        j = ref_mock.job()
        j.id = f"job-{g}"
        j.datacenters = ["dc0", "dc1", "dc2"]
        j.spreads = [Spread(attribute="${node.datacenter}", weight=100)]
        tg = j.task_groups[0]
        tg.count = 10
        tg.tasks[0].resources.networks = []
        tg.tasks[0].resources.cpu = 600
        asks.append(PlacementAsk(job=j, tg=tg, count=10))
    pb = Tensorizer().pack(nodes, asks)
    kw = dict(has_spread=True, has_distinct=False, pallas_mode="off")
    for seed in (0, 4):
        res = port_solve(pb, seed, **kw)
        ref = ref_solve_kernel(*ref_kernel_args(pb), seed, **kw)
        assert_identical(res, ref)
        assert res.n_rescore < res.n_waves


@pytest.mark.parametrize("style,seed", [("distinct", 0),
                                        ("constrained", 7),
                                        ("binpack", 3)])
def test_sort_conflict_path_matches(monkeypatch, style, seed):
    """The sort-based same-wave conflict path (K > 2048 on real
    batches) forced at small K."""
    monkeypatch.setattr(port_kernel, "_FORCE_SORT_CONFLICTS", True)
    pb, has_spread = packed(style, 30, 8, False)
    res = port_solve(pb, seed, has_spread=has_spread)
    host = host_solve_kernel(*ref_kernel_args(pb), seed,
                             has_spread=has_spread)
    assert_identical(res, host)


def test_existing_usage_penalty_and_stack_commit():
    """coll0 + penalty + live usage, and the serial-fidelity stacking."""
    nodes = make_nodes(30)
    asks = make_asks("constrained", count=6)
    asks[0] = PlacementAsk(job=asks[0].job, tg=asks[0].tg, count=6,
                           penalty_nodes=frozenset({nodes[3].id}),
                           existing_by_node={nodes[4].id: 2})
    allocs = {}
    for n in nodes[:10]:
        a = ref_mock.alloc(node=n)
        for tr in a.allocated_resources.tasks.values():
            tr.networks = []
        allocs[n.id] = [a]
    pb = Tensorizer().pack(nodes, asks, allocs)
    for stack in (False, True):
        for mode in ("off", "topk"):
            res = port_solve(pb, 0, has_spread=True, stack_commit=stack,
                             pallas_mode=mode)
            host = host_solve_kernel(*ref_kernel_args(pb), 0,
                                     has_spread=True, stack_commit=stack)
            assert_identical(res, host)


def _placements_by_index(nodes, out):
    index = {n.id: i for i, n in enumerate(nodes)}
    return [(p.ask_index, index[p.node.id] if p.node else None,
             p.failed_reason) for p in out.placements]


def _metrics(p):
    m = p.metrics
    return (m.nodes_evaluated, m.nodes_filtered, m.constraint_filtered,
            m.nodes_exhausted, m.dimension_exhausted, len(m.score_meta))


def _meta_scores(p):
    return [d["normalized_score"] for d in p.metrics.score_meta]


@pytest.mark.parametrize("style,kw", [
    ("rich", {"with_allocs": True, "n_nodes": 70}),
    ("distinct", {"n_nodes": 24}),
    ("devices", {"count": 10}),
    ("binpack", {"n_nodes": 12, "count": 30}),
])
def test_solver_matches_reference_solver(style, kw):
    """Same placements (by node index), failure reasons, AllocMetric
    counts and class eligibility as the reference's device solve."""
    r_nodes, r_asks, r_allocs = build("ref", style, **kw)
    p_nodes, p_asks, p_allocs = build("port", style, **kw)
    ref = RefSolver(host="never").solve(r_nodes, r_asks, r_allocs)
    out = Solver(device="cpu", host="never").solve(p_nodes, p_asks,
                                                   p_allocs)
    assert (_placements_by_index(p_nodes, out)
            == _placements_by_index(r_nodes, ref))
    for p, r in zip(out.placements, ref.placements):
        assert _metrics(p) == _metrics(r)
        # scores agree to the reference's cross-backend tolerance (10**x
        # may differ by an ulp between libm builds)
        assert p.score == pytest.approx(r.score, rel=2e-5, abs=2e-5)
        assert _meta_scores(p) == pytest.approx(_meta_scores(r), rel=2e-5,
                                                abs=2e-5)
    assert out.class_eligibility == ref.class_eligibility
    assert any(p.node is not None for p in out.placements)


def test_unsupported_options_raise():
    pb, has_spread = packed("binpack", 20, 4, False)
    with pytest.raises(NotImplementedError):
        port_solve(pb, 0, has_spread=has_spread, lane_axis="lanes")
    with pytest.raises(ValueError, match="wave_mode"):
        port_solve(pb, 0, has_spread=has_spread, wave_mode="loop")


@pytest.mark.parametrize("plane", ["learned", "region_bias"])
@pytest.mark.parametrize("mode", ["off", "score", "topk"])
def test_plane_options_solve_like_reference(plane, mode):
    """The learned / region_bias keywords, which raised before the port
    had the planes, solve as the reference's jit kernel and twin do, in
    every scorer mode asked for (the planes pin the torch scorer)."""
    pb, has_spread = packed("binpack", 20, 4, False)
    Gp, Np = pb.ask_res.shape[0], pb.avail.shape[0]
    p = (0.5 * np.random.default_rng(11).standard_normal((Gp, Np))
         ).astype(np.float32)
    res = port_solve(pb, 3, has_spread=has_spread, pallas_mode=mode,
                     **{plane: torch.as_tensor(p)})
    ref = ref_solve_kernel(*ref_kernel_args(pb), 3, has_spread=has_spread,
                           **{plane: p})
    assert_identical(res, ref)
    assert_identical(res, host_solve_kernel(*ref_kernel_args(pb), 3,
                                            has_spread=has_spread,
                                            **{plane: p}))


def test_no_silent_cpu(monkeypatch):
    """A default Solver runs on CUDA or raises; the wave wrapper counts
    only kernel launches, never its CPU (plain) calls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver()
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(device="cuda")
    assert Solver(device="cpu").device.type == "cpu"
    before = dict(wk.fused_wave.mode_launches), wk.fused_wave.launches
    pb, has_spread = packed("constrained", 60, 6, False)
    for mode in ("score", "topk"):
        port_solve(pb, 0, has_spread=has_spread, pallas_mode=mode)
    assert (dict(wk.fused_wave.mode_launches),
            wk.fused_wave.launches) == before


#: one module of each subpackage of the port (a later move that drops a
#: subpackage from the scans below fails here)
PORT_MODULES = ["nomad_tpu_torch.solver.solve",
                "nomad_tpu_torch.solver.resident",
                "nomad_tpu_torch.solver.host",
                "nomad_tpu_torch.solver.native", "nomad_tpu_torch.mock",
                "nomad_tpu_torch.scheduler.harness",
                "nomad_tpu_torch.scheduler.fleet",
                "nomad_tpu_torch.state.store",
                "nomad_tpu_torch.structs.job", "nomad_tpu_torch.utils.codec",
                "nomad_tpu_torch.raft.node",
                "nomad_tpu_torch.server.server",
                "nomad_tpu_torch.telemetry.health",
                "nomad_tpu_torch.acl.acl",
                "nomad_tpu_torch.parallel.sharded",
                "nomad_tpu_torch.parallel.federated",
                "nomad_tpu_torch.utils.tlsutil",
                "nomad_tpu_torch.rpc.wire", "nomad_tpu_torch.rpc.server",
                "nomad_tpu_torch.rpc.client",
                "nomad_tpu_torch.rpc.transport",
                "nomad_tpu_torch.rpc.endpoints",
                "nomad_tpu_torch.client.agent",
                "nomad_tpu_torch.client.sim",
                "nomad_tpu_torch.jobspec.hcl",
                "nomad_tpu_torch.jobspec.parse",
                "nomad_tpu_torch.server.heartbeat",
                "nomad_tpu_torch.server.periodic",
                "nomad_tpu_torch.server.deployment_watcher",
                "nomad_tpu_torch.server.drainer",
                "nomad_tpu_torch.membership.gossip",
                "nomad_tpu_torch.membership.regions",
                "nomad_tpu_torch.server.serving"]


def test_import_pulls_in_no_jax():
    """Importing the port's entry points (the solver with its host twin
    and native engine, the scheduler path's harness and fleet round, the
    state store, raft, the server plane, telemetry, ACLs, the mesh
    tiers, the wire RPC with TLS, the agent's server interface, the
    simulated node agent, gossip membership, the lifecycle watchers and
    the HCL jobspec parser) loads neither jax nor any module of the JAX
    package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"import {', '.join(PORT_MODULES)}\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nomad_tpu'))\n"
        "assert any(m.startswith('nomad_tpu_torch') for m in new)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_source_imports_no_jax():
    """AST scan: no absolute import of jax, the JAX package or bench.py
    anywhere in the port (every subpackage: solver, scheduler, server,
    raft, parallel, rpc, membership, client, ...) or chip_smoke.py."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "nomad_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for mod in PORT_MODULES:
        assert os.path.join(REPO, *mod.split(".")) + ".py" in files, mod
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "nomad_tpu", "bench"), (
                    path, m)
