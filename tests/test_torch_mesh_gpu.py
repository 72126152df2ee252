"""The mesh tiers on the card: eight shards of one GPU running the fused
wave kernel, against the same solves with the plain scorer and against
the flat solver.  These tests import neither JAX nor the JAX package, so
they also run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_mesh_gpu.py

Without a GPU they skip (the kernel has no CPU or interpret mode)."""
from collections import Counter

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.parallel import sharded as sh
from nomad_tpu_torch.solver import wave_kernel as wk
from nomad_tpu_torch.solver.kernel import solve_kernel
from nomad_tpu_torch.solver.resident import ResidentSolver
from nomad_tpu_torch.solver.solve import _kernel_args
from nomad_tpu_torch.solver.tensorize import template_checksum
from nomad_tpu_torch.telemetry.health import health_host
from test_torch_resident_gpu import (assert_close_streams, batches,
                                     make_ask, make_nodes)

CUDA = [torch.device("cuda")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU or "
                    "interpret mode)")


def shard_counts(solver):
    """A wrapper around the wave kernel counting each shard's launches
    by mode (by the shard's resident avail plane)."""
    ptrs = {t.data_ptr(): i for i, t in enumerate(solver._dev_node["avail"])}
    counts = [Counter() for _ in ptrs]
    real = wk.fused_wave

    def wave(**kw):
        shard = ptrs.get(kw["avail"].data_ptr())
        if shard is not None:
            counts[shard][kw["mode"]] += 1
        return real(**kw)
    wave.launches, wave.mode_launches = real.launches, real.mode_launches
    return wave, counts


def mesh_solver(nodes, pallas, mesh=None, elastic=False, **kw):
    cls = sh.ElasticShardedResidentSolver if elastic else \
        sh.ShardedResidentSolver
    rs = cls(nodes, [make_ask("probe", 4, spread=True)], gp=4,
             kp=kw.pop("kp", 256), pallas=pallas,
             mesh=mesh or sh.make_node_mesh(8, devices=CUDA), **kw)
    rs._compact = False            # f32 scores, to hold them to an ulp bound
    return rs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "topk"])
@pytest.mark.parametrize("grid", ["nodes", "hosts"])
def test_mesh_stream_kernel_vs_plain(cuda, mode, grid):
    """Eight shards of one card: the kernel launches on every shard,
    and the stream equals the plain scorer's and the flat kernel
    stream's."""
    nodes = make_nodes(5000)              # 5,120 padded: 640 a shard
    mesh = (sh.make_node_mesh(8, devices=CUDA) if grid == "nodes"
            else sh.make_two_tier_mesh(4, 8, devices=CUDA))
    outs, solvers = [], []
    for pallas in (mode, "off"):
        rs = mesh_solver(nodes, pallas, mesh=mesh)
        wave, counts = shard_counts(rs)
        real, wk.fused_wave = wk.fused_wave, wave
        try:
            outs.append(rs.solve_stream(batches(rs, 3), seeds=[1, 2, 3]))
        finally:
            wk.fused_wave = real
        if pallas == mode:
            assert all(c[mode] > 0 for c in counts), counts
        else:
            assert all(not c for c in counts), counts
        solvers.append(rs)
    assert_close_streams(*outs, *solvers)
    np.testing.assert_array_equal(solvers[0].last_rescore_waves,
                                  solvers[1].last_rescore_waves)
    flat = ResidentSolver(nodes, [make_ask("probe", 4, spread=True)], gp=4,
                          kp=256, pallas=mode, device="cuda")
    flat._compact = False
    f_out = flat.solve_stream(batches(flat, 3), seeds=[1, 2, 3])
    for a, b in zip(f_out, outs[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(flat.usage(), solvers[0].usage()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_sharded_solve_on_card(cuda):
    """The stateless wrapper at a ragged shard width: equal to the flat
    kernel solve, field for field."""
    pb = mock.rich_solve_batch(5000, 256)
    res = sh.sharded_solve(pb, sh.make_node_mesh(8, devices=CUDA),
                           pallas_mode="auto")
    flat = solve_kernel(*_kernel_args(pb, "cuda"), pallas_mode="auto")
    for f in ("choice", "choice_ok", "score", "n_feasible", "n_exhausted",
              "dim_exhausted", "unfinished", "feas", "cons_filtered",
              "used_final"):
        assert torch.equal(getattr(res, f), getattr(flat, f)), f
    assert bool(res.choice_ok[:pb.n_place, 0].all())


@pytest.mark.cuda
def test_elastic_fail_recover_on_card(cuda):
    """A shard lost and recovered on the card: the degraded stream runs
    the score kernel on every surviving shard and equals a flat solver
    over the live nodes; after recovery the planes equal the template
    and the health kernel (live-row mask) equals health_host."""
    nodes = make_nodes(5000)
    es = mesh_solver(nodes, "auto", elastic=True)
    es.fail_shard(3)
    live = es.health_row_mask()
    assert es.health_counters() == health_host(es.template, *es.usage(),
                                               row_mask=live)
    live_nodes = [n for i, n in enumerate(nodes) if live[i]]
    ref = ResidentSolver(live_nodes, [make_ask("probe", 4, spread=True)],
                         gp=4, kp=256, pallas="auto", device="cuda")
    ref._compact = False
    wave, counts = shard_counts(es)
    real, wk.fused_wave = wk.fused_wave, wave
    try:
        out = es.solve_stream(batches(es, 2))
    finally:
        wk.fused_wave = real
    assert all(c["score"] > 0 and not c["topk"] for c in counts), counts
    r_out = ref.solve_stream(batches(ref, 2))
    ids = np.array(es.template.node_ids + [""])
    r_ids = np.array(ref.template.node_ids + [""])
    np.testing.assert_array_equal(ids[np.where(out[1], out[0], -1)],
                                  r_ids[np.where(r_out[1], r_out[0], -1)])
    np.testing.assert_array_equal(out[3], r_out[3])
    es.recover()
    assert es.plane_checksum() == template_checksum(es.template)
    assert es.health_counters() == health_host(es.template, *es.usage())


@pytest.mark.cuda
def test_mesh_across_cards(cuda):
    """With more than one GPU the shards spread over the cards (two
    shards a card on four), the merges and sums move between them, and
    the stream and a stateless solve still equal the flat solver's on
    one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more GPUs")
    cards = [torch.device("cuda", i) for i in range(n)]
    mesh = sh.make_two_tier_mesh(n, 2 * n, devices=cards)
    assert {d.index for d in mesh.flat_devices()} == set(range(n))
    nodes = make_nodes(5000)
    rs = mesh_solver(nodes, "auto", mesh=mesh)
    assert [p.device for p in rs._dev_node["avail"]] == mesh.flat_devices()
    out = rs.solve_stream(batches(rs, 3), seeds=[1, 2, 3])
    flat = ResidentSolver(nodes, [make_ask("probe", 4, spread=True)], gp=4,
                          kp=256, pallas="auto", device="cuda")
    flat._compact = False
    f_out = flat.solve_stream(batches(flat, 3), seeds=[1, 2, 3])
    for a, b in zip(f_out, out):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(flat.usage(), rs.usage()):
        np.testing.assert_array_equal(a, b)
    assert rs.health_counters() == health_host(rs.template, *rs.usage())
    pb = mock.rich_solve_batch(5000, 256)
    res = sh.sharded_solve(pb, sh.make_node_mesh(2 * n, devices=cards),
                           pallas_mode="auto")
    one = solve_kernel(*_kernel_args(pb, "cuda"), pallas_mode="auto")
    for f in ("choice", "choice_ok", "score", "n_feasible", "feas",
              "used_final"):
        assert torch.equal(getattr(res, f), getattr(one, f)), f
