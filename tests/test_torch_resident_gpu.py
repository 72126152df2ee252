"""The streaming ResidentSolver on the card: its serial and lane streams
with the fused wave kernel ("score" and "topk") against the same streams
with the plain scorer ("off"), the delta scatters into the card-resident
planes, and the health kernel against its numpy twin.  These tests
import neither JAX nor the JAX package, so they also run where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_resident_gpu.py

Without a GPU they skip (the kernel has no CPU or interpret mode)."""
import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.solver import wave_kernel as wk
from nomad_tpu_torch.solver.resident import ResidentSolver
from nomad_tpu_torch.solver.tensorize import (ClusterDelta, PlacementAsk,
                                              alloc_usage_vector,
                                              template_checksum)
from nomad_tpu_torch.telemetry.health import health_host

#: kernel and plain scores may differ by this many ulp (the reference's
#: cross-backend bound for the binpack pow, tests/test_score_spec.py)
MAX_ULP = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU or "
                    "interpret mode)")


def make_nodes(n, seed=0):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        nd = mock.node(id=f"node-{i}", name=f"node-{i}",
                       datacenter=f"dc{i % 4}")
        nd.attributes["rack"] = f"r{i % 8}"
        nd.reserved_resources.cpu = 0
        nd.reserved_resources.memory_mb = 0
        nd.node_resources.cpu = int(rng.choice([2000, 3000, 4000]))
        nd.node_resources.memory_mb = int(rng.choice([4096, 8192]))
        nd.compute_class()
        nodes.append(nd)
    return nodes


def make_ask(jid, count, cpu=500, spread=False, priority=50):
    job = mock.job(priority=priority)
    job.id = job.name = jid
    job.datacenters = [f"dc{d}" for d in range(4)]
    if spread:
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=50)]
    job.affinities = [structs.Affinity(ltarget="${attr.rack}", rtarget="r3",
                                       operand="=", weight=40)]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = cpu
    tg.ephemeral_disk.size_mb = 100
    return PlacementAsk(job=job, tg=tg, count=count)


def solver(nodes, pallas, **kw):
    rs = ResidentSolver(nodes, [make_ask("probe", 4, spread=True)], gp=4,
                        kp=kw.pop("kp", 256), pallas=pallas, device="cuda",
                        **kw)
    rs._compact = False            # f32 scores, to hold them to an ulp bound
    return rs


def batches(rs, n, count=100, tag="b"):
    return [rs.pack_batch([make_ask(f"{tag}{b}", count, cpu=700 + 100 * b,
                                    spread=b % 2 == 0),
                           make_ask(f"{tag}{b}x", count // 4, cpu=400)])
            for b in range(n)]


def assert_close_streams(k_out, p_out, k_rs, p_rs):
    """Statuses, ok flags and wave counts equal; scores within MAX_ULP;
    a choice may differ only where its two scores tie within that."""
    kc, kok, ks, kst = k_out
    pc, pok, ps, pst = p_out
    np.testing.assert_array_equal(kst, pst)
    np.testing.assert_array_equal(kok, pok)
    np.testing.assert_array_max_ulp(np.where(kok, ks, 0.0),
                                    np.where(pok, ps, 0.0), maxulp=MAX_ULP)
    differ = kok & (kc != pc)
    if differ.any():
        np.testing.assert_array_max_ulp(ks[differ], ps[differ],
                                        maxulp=MAX_ULP)
    np.testing.assert_array_equal(np.asarray(k_rs.last_waves),
                                  np.asarray(p_rs.last_waves))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "topk"])
def test_stream_kernel_vs_plain(cuda, mode):
    nodes = make_nodes(512)
    outs, solvers = [], []
    for pallas in (mode, "off"):
        rs = solver(nodes, pallas)
        before = wk.fused_wave.mode_launches[mode]
        outs.append(rs.solve_stream(batches(rs, 3), seeds=[1, 2, 3]))
        launched = wk.fused_wave.mode_launches[mode] - before
        assert (launched > 0) == (pallas == mode)
        solvers.append(rs)
    assert_close_streams(*outs, *solvers)
    assert (outs[0][3] == 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "topk"])
def test_lane_stream_kernel_vs_plain(cuda, mode):
    nodes = make_nodes(512)
    outs, solvers = [], []
    for pallas in (mode, "off"):
        rs = solver(nodes, pallas)
        outs.append(rs.finish_stream(rs.solve_stream_async(
            batches(rs, 4, count=120), seeds=[1, 2, 3, 4], lanes=2)))
        solvers.append(rs)
    assert_close_streams(*outs, *solvers)
    assert solvers[0].lane_counters() == solvers[1].lane_counters()


@pytest.mark.cuda
def test_delta_scatters_on_card(cuda):
    """apply_delta's row scatters land the card planes on the host
    template bit for bit, and carry the same usage as the same deltas
    applied on the CPU."""
    from nomad_tpu_torch.solver.kernel import delta_scatter_add
    arr = torch.ones((6, 2), device="cuda")
    delta_scatter_add(arr, np.array([0, 3, 0, 0]),
                      np.array([[1, 1], [2, 2], [0, 0], [0, 0]], np.float32))
    np.testing.assert_array_equal(arr.cpu().numpy()[[0, 3]],
                                  [[2, 2], [3, 3]])
    nodes = make_nodes(512)
    solvers = [ResidentSolver(nodes, [make_ask("probe", 4)], gp=4, kp=64,
                              pallas=p, device=d)
               for p, d in (("topk", "cuda"), ("off", "cpu"))]
    for rs in solvers:
        for step in range(3):
            d = ClusterDelta()
            for k in range(32):
                a = mock.alloc()
                a.id = f"s{step}-{k}"
                tr = a.allocated_resources.tasks["web"]
                tr.cpu, tr.memory_mb, tr.networks = 200, 256, []
                a.allocated_resources.shared.networks = []
                nid = nodes[(step * 977 + k * 131) % len(nodes)].id
                d.place.append((nid, a))
                if k % 2:
                    d.stop.append((nid, a))
            if step == 1:
                changed = make_nodes(512)[7]
                changed.node_resources.cpu = 6000
                d.upsert_nodes.append(changed)
            assert rs.apply_delta(d) == "delta"
        assert rs.plane_checksum() == template_checksum(rs.template)
    for a, b in zip(solvers[0].usage(), solvers[1].usage()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_health_kernel_on_card(cuda):
    nodes = make_nodes(512)
    abn = {}
    for i, n in enumerate(nodes[:200]):
        a = mock.alloc()
        a.id, a.node_id, a.job.priority = f"low-{i}", n.id, 10
        tr = a.allocated_resources.tasks["web"]
        tr.cpu, tr.memory_mb, tr.networks = 1500, 3000, []
        a.allocated_resources.shared.networks = []
        abn[n.id] = [a]
    rs = ResidentSolver(nodes, [make_ask("probe", 4, priority=70)], abn,
                        gp=4, kp=64, evict_e=8, device="cuda")
    used0 = np.zeros_like(rs.template.used0)
    for i, n in enumerate(nodes[:200]):
        used0[i] = alloc_usage_vector(abn[n.id][0])
    rs.reset_usage(used0=used0)
    rs.solve_stream([rs.pack_batch([make_ask("h", 60, cpu=900)])])
    got = rs.health_counters()
    assert got == health_host(rs.template, *rs.usage())
    assert got.ev_slots == 200 and got.nodes_busy > 0
