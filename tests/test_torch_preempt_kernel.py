"""The port's in-kernel preemption (the eviction wave pass of
`nomad_tpu_torch.solver.kernel.solve_kernel(has_preempt=True)`, the
eviction planes of the tensorizer and the scheduler's commit of
kernel-chosen (place, evict) pairs) against the JAX package, on the CPU.

The kernel cases solve the overcommitted worlds of
tests/test_preempt_kernel.py (nodes full of low-priority allocs, asks
that place only by evicting), handed the reference's packed batch
through `packed_from_numpy`, and must give the reference's numpy twin
and its jit kernel the same choices, victim sets, commit waves and
explainability counters bit for bit, in every wave mode and with the
shortlist on and off.  The planes cases build one cluster per package
with fixed ids and compare `ev_prio` / `ev_res` / `ev_ids` after a full
pack, after `apply_evict_ops` and after a delta sync.  The scheduler
case runs an overcommitted eval through both packages' harness with a
store-attached solver at the reference's default width 8."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from test_preempt_kernel import assert_preempt_identical, packed_overcommit

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler.harness import Harness as RefHarness
from nomad_tpu.scheduler.preemption import PRIORITY_DELTA as REF_DELTA
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.solver.host import host_solve_kernel
from nomad_tpu.solver.kernel import solve_kernel as ref_solve_kernel
from nomad_tpu.solver.solve import Solver as RefSolver
from nomad_tpu.solver.solve import _kernel_args as ref_kernel_args
from nomad_tpu.state import store as ref_store
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler.harness import Harness as PortHarness
from nomad_tpu_torch.scheduler.preemption import PRIORITY_DELTA
from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver.solve import Solver as PortSolver
from nomad_tpu_torch.solver.solve import _kernel_args, _to_host
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.state import store as port_store
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics


def test_priority_delta_pinned():
    """The kernel keeps its own copy of the scheduler's priority gate;
    it must equal the port's scheduler constant and the reference's."""
    assert port_kernel.EV_PRIORITY_DELTA == PRIORITY_DELTA == REF_DELTA


def _ev_kw(pb):
    return dict(has_preempt=True, ev_res=pb.ev_res, ev_prio=pb.ev_prio,
                ask_prio=pb.ask_prio)


def port_preempt(pb, **kw):
    """The port's solve_kernel with the eviction pass on the reference
    batch's state (planes moved as tensors, as the solver moves them)."""
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    ppb = port_tz.packed_from_numpy(arrays, "cpu")
    res = port_kernel.solve_kernel(*_kernel_args(ppb), has_distinct=False,
                                   **_ev_kw(ppb), **kw)
    return _to_host(res)


def assert_same_kernel(res, ref):
    """assert_preempt_identical plus the wave count and the
    constraint-filter counts."""
    assert_preempt_identical(res, ref)
    np.testing.assert_array_equal(res.cons_filtered,
                                  np.asarray(ref.cons_filtered))
    assert res.n_waves == int(ref.n_waves)


@pytest.mark.parametrize("pallas", ["off", "score", "topk"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eviction_pass_matches_reference(pallas, seed):
    pb, *_ = packed_overcommit(seed, spread=(seed % 2 == 0))
    host = host_solve_kernel(*ref_kernel_args(pb), **_ev_kw(pb))
    assert np.asarray(host.evict).any(), "workload must force evictions"
    res = port_preempt(pb, pallas_mode=pallas)
    assert_same_kernel(res, host)
    ref = ref_solve_kernel(*ref_kernel_args(pb), has_distinct=False,
                           pallas_mode=pallas, **_ev_kw(pb))
    assert_same_kernel(res, ref)
    assert res.n_rescore == int(ref.n_rescore)
    assert res.evict.shape == (pb.p_ask.shape[0], pb.ev_prio.shape[1])
    # a placement the pass committed names its node in slot 0 only
    ev_rows = res.evict.any(axis=1)
    assert res.choice_ok[ev_rows, 0].all()
    assert not res.choice_ok[ev_rows, 1:].any()
    assert (res.commit_wave[ev_rows] >= 0).all()


@pytest.mark.parametrize("pallas", ["off", "topk"])
@pytest.mark.parametrize("shortlist_c", [0, -1])
def test_shortlist_on_off(shortlist_c, pallas):
    pb, *_ = packed_overcommit(3, spread=True)
    host = host_solve_kernel(*ref_kernel_args(pb), **_ev_kw(pb))
    res = port_preempt(pb, shortlist_c=shortlist_c, pallas_mode=pallas)
    assert_same_kernel(res, host)
    ref = ref_solve_kernel(*ref_kernel_args(pb), has_distinct=False,
                           shortlist_c=shortlist_c, pallas_mode=pallas,
                           **_ev_kw(pb))
    assert_same_kernel(res, ref)
    assert res.n_rescore == int(ref.n_rescore)


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_conflict_path_with_evictions(monkeypatch, seed):
    """The sort-based conflict path (K > 2048 on real batches), forced
    at small K, ranks the eviction commits as the [K, K] path does."""
    monkeypatch.setattr(port_kernel, "_FORCE_SORT_CONFLICTS", True)
    pb, *_ = packed_overcommit(seed)
    host = host_solve_kernel(*ref_kernel_args(pb), **_ev_kw(pb))
    assert_same_kernel(port_preempt(pb), host)


def test_evict_width_and_planes_checked():
    pb, *_ = packed_overcommit(0, evict_e=4)
    host = host_solve_kernel(*ref_kernel_args(pb), **_ev_kw(pb))
    res = port_preempt(pb)
    assert res.evict.shape[1] == 4
    assert_same_kernel(res, host)
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    ppb = port_tz.packed_from_numpy(arrays, "cpu")
    with pytest.raises(ValueError, match="distinct_hosts"):
        port_kernel.solve_kernel(*_kernel_args(ppb), has_distinct=True,
                                 **_ev_kw(ppb))
    with pytest.raises(ValueError, match="ev_res"):
        port_kernel.solve_kernel(*_kernel_args(ppb), has_distinct=False,
                                 has_preempt=True)
    with pytest.raises(ValueError, match="evict_e"):
        PortSolver(device="cpu", evict_e=-1)


# ------------------------------------------------------------------
# eviction planes: full pack, apply_evict_ops, delta sync
# ------------------------------------------------------------------
PKGS = {"ref": (ref_mock, ref_structs, ref_tz),
        "port": (port_mock, port_structs, port_tz)}


def plane_world(pkg, seed, n_nodes=12):
    """An overcommitted cluster from `pkg`'s own mock with fixed node and
    alloc ids: (nodes, allocs_by_node, asks).  Random draws are the same
    for both packages."""
    mock, st, tz = PKGS[pkg]
    rng = np.random.default_rng(seed)
    nodes, abn, ci = [], {}, 0
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:03d}", name=f"node-{i}",
                      datacenter=f"dc{i % 3}")
        n.node_resources.cpu = int(rng.choice([3000, 4000, 6000]))
        n.node_resources.memory_mb = 8192
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.compute_class()
        nodes.append(n)
        lst = []
        # up to 11 candidates, beyond the width of 8
        for k in range(int(rng.integers(2, 12))):
            lst.append(low_alloc(pkg, f"low-{i}-{k}", n,
                                 int(rng.choice([5, 10, 20, 30, 45])),
                                 int(rng.choice([400, 700, 900, 1200])),
                                 int(rng.integers(0, 6))))
            ci += 1
        abn[n.id] = lst
    job = mock.job(id="hi", priority=60)
    job.datacenters = ["dc0", "dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = 4
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = 2000
    return nodes, abn, [tz.PlacementAsk(job=job, tg=tg, count=4)]


def low_alloc(pkg, aid, node, prio, cpu, create_index):
    a = PKGS[pkg][0].alloc()
    a.id = aid
    a.node_id = node.id
    a.job.priority = prio
    a.create_index = create_index
    tr = a.allocated_resources.tasks["web"]
    tr.cpu, tr.memory_mb, tr.networks = cpu, cpu * 2, []
    a.allocated_resources.shared.networks = []
    a.allocated_resources.shared.disk_mb = 0
    return a


def planes(pb):
    return (pb.ev_prio.copy(), pb.ev_res.copy(),
            [list(r) for r in pb.ev_ids], np.asarray(pb.ask_prio).copy())


def assert_same_planes(p, r):
    assert p[0].dtype == r[0].dtype == np.int16
    assert p[1].dtype == r[1].dtype == np.float32
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_array_equal(p[1], r[1])
    assert p[2] == r[2]
    np.testing.assert_array_equal(p[3], r[3])


def plane_steps(pkg, seed):
    """The planes after a full pack, after slot-level `apply_evict_ops`
    and after a `delta_pack` / `apply_node_delta_host` sync."""
    mock, st, tz = PKGS[pkg]
    nodes, abn, asks = plane_world(pkg, seed)
    t = tz.Tensorizer()
    pb = t.pack(nodes, asks, abn, evict_e=8)
    out = [planes(pb)]
    # ops: stop the first candidate of node 0 and a mid one of node 3,
    # place a fresh priority-7 alloc on node 1 and a priority-45 one on
    # node 3 (an update arrives as stop + place of one id)
    node_index = {n.id: i for i, n in enumerate(nodes)}
    stops = [(0, abn[nodes[0].id][0]), (3, abn[nodes[3].id][1])]
    moved = copy.deepcopy(abn[nodes[3].id][1])
    moved.allocated_resources.tasks["web"].cpu = 50
    places = [(1, low_alloc(pkg, "new-1", nodes[1], 7, 300, 9)),
              (3, low_alloc(pkg, "new-3", nodes[3], 45, 200, 1)),
              (3, moved)]
    tz.apply_evict_ops(pb, stops, places)
    out.append(planes(pb))
    delta = tz.ClusterDelta()
    delta.stop.append((nodes[2].id, abn[nodes[2].id][0]))
    delta.stop.append((nodes[1].id, places[0][1]))
    delta.place.append((nodes[5].id,
                        low_alloc(pkg, "new-5", nodes[5], 3, 100, 0)))
    nd = t.delta_pack(pb, node_index, delta)
    assert nd is not None
    tz.apply_node_delta_host(pb, nd, nodes, node_index)
    out.append(planes(pb))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_eviction_planes_match_reference(seed):
    port, ref = plane_steps("port", seed), plane_steps("ref", seed)
    for step, (p, r) in enumerate(zip(port, ref)):
        assert_same_planes(p, r)
    # the steps moved the planes
    assert port[0][2] != port[1][2] != port[2][2]
    # a width-0 pack carries none
    nodes, abn, asks = plane_world("port", seed)
    pb = port_tz.Tensorizer().pack(nodes, asks, abn)
    assert pb.ev_prio is None and pb.ev_ids is None


# ------------------------------------------------------------------
# the scheduler commits kernel-chosen (place, evict) pairs
# ------------------------------------------------------------------
def e2e(pkg):
    """tests/test_preempt_kernel.py's end-to-end case, built with fixed
    ids: eight 3000-MHz nodes each full of one priority-10 alloc, then a
    priority-50 job of 2 that places only by evicting.  Returns the
    observation and the `scheduler.preempt.*` counters it moved."""
    mock, st, _tz = PKGS[pkg]
    metrics = ref_metrics if pkg == "ref" else port_metrics
    if pkg == "ref":
        h = RefHarness()
        h.store.set_scheduler_config(h.next_index(),
                                     ref_store.SchedulerConfiguration(
                                         preemption_service=True))
        h.solver = RefSolver(store=h.store, resident_min_nodes=1)
    else:
        h = PortHarness()
        h.store.set_scheduler_config(h.next_index(),
                                     port_store.SchedulerConfiguration(
                                         preemption_service=True))
        h.solver = PortSolver(device="cpu", store=h.store,
                              resident_min_nodes=1, host="never")
    nodes = []
    for i in range(8):
        n = mock.node(id=f"node-{i:03d}", name=f"node-{i}")
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        n.node_resources.cpu = 3000
        n.node_resources.memory_mb = 8192
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
        nodes.append(n)

    def counters():
        return {k: v for k, v in metrics.dump()["counters"].items()
                if k.startswith("scheduler.preempt.")}
    before = counters()
    for jid, prio, count in (("low", 10, 8), ("high", 50, 2)):
        job = mock.job(id=jid, priority=prio)
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = 2500
        tg.tasks[0].resources.memory_mb = 1024
        tg.tasks[0].resources.networks = []
        h.store.upsert_job(h.next_index(), job)
        ev = mock.eval_(job_id=job.id, priority=prio,
                        triggered_by=st.EVAL_TRIGGER_JOB_REGISTER)
        h.process("service", ev)
        allocs = h.store.allocs_by_job("default", job.id)
        for a in allocs:
            a.client_status = st.ALLOC_CLIENT_RUNNING
        h.store.upsert_allocs(h.next_index(), allocs)
    after = counters()
    ix = {n.id: i for i, n in enumerate(nodes)}
    name = {a.id: (a.name, ix[a.node_id]) for a in h.store.allocs()}
    rows = sorted((a.name, ix[a.node_id], a.desired_status,
                   tuple(sorted(name[v] for v in a.preempted_allocations)))
                  for a in h.store.allocs())
    moved = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    trace = [s["attrs"].get("evict_commits") for e in h.evals
             for s in _spans(pkg, e.id) if s["name"] == "solve"]
    return rows, moved, trace, [e.status for e in h.evals]


def _spans(pkg, eval_id):
    if pkg == "ref":
        from nomad_tpu.utils.tracing import global_tracer
    else:
        from nomad_tpu_torch.utils.tracing import global_tracer
    return global_tracer.get(eval_id)


def test_scheduler_inkernel_eviction_end_to_end(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    p_rows, p_moved, p_trace, p_status = e2e("port")
    r_rows, r_moved, r_trace, r_status = e2e("ref")
    assert p_rows == r_rows
    assert p_moved == r_moved
    assert p_moved.get("scheduler.preempt.kernel", 0) >= 1
    assert "scheduler.preempt.host_fallback" not in p_moved
    assert p_status == r_status
    assert p_trace == r_trace
    assert p_trace[-1] == p_moved["scheduler.preempt.kernel"]
    victims = [r for r in p_rows if r[2] == port_structs.ALLOC_DESIRED_EVICT]
    assert len(victims) == p_moved["scheduler.preempt.kernel"]
    assert all(r[3] for r in p_rows if r[0].startswith("high."))
