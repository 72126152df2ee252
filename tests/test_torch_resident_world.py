"""The port's store-attached Solver (its resident cluster world) against
the JAX package's, on the CPU.

Each scenario of tests/test_solver_resident_world.py is built by ONE
function for both packages (each package's own mock, structs, store and
Solver), with fixed node ids, names and addresses and fixed job ids.
After every round:

  * the port's resident placements equal the reference's resident
    placements (node ids; scores within the cross-backend rel=2e-5 —
    the reference's default Solver routes these small batches to its
    numpy twin, the port solves with torch on the CPU, `host="never"`),
  * the port's resident placements equal the port's own full pack of
    the same snapshot (node ids, scores to 9 decimals: the reference's
    own criterion, tests/test_solver_resident_world.py:40-57),
  * the world counters equal the reference's, and
  * the template's used0, avail, valid, node_class and node_ids equal
    the reference's template.
"""
import copy

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler.harness import Harness as RefHarness
from nomad_tpu.solver import solve as ref_solve
from nomad_tpu.solver.tensorize import PlacementAsk as RefAsk
from nomad_tpu.state.store import StateStore as RefStore
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler.harness import Harness as PortHarness
from nomad_tpu_torch.solver import solve as port_solve
from nomad_tpu_torch.solver.tensorize import PlacementAsk as PortAsk
from nomad_tpu_torch.state.store import StateStore as PortStore

TEMPLATE_PLANES = ("used0", "avail", "valid", "node_class")


class Pkg:
    """One package's factories and solver constructors."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            self.mock, self.st, self.Store, self.Harness = (
                ref_mock, ref_structs, RefStore, RefHarness)
            self.solve, self.Ask = ref_solve, RefAsk
        else:
            self.mock, self.st, self.Store, self.Harness = (
                port_mock, port_structs, PortStore, PortHarness)
            self.solve, self.Ask = port_solve, PortAsk

    def full_solver(self):
        if self.name == "ref":
            return ref_solve.Solver()
        return port_solve.Solver(device="cpu", host="never")

    def resident_solver(self, store):
        if self.name == "ref":
            return ref_solve.Solver(store=store, resident_min_nodes=1)
        return port_solve.Solver(device="cpu", store=store,
                                 resident_min_nodes=1, host="never")

    def node(self, key, rack=None):
        """A node with a fixed id, name and address (tests/
        test_solver_resident_world.py _mk_node's resources)."""
        i = key if isinstance(key, int) else 100 + len(key)
        n = self.mock.node(id=f"node-{key}", name=f"node-{key}")
        n.node_resources.networks[0].ip = f"10.1.{i // 250}.{i % 250 + 1}"
        if rack is not None:
            n.attributes["rack"] = rack
        n.node_resources.cpu = 8000
        n.node_resources.memory_mb = 16384
        n.compute_class()
        return n

    def alloc(self, job, node_id, cpu, mem):
        a = self.mock.alloc()
        a.node_id = node_id
        a.job_id, a.namespace = job.id, job.namespace
        tr = a.allocated_resources.tasks["web"]
        tr.cpu, tr.memory_mb, tr.networks = cpu, mem, []
        return a


def _asks(P, job):
    return [P.Ask(job=job, tg=tg, count=tg.count) for tg in job.task_groups]


def _eager_allocs(snapshot, nodes):
    out = {}
    for n in nodes:
        live = [a for a in snapshot.allocs_by_node(n.id)
                if not a.terminal_status()]
        if live:
            out[n.id] = live
    return out


def _placements(out):
    return [(p.ask_index, p.node.id if p.node is not None else None,
             p.score) for p in out.placements]


def _solve_round(P, resident, store, job):
    """The same snapshot through the resident path and a FRESH full-pack
    solver; returns (resident placements, full placements, world view)."""
    snapshot = store.snapshot()
    nodes, by_dc = snapshot.ready_nodes_in_dcs(job.datacenters)
    abn = _eager_allocs(snapshot, nodes)
    asks = _asks(P, job)
    full = P.full_solver().solve(nodes, asks, abn, by_dc)
    res = resident.solve(nodes, asks, abn, by_dc, snapshot=snapshot,
                         proposed_delta=((), ()))
    return _placements(res), _placements(full), world_view(resident)


def world_view(solver):
    """The world's counters and the compared template planes."""
    world = solver._world
    if world is None:
        return None
    t = world.template
    return {"counters": solver.resident_counters(),
            "node_ids": list(t.node_ids), "n_real": t.n_real,
            **{k: getattr(t, k).copy() for k in TEMPLATE_PLANES}}


def assert_rounds_match(port_rounds, ref_rounds):
    assert len(port_rounds) == len(ref_rounds)
    for k, ((p_res, p_full, p_world), (r_res, _r_full, r_world)) in \
            enumerate(zip(port_rounds, ref_rounds)):
        # the port's resident path equals its own full pack exactly
        assert [(g, n, round(s, 9)) for g, n, s in p_res] == \
            [(g, n, round(s, 9)) for g, n, s in p_full], f"round {k}"
        # ... and the reference's resident path
        assert [(g, n) for g, n, _ in p_res] == \
            [(g, n) for g, n, _ in r_res], f"round {k}"
        assert [s for *_, s in p_res] == pytest.approx(
            [s for *_, s in r_res], rel=2e-5, abs=2e-5), f"round {k}"
        assert (p_world is None) == (r_world is None), f"round {k}"
        if p_world is None:
            continue
        assert p_world["counters"] == r_world["counters"], f"round {k}"
        assert p_world["node_ids"] == r_world["node_ids"], f"round {k}"
        assert p_world["n_real"] == r_world["n_real"], f"round {k}"
        for name in TEMPLATE_PLANES:
            np.testing.assert_array_equal(p_world[name], r_world[name],
                                          err_msg=f"round {k}: {name}")


# ---------------------------------------------------------------- scenarios
def sc_tracks_store_changes(P):
    """tests/test_solver_resident_world.py:60: placements through the
    store, a client terminal update, a drain, a join inside the
    universe, and a join with an unseen attr value (full rebuild)."""
    store = P.Store()
    ix = [100]

    def nix():
        ix[0] += 1
        return ix[0]

    nodes = []
    for i in range(10):
        n = P.node(i, rack=f"r{i % 4}")
        store.upsert_node(nix(), n)
        nodes.append(n)
    resident = P.resident_solver(store)
    job = P.mock.job(id="job-world")
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.networks = []
    job.constraints = list(job.constraints) + [
        P.st.Constraint("${attr.rack}", "r-none", "!=")]
    store.upsert_job(nix(), job)
    rounds = [_solve_round(P, resident, store, job)]          # fresh

    allocs = [P.alloc(job, nodes[k % 5].id, 1500, 1024) for k in range(6)]
    store.upsert_allocs(nix(), allocs)                        # placed
    rounds.append(_solve_round(P, resident, store, job))

    upd = copy.copy(allocs[0])
    upd.client_status = P.st.ALLOC_CLIENT_FAILED
    store.update_allocs_from_client(nix(), [upd])             # freed
    rounds.append(_solve_round(P, resident, store, job))

    store.update_node_eligibility(nix(), nodes[1].id,
                                  P.st.NODE_SCHED_INELIGIBLE)  # drained
    rounds.append(_solve_round(P, resident, store, job))

    store.upsert_node(nix(), P.node("join", rack="r2"))       # joined
    rounds.append(_solve_round(P, resident, store, job))

    store.upsert_node(nix(), P.node("weird", rack="r-unseen"))
    rounds.append(_solve_round(P, resident, store, job))      # rebuilt
    return rounds


def test_resident_world_tracks_store_changes():
    ref = sc_tracks_store_changes(Pkg("ref"))
    port = sc_tracks_store_changes(Pkg("port"))
    assert_rounds_match(port, ref)
    counters = [w["counters"] for _r, _f, w in port]
    assert counters[1]["delta_syncs"] >= 1
    assert counters[3]["repack_fallbacks"] == 0
    assert counters[5]["repack_fallbacks"] >= 1
    # the drained node is a valid=False slot, the join a tail slot
    drained = port[3][2]["node_ids"].index("node-1")
    assert not port[3][2]["valid"][drained]
    assert port[4][2]["node_ids"][-1] == "node-join"


def sc_plan_feed_dedup(P):
    """tests/test_solver_resident_world.py:131: a plan result fed
    eagerly AND written to the store is charged once."""
    store = P.Store()
    ix = [100]

    def nix():
        ix[0] += 1
        return ix[0]

    for i in range(8):
        store.upsert_node(nix(), P.node(i, rack=f"r{i % 4}"))
    resident = P.resident_solver(store)
    job = P.mock.job(id="job-feed")
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].resources.networks = []
    store.upsert_job(nix(), job)
    rounds = [_solve_round(P, resident, store, job)]
    world = resident._world
    used_before = world.template.used0.copy()

    a = P.alloc(job, "node-3", 1000, 512)
    store.upsert_allocs(nix(), [a])
    resident.note_plan_result(None, P.st.PlanResult(
        node_allocation={a.node_id: [a]}))
    fed = world_view(resident)
    world.sync(store.snapshot())
    synced = world_view(resident)
    slot = world.node_index[a.node_id]
    delta_cpu = float((world.template.used0 - used_before)[slot, 0])
    rounds.append(_solve_round(P, resident, store, job))
    return rounds, fed, synced, delta_cpu


def test_resident_world_plan_feed_and_changelog_dedup():
    r_rounds, r_fed, r_synced, r_cpu = sc_plan_feed_dedup(Pkg("ref"))
    p_rounds, p_fed, p_synced, p_cpu = sc_plan_feed_dedup(Pkg("port"))
    assert_rounds_match(p_rounds, r_rounds)
    for p, r in ((p_fed, r_fed), (p_synced, r_synced)):
        assert p["counters"] == r["counters"]
        for name in TEMPLATE_PLANES:
            np.testing.assert_array_equal(p[name], r[name], err_msg=name)
    assert p_cpu == r_cpu == pytest.approx(1000.0)    # charged exactly once
    assert p_fed["counters"]["plan_feeds"] == 1


def sc_lazy_view(P):
    """tests/test_solver_resident_world.py:168: point reads before
    materialization, a mutation that sticks, full iteration."""
    store = P.Store()
    nodes = []
    for i in range(4):
        n = P.node(i, rack=f"r{i % 4}")
        store.upsert_node(100 + i, n)
        nodes.append(n)
    job = P.mock.job(id="job-lazy")
    allocs = []
    for k in range(5):
        a = P.mock.alloc()
        a.node_id = nodes[k % 3].id
        a.job_id = job.id
        a.name = f"alloc-{k}"
        allocs.append(a)
    store.upsert_allocs(200, allocs)
    snap = store.snapshot()
    view = P.solve.LazyAllocsView(snap, {allocs[0].id})
    reads = (sorted(a.name for a in view.get(nodes[0].id) or ()),
             nodes[3].id in view)
    view.setdefault(nodes[3].id, []).append(allocs[0])
    full = {k: sorted(a.name for a in v) for k, v in view.items()}
    return reads, full


def test_lazy_allocs_view_matches_reference_and_eager():
    r_reads, r_full = sc_lazy_view(Pkg("ref"))
    p_reads, p_full = sc_lazy_view(Pkg("port"))
    assert p_reads == r_reads == (["alloc-3"], False)
    assert p_full == r_full == {
        "node-0": ["alloc-3"], "node-1": ["alloc-1", "alloc-4"],
        "node-2": ["alloc-2"], "node-3": ["alloc-0"]}


def sc_changelog(P):
    """tests/test_solver_resident_world.py:200."""
    store = P.Store()
    n = P.node(0)
    store.upsert_node(101, n)
    store.update_node_eligibility(105, n.id, P.st.NODE_SCHED_INELIGIBLE)
    out = [store.changes_since(100, 105), store.changes_since(101, 104)]
    store.changelog.floor = 103
    out += [store.changes_since(102, 105), store.changes_since(103, 105)]
    return out


def test_changelog_window_and_truncation():
    got = sc_changelog(Pkg("port"))
    assert got == sc_changelog(Pkg("ref"))
    assert got == [[(101, "node", "node-0"), (105, "node", "node-0")], [],
                   None, [(105, "node", "node-0")]]


def sc_harness(P):
    """tests/test_solver_resident_world.py:214: the eval stream through
    the harness with a store-attached solver; the scale-up eval runs the
    delta path (plan feed), not a re-pack."""
    h = P.Harness()
    ns = []
    for i in range(10):
        n = P.node(i, rack=f"r{i % 4}")
        h.store.upsert_node(h.next_index(), n)
        ns.append(n)
    h.solver = P.resident_solver(h.store)
    ix = {n.id: i for i, n in enumerate(ns)}
    out = []
    for count in (6, 9):
        job = P.mock.job(id="job-harness")
        job.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), job)
        ev = P.mock.eval_(job_id=job.id, type=job.type,
                          triggered_by=P.st.EVAL_TRIGGER_JOB_REGISTER)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process("service", ev)
        live = sorted((a.name, ix[a.node_id])
                      for a in h.store.allocs_by_job("default", job.id)
                      if not a.terminal_status())
        out.append((live, world_view(h.solver)))
    return out


def test_harness_end_to_end_with_resident_solver():
    ref = sc_harness(Pkg("ref"))
    port = sc_harness(Pkg("port"))
    for (p_live, p_world), (r_live, r_world) in zip(port, ref):
        assert p_live == r_live
        assert p_world["counters"] == r_world["counters"]
        for name in TEMPLATE_PLANES:
            np.testing.assert_array_equal(p_world[name], r_world[name],
                                          err_msg=name)
    assert [len(live) for live, _ in port] == [6, 9]
    counters = port[-1][1]["counters"]
    assert counters["plan_feeds"] >= 1
    assert counters["repack_fallbacks"] == 0


def test_default_store_attached_solver_needs_cuda(monkeypatch):
    """A store-attached Solver with no device runs on CUDA or raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_solve.Solver(store=PortStore())
    solver = port_solve.Solver(device="cpu", store=PortStore())
    assert solver.device.type == "cpu"
    assert port_solve.RESIDENT_MIN_NODES == ref_solve.RESIDENT_MIN_NODES


def test_resident_eval_reads_only_touched_nodes(monkeypatch):
    """On the resident path a service eval reads allocs by node through
    the lazy view and never materializes it: the solve's usage comes from
    the world, the fixup reads only the chosen nodes."""
    calls = []
    real = port_solve.LazyAllocsView.materialize

    def materialize(self):
        calls.append(len(self._filled))
        return real(self)
    monkeypatch.setattr(port_solve.LazyAllocsView, "materialize",
                        materialize)
    P = Pkg("port")
    out = sc_harness(P)
    assert [len(live) for live, _ in out] == [6, 9]
    assert out[-1][1]["counters"]["plan_feeds"] >= 1
    assert calls == []
