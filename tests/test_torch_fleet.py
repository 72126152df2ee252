"""The port's fused fleet round (`nomad_tpu_torch.scheduler.fleet`)
against the JAX package's, on the CPU, through each package's own
`Server`.

Each scenario builds the same cluster and jobs (fixed node and job ids)
in `Server(num_workers=0)` — the port's with `device="cpu"` — starts
it, dequeues one batch from the broker and runs `process_fleet` with a
`Worker` as the planner: the scenarios of tests/test_fleet.py (many jobs
in one solve; two jobs racing for one node's capacity), and a 600-node
race where the workers' store-attached solvers keep the resident world
in both packages (600 nodes is above `RESIDENT_MIN_NODES`).  The
placements of each job (alloc name -> node index), every eval's status,
the blocked-eval stats and the broker's unacked count must be equal.
A fused round whose evals all have preemption on runs the kernel's
eviction pass on the resident world (its eviction planes at the default
width 8 in both packages): 600 nodes, each full with one low-priority
running alloc entered through raft, and three priority-70 jobs that
place only by evicting; the victims and every alloc's
`preempted_allocations` must be equal too.  The coordinator's
lane-former hook reorders a drain round's members at the lane
controller's width in both packages."""
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler.fleet import process_fleet as ref_process_fleet
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.worker import Worker as RefWorker
from nomad_tpu.utils import codec as ref_codec
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler.fleet import process_fleet
from nomad_tpu_torch.server.server import Server
from nomad_tpu_torch.server.worker import Worker
from nomad_tpu_torch.utils import codec as port_codec
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics

PKGS = {"ref": (ref_mock, ref_structs, RefServer, RefWorker,
                ref_process_fleet, ref_codec, ref_metrics),
        "port": (port_mock, port_structs, Server, Worker, process_fleet,
                 port_codec, port_metrics)}


class Fleet:
    """One package's server, with a fixed-identity builder."""

    def __init__(self, pkg):
        self.pkg = pkg
        (self.mock, self.st, ServerCls, self.Worker,
         self.process_fleet, self.codec, self.metrics) = PKGS[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        self.server = ServerCls(num_workers=0, **kw)

    def node(self, i, cpu=None, mem=None):
        n = self.mock.node(id=f"node-{i:04d}", name=f"node-{i}")
        n.node_resources.networks[0].ip = f"10.0.{i // 250}.{i % 250 + 1}"
        if cpu is not None:
            n.node_resources.cpu = cpu
            n.node_resources.memory_mb = mem
            n.reserved_resources.cpu = 100
            n.reserved_resources.memory_mb = 0
        n.compute_class()
        return n

    def job(self, i, count, cpu=None, priority=50):
        j = self.mock.job(id=f"job-{i}", priority=priority)
        tg = j.task_groups[0]
        tg.count = count
        if cpu is not None:
            tg.tasks[0].resources.cpu = cpu
            tg.tasks[0].resources.networks = []
        return j

    def fill(self, nodes, cpu=800, priority=20):
        """One running alloc of a low-priority job on every node, entered
        as raft entries (the job, then one plan result) before start()."""
        to_wire = self.codec.to_wire
        low = self.job("low", len(nodes), cpu=cpu, priority=priority)
        s = self.server
        s._propose("job_upsert", {"job": to_wire(low)})
        result = self.st.PlanResult()
        for i, n in enumerate(nodes):
            a = self.mock.alloc()
            a.id = f"low-{i:04d}"
            a.name = f"{low.id}.web[{i}]"
            a.job_id, a.job, a.node_id = low.id, None, n.id
            a.client_status = self.st.ALLOC_CLIENT_RUNNING
            tr = a.allocated_resources.tasks["web"]
            tr.cpu, tr.memory_mb, tr.networks = cpu, 256, []
            a.allocated_resources.shared.networks = []
            result.node_allocation.setdefault(n.id, []).append(a)
        s._propose("plan_result", {"result": to_wire(result),
                                   "job": to_wire(low)})

    def run(self, nodes, jobs, preempt=False, fill=False):
        s = self.server
        node_ids = [n.id for n in nodes]
        for n in nodes:
            s.register_node(n)
        if fill:
            self.fill(nodes)
        if preempt:
            s._propose("scheduler_config", {"config": {
                "preemption_service_enabled": True}})
        s.start()
        evals = [s.register_job(j) for j in jobs]
        batch = s.broker.dequeue_batch(["service"], 64, 1.0)
        assert len(batch) == len(jobs)
        worker = self.Worker(s, ["service"])
        self.process_fleet(s, worker, batch)
        placements = {
            j.id: sorted((a.name, node_ids.index(a.node_id))
                         for a in s.store.allocs_by_job("default", j.id))
            for j in jobs}
        statuses = [s.store.eval_by_id(e.id).status for e in evals]
        blocked = s.blocked_evals.stats()
        evicted = sorted(a.id for a in s.store.allocs()
                         if a.desired_status == self.st.ALLOC_DESIRED_EVICT)
        preempted = sorted((a.name, tuple(a.preempted_allocations))
                           for j in jobs
                           for a in s.store.allocs_by_job("default", j.id))
        return {"placements": placements, "statuses": statuses,
                "evicted": evicted, "preempted": preempted,
                "blocked": (blocked["total_blocked"],
                            blocked["total_escaped"]),
                "unacked": s.broker.stats()["total_unacked"]}, worker


def sc_many_jobs_one_solve(F):
    nodes = [F.node(i) for i in range(6)]
    return F.run(nodes, [F.job(i, 3) for i in range(5)])


def sc_capacity_race(F):
    """tests/test_fleet.py:39: two jobs racing for one node's capacity
    in the same fused solve; only one fits, the other blocks."""
    nodes = [F.node(0, cpu=1300, mem=1024)]
    return F.run(nodes, [F.job(i, 1, cpu=700) for i in range(2)])


def sc_resident_capacity_race(F):
    """600 small nodes (1,200 usable cpu each) and three jobs of 250
    placements at 700 cpu: 750 asks for 600 slots in one fused solve on
    the resident world."""
    nodes = [F.node(i, cpu=1300, mem=4096) for i in range(600)]
    return F.run(nodes, [F.job(i, 250, cpu=700) for i in range(3)])


def sc_resident_preemption_round(F):
    """600 nodes of 1,200 usable cpu, each holding one priority-20 alloc
    of 800 cpu, and three priority-70 jobs of 4 placements at 700 cpu:
    every placement needs an eviction, chosen in the fused round by the
    kernel's eviction pass."""
    nodes = [F.node(i, cpu=1300, mem=4096) for i in range(600)]
    return F.run(nodes, [F.job(i, 4, cpu=700, priority=70)
                         for i in range(3)], preempt=True, fill=True)


SCENARIOS = {"many_jobs_one_solve": sc_many_jobs_one_solve,
             "capacity_race": sc_capacity_race,
             "resident_capacity_race": sc_resident_capacity_race}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_round_matches_reference(name):
    out = {}
    for pkg in ("ref", "port"):
        F = Fleet(pkg)
        try:
            out[pkg], worker = SCENARIOS[name](F)
            resident = worker._solver.resident_counters()
        finally:
            F.server.stop()
        assert out[pkg]["unacked"] == 0
        assert (resident is not None) == name.startswith("resident"), pkg
    assert out["port"] == out["ref"]
    placed = sum(len(v) for v in out["port"]["placements"].values())
    if name == "capacity_race":
        assert placed == 1 and sum(out["port"]["blocked"]) == 1
    if name == "resident_capacity_race":
        assert placed == 600 and sum(out["port"]["blocked"]) >= 1


def test_fused_round_with_preemption_matches_reference(monkeypatch):
    """The fused round with preemption on: the kernel's eviction pass
    chooses every victim in both packages (no host walk), and the
    placements, victims and `preempted_allocations` are equal."""
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    out, moved = {}, {}
    for pkg in ("ref", "port"):
        F = Fleet(pkg)

        def counters():
            return {k: v for k, v in F.metrics.dump()["counters"].items()
                    if k.startswith("scheduler.preempt.")}
        try:
            before = counters()
            out[pkg], worker = sc_resident_preemption_round(F)
            after = counters()
            assert worker._solver.resident_counters() is not None, pkg
        finally:
            F.server.stop()
        moved[pkg] = {k: v - before.get(k, 0.0) for k, v in after.items()
                      if v != before.get(k, 0.0)}
    assert out["port"] == out["ref"]
    assert moved["port"] == moved["ref"]
    assert moved["port"] == {"scheduler.preempt.kernel": 12.0}
    assert len(out["port"]["evicted"]) == 12
    assert all(v for _name, v in out["port"]["preempted"])
    assert out["port"]["statuses"] == ["complete"] * 3


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_coordinator_lane_former_reorders_drain_round(pkg):
    """The drain leader passes each fused round's combined member list
    through `lane_former` at the lane controller's width before
    dispatch (`SolveCoordinator(lane_former=, lane_controller=)`, the
    reference's `tests/test_lane_stream.py` case), in both packages."""
    if pkg == "ref":
        from nomad_tpu.scheduler import fleet
    else:
        from nomad_tpu_torch.scheduler import fleet
    calls = {}

    def former(members, width):
        calls["width"] = width
        calls["n"] = len(members)
        return list(reversed(members))

    got = []

    def solve_fn(_server, _worker, combined):
        got.extend(combined)

    ctrl = fleet.LaneWidthController(max_width=8, start=4)
    coord = fleet.SolveCoordinator(None, max_fused=16, solve_fn=solve_fn,
                                   lane_former=former, lane_controller=ctrl)
    coord.pause()
    subs = [coord.submit_nowait(f"w{i}", [(f"ev{i}", f"tok{i}")])
            for i in range(3)]
    coord.resume()
    for s in subs:
        assert s.done.wait(10.0)
        assert s.error is None
    assert calls == {"width": 4, "n": 3}
    assert got == [("ev2", "tok2"), ("ev1", "tok1"), ("ev0", "tok0")]
