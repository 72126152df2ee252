"""The port's scheduler path (`nomad_tpu_torch.scheduler`: Harness ->
GenericScheduler -> reconciler -> Solver -> StateStore) against the JAX
package's, on the CPU.

Each scenario of tests/test_generic_sched.py, plus service preemption
(tests/test_preemption.py) and a batch fan-out job whose solve takes the
fused wave's score mode, is built by ONE function for both packages (each
package's own mock, structs and Harness), with the same node ids, names
and addresses and the same job ids; alloc, eval and deployment ids are
fresh uuids, so allocs compare by job and alloc name and nodes by their
index in insertion order.  The port solves with `Solver(device="cpu",
host="never")`, its torch wave loop; the reference with its default
`Solver()`, which routes these small batches to its numpy twin
(placement-identical to its jit kernel, tests/test_host_solver.py), and
with `Solver(host="never")` in one case.  Once more with both packages
on their default route, where both take their numpy twin.
Every scenario runs again with a store-attached solver in both packages
(`Solver(store=h.store, resident_min_nodes=1)`: the resident cluster
world, the plan-apply feed and the lazy allocs-by-node view), once with
no eviction planes (the reference with `NOMAD_TPU_EVICT_E=0`, the port
with `evict_e=0`), where preemption takes the host-side pass, and once
with both at the default width 8, where the kernel's eviction pass
chooses the victims.
Everything the scheduler wrote must be equal: the allocs in the store,
the evals (status, queued allocations, failure metrics), the plans, the
blocked and follow-up evals, the `scheduler.*` and `solver.resident.*`
counters, and the scores within the reference's cross-backend
rel=2e-5."""
import copy
import re
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler.harness import Harness as RefHarness
from nomad_tpu.solver.solve import Solver as RefSolver
from nomad_tpu.state import store as ref_store
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler.base import new_scheduler
from nomad_tpu_torch.scheduler.harness import Harness as PortHarness
from nomad_tpu_torch.solver import wave_kernel as wk
from nomad_tpu_torch.solver.solve import Solver as PortSolver
from nomad_tpu_torch.state import store as port_store
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics


class Pkg:
    """One package's factories, and the solver its harness shares."""

    def __init__(self, name, host="auto", resident=False, evict_e=8,
                 port_host="never"):
        self.name = name
        self.resident = resident
        self.evict_e = evict_e
        if name == "ref":
            self.mock, self.st, self.store, self.Harness = (
                ref_mock, ref_structs, ref_store, RefHarness)
            self.solver = RefSolver(host=host)
        else:
            self.mock, self.st, self.store, self.Harness = (
                port_mock, port_structs, port_store, PortHarness)
            self.solver = PortSolver(device="cpu", host=port_host)
        self.port_host = port_host

    def harness(self):
        h = self.Harness()
        if not self.resident:
            h.solver = self.solver
        elif self.name == "ref":
            h.solver = RefSolver(store=h.store, resident_min_nodes=1)
        else:
            h.solver = PortSolver(device="cpu", store=h.store,
                                  resident_min_nodes=1,
                                  evict_e=self.evict_e,
                                  host=self.port_host)
        return h

    def node(self, i, **kw):
        """Node `i` with a fixed id, name and address."""
        n = self.mock.node(id=f"node-{i:04d}", name=f"node-{i}", **kw)
        n.node_resources.networks[0].ip = f"10.0.{i // 250}.{i % 250 + 1}"
        n.compute_class()
        return n


def setup_cluster(P, h, n_nodes=10, **kw):
    nodes = [P.node(i, **kw) for i in range(n_nodes)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    return nodes


def register_job(P, h, job, trigger=None):
    h.store.upsert_job(h.next_index(), job)
    ev = P.mock.eval_(job_id=job.id, type=job.type,
                      triggered_by=trigger
                      or P.st.EVAL_TRIGGER_JOB_REGISTER)
    h.store.upsert_evals(h.next_index(), [ev])
    return ev


def mark(P, h, allocs, **fields):
    for a in allocs:
        for k, v in fields.items():
            setattr(a, k, v)
    h.store.upsert_allocs(h.next_index(), allocs)


def first_by_name(allocs):
    return min(allocs, key=lambda a: a.name)


# ---------------------------------------------------------------- scenarios
# each returns (harness, nodes, job id or ids); the same code runs for both
# packages

def sc_register_places_all(P):
    h = P.harness()
    nodes = setup_cluster(P, h)
    job = P.mock.job(id="job-register")
    h.process("service", register_job(P, h, job))
    return h, nodes, job.id


def sc_no_nodes_blocks(P):
    h = P.harness()
    job = P.mock.job(id="job-no-nodes")
    h.process("service", register_job(P, h, job))
    return h, [], job.id


def sc_partial_capacity(P):
    h = P.harness()
    nodes = []
    for i in range(2):
        n = P.node(i)
        n.node_resources.cpu = 1200
        n.node_resources.memory_mb = 1024
        n.reserved_resources.cpu = 100
        n.reserved_resources.memory_mb = 0
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
        nodes.append(n)
    job = P.mock.job(id="job-partial")
    for tg in job.task_groups:
        for t in tg.tasks:
            t.resources.networks = []
        tg.count = 6
    h.process("service", register_job(P, h, job))
    return h, nodes, job.id


def sc_scale_down(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 5)
    job = P.mock.job(id="job-scale")
    job.task_groups[0].count = 5
    h.process("service", register_job(P, h, job))
    job2 = P.mock.job(id=job.id)
    job2.task_groups[0].count = 3
    job2.version = 1
    h.process("service", register_job(P, h, job2))
    return h, nodes, job.id


def sc_deregister(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 3)
    job = P.mock.job(id="job-dereg")
    job.task_groups[0].count = 3
    h.process("service", register_job(P, h, job))
    job2 = P.mock.job(id=job.id)
    job2.stop = True
    job2.version = 1
    h.store.upsert_job(h.next_index(), job2)
    ev2 = P.mock.eval_(job_id=job.id,
                       triggered_by=P.st.EVAL_TRIGGER_JOB_DEREGISTER)
    h.process("service", ev2)
    return h, nodes, job.id


def sc_node_down(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 4)
    job = P.mock.job(id="job-node-down")
    job.task_groups[0].count = 4
    job.task_groups[0].reschedule_policy = P.st.ReschedulePolicy(
        unlimited=True, delay_s=0, delay_function="constant")
    h.process("service", register_job(P, h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    victim_node = first_by_name(allocs).node_id
    mark(P, h, allocs, client_status=P.st.ALLOC_CLIENT_RUNNING)
    h.store.update_node_status(h.next_index(), victim_node,
                               P.st.NODE_STATUS_DOWN)
    ev2 = P.mock.eval_(job_id=job.id,
                       triggered_by=P.st.EVAL_TRIGGER_NODE_UPDATE)
    h.process("service", ev2)
    return h, nodes, job.id


def sc_destructive_update(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 6)
    job = P.mock.job(id="job-destructive")
    job.task_groups[0].count = 6
    job.task_groups[0].update = P.st.UpdateStrategy(max_parallel=2)
    h.process("service", register_job(P, h, job))
    for a in sorted(h.store.allocs_by_job("default", job.id),
                    key=lambda a: a.name):
        mark(P, h, [a], client_status=P.st.ALLOC_CLIENT_RUNNING)
    job2 = P.mock.job(id=job.id)
    job2.task_groups[0].count = 6
    job2.task_groups[0].update = P.st.UpdateStrategy(max_parallel=2)
    job2.task_groups[0].tasks[0].config = {"command": "/bin/sleep"}
    job2.version = 1
    h.process("service", register_job(P, h, job2))
    return h, nodes, job.id


def sc_failed_alloc_rescheduled(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 3)
    job = P.mock.job(id="job-resched")
    job.task_groups[0].count = 2
    job.task_groups[0].reschedule_policy = P.st.ReschedulePolicy(
        attempts=3, interval_s=3600, delay_s=0, unlimited=False,
        delay_function="constant")
    h.process("service", register_job(P, h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    victim = first_by_name(allocs)
    victim.client_status = P.st.ALLOC_CLIENT_FAILED
    victim.task_states = {"web": P.st.TaskState(
        state="dead", failed=True, finished_at=time.time())}
    h.store.upsert_allocs(h.next_index(), allocs)
    ev2 = P.mock.eval_(job_id=job.id,
                       triggered_by=P.st.EVAL_TRIGGER_RETRY_FAILED_ALLOC)
    h.process("service", ev2)
    return h, nodes, job.id


def sc_sticky_disk(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 5)
    job = P.mock.job(id="job-sticky")
    job.task_groups[0].count = 1
    job.task_groups[0].ephemeral_disk.sticky = True
    h.process("service", register_job(P, h, job))
    orig = h.store.allocs_by_job("default", job.id)[0]
    mark(P, h, [orig], client_status=P.st.ALLOC_CLIENT_RUNNING)
    job2 = P.mock.job(id=job.id)
    job2.task_groups[0].count = 1
    job2.task_groups[0].ephemeral_disk.sticky = True
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    job2.version = 1
    h.process("service", register_job(P, h, job2))
    return h, nodes, job.id


def sc_plan_rejection(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 2)
    h.reject_plan = True
    job = P.mock.job(id="job-reject")
    job.task_groups[0].count = 1
    h.process("service", register_job(P, h, job))
    return h, nodes, job.id


def sc_batch_runs_once(P):
    h = P.harness()
    nodes = setup_cluster(P, h, 2)
    job = P.mock.batch_job(id="job-batch")
    job.task_groups[0].count = 2
    ev = register_job(P, h, job)
    ev.type = "batch"
    h.process("batch", ev)
    allocs = h.store.allocs_by_job("default", job.id)
    now = time.time()
    for a in allocs:
        a.task_states = {"web": P.st.TaskState(state="dead", failed=False,
                                               finished_at=now)}
    mark(P, h, allocs, client_status=P.st.ALLOC_CLIENT_COMPLETE)
    ev2 = P.mock.eval_(job_id=job.id, type="batch",
                       triggered_by=P.st.EVAL_TRIGGER_JOB_REGISTER)
    h.process("batch", ev2)
    return h, nodes, job.id


def sc_spread_dcs(P):
    h = P.harness()
    nodes = []
    for i in range(4):
        n = P.node(i, datacenter="dc1" if i < 2 else "dc2")
        h.store.upsert_node(h.next_index(), n)
        nodes.append(n)
    job = P.mock.job(id="job-spread")
    job.datacenters = ["dc1", "dc2"]
    job.task_groups[0].count = 4
    job.spreads = [P.st.Spread(attribute="${node.datacenter}", weight=100)]
    h.process("service", register_job(P, h, job))
    return h, nodes, job.id


def sc_batch_score_mode(P):
    """A batch fan-out job whose solve resolves to the fused wave's score
    mode: 4 groups, 520 placements padded to K = 1,024, so the window
    TK = max(32, 2 * 1024 // 8) + 4 = 260 exceeds the topk limit; a
    rack constraint, a rack affinity and a datacenter spread as in
    bench.py's config 3."""
    h = P.harness()
    nodes = []
    for i in range(300):
        n = P.node(i, datacenter=f"dc{i % 4}")
        n.attributes["rack"] = f"r{i % 16}"
        n.node_resources.cpu = 4000 + (i % 8) * 1000
        n.node_resources.memory_mb = 8192 + (i % 4) * 4096
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
        nodes.append(n)
    job = P.mock.batch_job(id="job-fanout")
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints = [P.st.Constraint("${attr.rack}", "r15", "!=")]
    job.affinities = [P.st.Affinity(ltarget="${attr.rack}", rtarget="r7",
                                    operand="=", weight=35)]
    job.spreads = [P.st.Spread(attribute="${node.datacenter}", weight=50)]
    base = job.task_groups[0]
    groups = []
    for g in range(4):
        tg = copy.deepcopy(base)
        tg.name = f"g{g}"
        tg.count = 130
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 400 + g * 150
        t.resources.memory_mb = 256 + g * 128
        groups.append(tg)
    job.task_groups = groups
    ev = register_job(P, h, job)
    h.process("batch", ev)
    return h, nodes, job.id


def sc_preemption(P):
    """Service preemption switched on: a priority-70 job evicts the
    priority-20 allocs that fill small nodes (host-side preemption
    pass, scheduler/preemption.py)."""
    h = P.harness()
    h.store.set_scheduler_config(h.next_index(), P.store.SchedulerConfiguration(
        preemption_service=True))
    nodes = []
    for i in range(3):
        n = P.node(i)
        n.node_resources.cpu = 1200
        n.node_resources.memory_mb = 1024
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
        nodes.append(n)
    jobs = []
    for name, prio, count in (("job-low", 20, 3), ("job-high", 70, 2)):
        job = P.mock.job(id=name, priority=prio)
        job.task_groups[0].count = count
        job.task_groups[0].tasks[0].resources.cpu = 800
        job.task_groups[0].tasks[0].resources.networks = []
        ev = register_job(P, h, job)
        ev.priority = prio
        h.process("service", ev)
        mark(P, h, h.store.allocs_by_job("default", job.id),
             client_status=P.st.ALLOC_CLIENT_RUNNING)
        jobs.append(job.id)
    return h, nodes, tuple(jobs)


SCENARIOS = {
    "register_places_all": sc_register_places_all,
    "no_nodes_blocks": sc_no_nodes_blocks,
    "partial_capacity": sc_partial_capacity,
    "scale_down": sc_scale_down,
    "deregister": sc_deregister,
    "node_down": sc_node_down,
    "destructive_update": sc_destructive_update,
    "failed_alloc_rescheduled": sc_failed_alloc_rescheduled,
    "sticky_disk": sc_sticky_disk,
    "plan_rejection": sc_plan_rejection,
    "batch_runs_once": sc_batch_runs_once,
    "spread_dcs": sc_spread_dcs,
    "preemption": sc_preemption,
}


# ---------------------------------------------------------------- observe
def _metric(m):
    if m is None:
        return None
    return (m.nodes_evaluated, m.nodes_filtered, dict(m.nodes_available),
            dict(m.constraint_filtered), m.nodes_exhausted,
            dict(m.dimension_exhausted), m.coalesced_failures)


def observe(h, nodes, job_ids):
    """Everything the scheduler wrote, with ids replaced by names and
    node indexes; scores apart (compared with a tolerance)."""
    if isinstance(job_ids, str):
        job_ids = (job_ids,)
    ix = {n.id: i for i, n in enumerate(nodes)}
    every = {a.id: a for a in h.store.allocs()}
    for p in h.plans:
        for m in (p.node_update, p.node_allocation, p.node_preemptions):
            for lst in m.values():
                every.update((a.id, a) for a in lst if a.id not in every)

    def aref(aid):
        a = every.get(aid)
        return (a.name, ix.get(a.node_id)) if a is not None else aid

    def text(t):
        return re.sub(r"[0-9a-f]{8}-[0-9a-f-]{27}",
                      lambda m: repr(aref(m.group(0))), t)

    def alloc_row(a):
        rt = a.reschedule_tracker
        return (a.name, a.task_group, ix.get(a.node_id, a.node_id),
                a.desired_status, text(a.desired_description),
                a.client_status,
                aref(a.previous_allocation) if a.previous_allocation
                else None,
                tuple(aref(e.prev_alloc_id) for e in rt.events)
                if rt else None,
                a.deployment_status.canary if a.deployment_status else None,
                tuple(sorted(aref(x) for x in a.preempted_allocations)),
                aref(a.preempted_by_allocation)
                if a.preempted_by_allocation else None,
                a.create_index, a.modify_index)

    job_allocs = [a for j in job_ids
                  for a in h.store.allocs_by_job("default", j)]
    allocs = sorted(alloc_row(a) for a in job_allocs)

    def by_node(m):
        return {ix.get(nid, nid): sorted(alloc_row(a) for a in lst)
                for nid, lst in m.items()}

    def dep(d):
        if d is None:
            return None
        return (d.status, d.job_version, {
            tg: (s.desired_total, s.desired_canaries, s.promoted,
                 s.placed_allocs, s.auto_revert)
            for tg, s in sorted(d.task_groups.items())})

    plans = [(by_node(p.node_update), by_node(p.node_allocation),
              by_node(p.node_preemptions), dep(p.deployment),
              [(u.status, u.status_description)
               for u in p.deployment_updates],
              p.all_at_once, p.annotations)
             for p in h.plans]
    evals = [(e.status, e.status_description, e.type, e.triggered_by,
              dict(e.queued_allocations), bool(e.blocked_eval),
              {tg: _metric(m) for tg, m in e.failed_tg_allocs.items()})
             for e in h.evals]
    created = [(e.status, e.status_description, e.type, e.triggered_by,
                e.job_id, bool(e.wait_until), dict(e.class_eligibility),
                e.escaped_computed_class, bool(e.previous_eval))
               for e in h.create_evals]
    scores = sorted((a.name, a.create_index,
                     sorted(a.metrics.scores.values()),
                     [d["normalized_score"] for d in a.metrics.score_meta])
                    for a in job_allocs)
    return {"allocs": allocs, "plans": plans, "evals": evals,
            "created": created}, scores


def scheduler_counters(metrics, scenario, P):
    """The scenario's observation and the `scheduler.*` and
    `solver.resident.*` counters it moved in the package's metrics
    registry."""
    def counters():
        return {k: v for k, v in metrics.dump()["counters"].items()
                if k.startswith(("scheduler.", "solver.resident."))}
    before = counters()
    out = observe(*scenario(P))
    after = counters()
    return out, {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v != before.get(k, 0.0)}


def assert_same_schedule(scenario, ref_host="auto", resident=False,
                         evict_e=8, port_host="never"):
    """`evict_e` is the port's eviction-plane width; the caller sets the
    reference's through NOMAD_TPU_EVICT_E.  `port_host` is the port
    solver's route ("never": its torch wave loop)."""
    (r, r_scores), r_moved = scheduler_counters(
        ref_metrics, scenario, Pkg("ref", host=ref_host, resident=resident))
    (p, p_scores), p_moved = scheduler_counters(
        port_metrics, scenario, Pkg("port", resident=resident,
                                    evict_e=evict_e, port_host=port_host))
    p["counters"], r["counters"] = p_moved, r_moved
    for key in r:
        assert p[key] == r[key], key
    assert [s[:2] for s in p_scores] == [s[:2] for s in r_scores]
    for ps, rs in zip(p_scores, r_scores):
        assert ps[2] == pytest.approx(rs[2], rel=2e-5, abs=2e-5), ps[0]
        assert ps[3] == pytest.approx(rs[3], rel=2e-5, abs=2e-5), ps[0]
    return p


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    got = assert_same_schedule(SCENARIOS[name])
    assert got["evals"], "the scheduler wrote no eval"
    if name == "preemption":
        assert got["counters"] == {"scheduler.preempt.host_fallback": 2.0}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference_resident(name, monkeypatch):
    """The same comparison with a store-attached solver in both
    packages: the world is built on the first solve and every later eval
    of the scenario takes the resident path."""
    monkeypatch.setenv("NOMAD_TPU_EVICT_E", "0")
    got = assert_same_schedule(SCENARIOS[name], resident=True, evict_e=0)
    assert got["evals"], "the scheduler wrote no eval"
    counters = got["counters"]
    if name != "no_nodes_blocks":
        assert counters.get("solver.resident.rebuild") == 1.0, counters
    if name == "preemption":
        assert counters["scheduler.preempt.host_fallback"] == 2.0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference_resident_evict8(name, monkeypatch):
    """The resident comparison with both worlds carrying eviction planes
    at the default width 8: the preemption scenario's victims are chosen
    by the kernel's eviction pass in both packages."""
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    got = assert_same_schedule(SCENARIOS[name], resident=True, evict_e=8)
    assert got["evals"], "the scheduler wrote no eval"
    counters = got["counters"]
    if name != "no_nodes_blocks":
        assert counters.get("solver.resident.rebuild") == 1.0, counters
    if name == "preemption":
        assert counters["scheduler.preempt.kernel"] == 2.0
        assert "scheduler.preempt.host_fallback" not in counters


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference_default_route(name):
    """Both packages on their default solver route ("auto"), where these
    small batches take each package's numpy twin."""
    got = assert_same_schedule(SCENARIOS[name], port_host="auto")
    assert got["evals"], "the scheduler wrote no eval"


def test_scenario_matches_reference_jit_kernel():
    """The same comparison against the reference's jit kernel instead of
    its numpy twin."""
    assert_same_schedule(sc_spread_dcs, ref_host="never")


def test_batch_fanout_resolves_to_score_mode(monkeypatch):
    """A large batch job through the whole path: with the fused wave
    path switched on as on a GPU (on the CPU "auto" resolves to the
    unfused scorer), the port's solve takes the fused wave's score mode
    (its plain version here), and the schedule equals the reference's."""
    modes = []
    real_wave, real_resolve = wk.fused_wave, wk.resolve_mode

    def wave(**kw):
        modes.append(kw["mode"])
        return real_wave(**kw)
    monkeypatch.setattr(wk, "fused_wave", wave)
    monkeypatch.setattr(wk, "resolve_mode", lambda *a, on=True:
                        real_resolve(*a, on=True))
    got = assert_same_schedule(sc_batch_score_mode)
    assert modes and set(modes) == {"score"}
    placed = [a for a in got["allocs"] if a[2] is not None]
    assert len(placed) == 520
    assert got["evals"][-1][0] == port_structs.EVAL_STATUS_COMPLETE


def test_default_scheduler_needs_cuda(monkeypatch):
    """With no solver given, the scheduler builds a default Solver, which
    runs on CUDA and raises where there is none; nothing falls back to
    the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    h = PortHarness()
    for sched_type in ("service", "batch", "system"):
        with pytest.raises(RuntimeError, match="CUDA"):
            new_scheduler(sched_type, h.store, h)
    job = port_mock.job(id="job-default")
    h.store.upsert_job(h.next_index(), job)
    ev = port_mock.eval_(job_id=job.id)
    with pytest.raises(RuntimeError, match="CUDA"):
        h.process("service", ev)
    assert not h.evals and not h.plans


def test_system_scheduler_is_built():
    """`system` builds the port's SystemScheduler with the given solver;
    `sysbatch` is not a scheduler type of the port."""
    from nomad_tpu_torch.scheduler.system import SystemScheduler
    h = PortHarness()
    solver = PortSolver(device="cpu")
    sched = new_scheduler("system", h.store, h, solver=solver)
    assert isinstance(sched, SystemScheduler) and sched.solver is solver
    with pytest.raises(ValueError):
        new_scheduler("sysbatch", h.store, h, solver=solver)


def test_solve_span_carries_launch_wall():
    """The eval's solve span carries the solver's trace, with
    `dispatch_wall_s` the launch wall alone (the reference's meaning),
    beside `pack_wall_s`."""
    from nomad_tpu_torch.utils.tracing import global_tracer
    P = Pkg("port")
    h = P.harness()
    setup_cluster(P, h, 6)
    job = P.mock.job(id="job-trace")
    job.task_groups[0].count = 3
    ev = register_job(P, h, job)
    h.process("service", ev)
    spans = {s["name"]: s for s in global_tracer.get(ev.id)}
    assert {"schedule.reconcile", "solve"} <= set(spans)
    attrs = spans["solve"]["attrs"]
    assert attrs["n_place"] == 3 and attrs["device"] == "cpu"
    assert 0 < attrs["dispatch_wall_s"] < attrs["kernel_wall_s"]
    assert attrs["pack_wall_s"] + attrs["dispatch_wall_s"] \
        <= attrs["kernel_wall_s"] + 1e-6
    assert len(attrs["placements"]) == 3
