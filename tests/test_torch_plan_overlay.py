"""The port's what-if plan view (`Solver.plan_view()`,
`PlanSolverView`, `solve(_overlay_only=True)`) against the JAX
package's, on the CPU.

Each case of `tests/test_plan_overlay.py` runs on both packages (`pkg` =
"ref" / "port"): a harness whose store-attached solver keeps a resident
world, and the `/v1/job/:id/plan` dry run (`_DryRunPlanner` + the
scheduler over the plan view).  The reference runs as its own tests
run it; the port's solver runs the wave loop on the CPU (`host="never"`,
so the plain `fused_wave` the CUDA kernels are held against).  Within
each package the world's carried planes, live-alloc map, index and
eviction rows stay bit-identical under plans; across packages the plans'
annotations, their victim counts and the final stores (nodes by
insertion index) are equal.  Two cases of the port alone: a plan's
batch shares no memory with the resident template, and a plan result
fed into the world while a plan solve runs changes nothing that solve
reads."""
import types

import numpy as np
import pytest

from tests.test_torch_http_api import PKG_NAMES, Outcomes


def overlay_pkg(name):
    if name == "ref":
        from nomad_tpu import mock, structs
        from nomad_tpu.api.http_server import _DryRunPlanner
        from nomad_tpu.scheduler.base import new_scheduler
        from nomad_tpu.scheduler.harness import Harness
        from nomad_tpu.solver import solve
        from nomad_tpu.state.store import SchedulerConfiguration
        from nomad_tpu.utils.codec import to_wire
        kw = {}
    else:
        from nomad_tpu_torch import mock, structs
        from nomad_tpu_torch.api.http_server import _DryRunPlanner
        from nomad_tpu_torch.scheduler.base import new_scheduler
        from nomad_tpu_torch.scheduler.harness import Harness
        from nomad_tpu_torch.solver import solve
        from nomad_tpu_torch.state.store import SchedulerConfiguration
        from nomad_tpu_torch.utils.codec import to_wire
        kw = {"device": "cpu", "host": "never"}
    return types.SimpleNamespace(
        name=name, mock=mock, structs=structs, planner=_DryRunPlanner,
        new_scheduler=new_scheduler, Harness=Harness, solve=solve,
        SchedulerConfiguration=SchedulerConfiguration, to_wire=to_wire,
        solver_kw=kw)


def add_nodes(P, h, n=8, cpu=3000):
    for i in range(n):
        node = P.mock.node(id=f"node-{i:03d}", name=f"node-{i}")
        node.node_resources.cpu = cpu
        node.node_resources.memory_mb = 8192
        node.reserved_resources.cpu = 0
        node.reserved_resources.memory_mb = 0
        node.compute_class()
        h.store.upsert_node(h.next_index(), node)


def mk_job(P, jid, priority, count, cpu):
    j = P.mock.job(priority=priority)
    j.id = j.name = jid
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = 512
    tg.tasks[0].resources.networks = []
    return j


def register(P, h, job):
    h.store.upsert_job(h.next_index(), job)
    h.process("service", P.mock.eval_(
        job_id=job.id,
        triggered_by=P.structs.EVAL_TRIGGER_JOB_REGISTER))


def plan(P, h, job):
    """The job_plan endpoint's dry run over the worker solver's plan
    view."""
    st = P.structs
    planner = P.planner(h.store)
    snap = h.store.snapshot()
    job.version = 0
    snap._t["jobs"] = dict(snap._t["jobs"])
    snap._t["jobs"][(job.namespace, job.id)] = job
    ev = st.Evaluation(namespace=job.namespace, job_id=job.id,
                       type=job.type, priority=job.priority,
                       triggered_by=st.EVAL_TRIGGER_JOB_REGISTER,
                       status=st.EVAL_STATUS_PENDING, annotate_plan=True)
    view = h.solver.plan_view()
    assert isinstance(view, P.solve.PlanSolverView)
    sched = P.new_scheduler("service", snap, planner, solver=view)
    assert sched.process(ev) is None
    return planner


def fingerprint(solver):
    w = solver._world
    assert w is not None
    t = w.template
    arrays = {"avail": t.avail, "used0": t.used0,
              "dev_used0": t.dev_used0, "valid": t.valid,
              "attr_rank": t.attr_rank, "reserved": t.reserved}
    if t.ev_prio is not None:
        arrays["ev_prio"] = t.ev_prio
        arrays["ev_res"] = t.ev_res
    return ({k: np.array(v, copy=True) for k, v in arrays.items()},
            sorted(w.live), w.last_index, list(t.node_ids),
            None if t.ev_ids is None else [list(r) for r in t.ev_ids])


def assert_fp_equal(a, b):
    arrs_a, *rest_a = a
    arrs_b, *rest_b = b
    assert rest_a == rest_b
    for k in arrs_a:
        np.testing.assert_array_equal(arrs_a[k], arrs_b[k], err_msg=k)


def harness(P):
    h = P.Harness()
    h.store.set_scheduler_config(h.next_index(), P.SchedulerConfiguration(
        preemption_service=True))
    h.solver = P.solve.Solver(store=h.store, resident_min_nodes=1,
                              **P.solver_kw)
    add_nodes(P, h)
    return h


def filled(P):
    """A cluster filled by a low-priority job whose allocs run, plus a
    second job that builds and syncs the world."""
    h = harness(P)
    register(P, h, mk_job(P, "low", 10, 8, 2500))
    for a in h.store.allocs_by_job("default", "low"):
        a.client_status = P.structs.ALLOC_CLIENT_RUNNING
        h.store.upsert_allocs(h.next_index(), [a])
    register(P, h, mk_job(P, "seed", 50, 1, 100))
    return h


def annotations(P, planner):
    return [P.to_wire(p.annotations) for p in planner.plans]


def victims(planner):
    return [a for p in planner.plans
            for allocs in p.node_preemptions.values() for a in allocs]


def slot_of(h):
    return {nid: i for i, nid in
            enumerate(h.solver._world.template.node_ids)}


# ------------------------------------------------------------- cases
def case_plan_overlay_never_mutates_world(P):
    h = filled(P)
    fp = fingerprint(h.solver)
    n_allocs = len(h.store.allocs())
    out = []
    for i, (prio, count, cpu) in enumerate(
            [(50, 2, 2500),     # needs in-kernel evictions
             (60, 8, 2500),     # needs many evictions
             (50, 4, 100),      # places normally
             (50, 64, 9000)]):  # infeasible everywhere
        planner = plan(P, h, mk_job(P, f"whatif-{i}", prio, count, cpu))
        assert planner.plans, "dry run must produce a plan"
        assert_fp_equal(fp, fingerprint(h.solver))
        out.append((annotations(P, planner), len(victims(planner))))
    assert len(h.store.allocs()) == n_allocs
    return out


def case_plan_reports_evictions_without_committing(P):
    h = filled(P)
    fp = fingerprint(h.solver)
    planner = plan(P, h, mk_job(P, "whatif", 50, 2, 2500))
    preempted = victims(planner)
    assert preempted, "what-if plan must surface its victim set"
    assert_fp_equal(fp, fingerprint(h.solver))
    for v in preempted:     # store untouched: victims still running
        assert h.store.alloc_by_id(v.id).desired_status != \
            P.structs.ALLOC_DESIRED_EVICT
    slot = slot_of(h)
    return annotations(P, planner), sorted(
        (v.job_id, slot[v.node_id]) for v in preempted)


def case_random_plan_solve_interleavings(P):
    rng = np.random.default_rng(7)
    steps = []
    for i in range(6):
        steps.append((f"job-{i}", int(rng.choice([10, 30, 50, 60])),
                      int(rng.integers(1, 4)),
                      int(rng.choice([300, 900, 2500]))))

    def drive(with_plans):
        h = harness(P)
        register(P, h, mk_job(P, "low", 10, 8, 2200))
        for a in h.store.allocs_by_job("default", "low"):
            a.client_status = P.structs.ALLOC_CLIENT_RUNNING
            h.store.upsert_allocs(h.next_index(), [a])
        anns = []
        for i, (jid, prio, count, cpu) in enumerate(steps):
            if with_plans:
                anns.append(annotations(P, plan(
                    P, h, mk_job(P, f"wi-{i}a", 55, 2, 2400))))
            register(P, h, mk_job(P, jid, prio, count, cpu))
            if with_plans:
                anns.append(annotations(P, plan(
                    P, h, mk_job(P, f"wi-{i}b", 60, 1, 500))))
        return h, anns

    (h_ctl, _), (h_mix, anns) = drive(False), drive(True)
    fp_ctl, fp_mix = fingerprint(h_ctl.solver), fingerprint(h_mix.solver)
    for k in fp_ctl[0]:
        np.testing.assert_array_equal(fp_ctl[0][k], fp_mix[0][k],
                                      err_msg=k)
    assert len(fp_ctl[1]) == len(fp_mix[1])          # live allocs
    occupancy = [[len([x for x in row if x]) for row in (fp[4] or [])]
                 for fp in (fp_ctl, fp_mix)]
    assert occupancy[0] == occupancy[1]

    def by_slot(h):
        slot = slot_of(h)
        return sorted((a.job_id, slot.get(a.node_id, -1),
                       a.client_status, a.desired_status)
                      for a in h.store.allocs())

    assert by_slot(h_ctl) == by_slot(h_mix)
    return anns, by_slot(h_mix), occupancy[1]


OUTCOMES = Outcomes({
    "plan_overlay_never_mutates_world":
        case_plan_overlay_never_mutates_world,
    "plan_reports_evictions_without_committing":
        case_plan_reports_evictions_without_committing,
    "random_plan_solve_interleavings": case_random_plan_solve_interleavings,
}, make=overlay_pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_plan_overlay_never_mutates_world(pkg):
    out = OUTCOMES.check("plan_overlay_never_mutates_world", pkg)
    assert out[0][1] > 0 and out[1][1] > 0     # victims selected
    assert out[2][1] == 0


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_plan_reports_evictions_without_committing(pkg):
    anns, preempted = OUTCOMES.check(
        "plan_reports_evictions_without_committing", pkg)
    assert preempted and all(j == "low" for j, _ in preempted)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_random_plan_solve_interleavings_bit_identical(pkg):
    anns, allocs, _occ = OUTCOMES.check("random_plan_solve_interleavings",
                                        pkg)
    assert len(anns) == 12 and allocs


# ------------------------------------------------- the port's plan batch
def plan_batches(monkeypatch, h, feed=None):
    """Run one what-if plan on the port, capturing each batch the solve
    routes to the kernel; `feed(pb)` runs between the pack and the
    kernel (another thread's plan result landing meanwhile)."""
    P = overlay_pkg("port")
    seen = []
    real = P.solve._run_kernel_routed

    def spy(pb, *a, **kw):
        before = {f: np.array(getattr(pb, f), copy=True)
                  for f in ("used0", "avail", "dev_used0", "valid",
                            "ev_prio", "ev_res")}
        if feed is not None:
            feed(pb)
        seen.append((pb, before))
        return real(pb, *a, **kw)
    monkeypatch.setattr(P.solve, "_run_kernel_routed", spy)
    plan(P, h, mk_job(P, "whatif", 50, 2, 2500))
    monkeypatch.setattr(P.solve, "_run_kernel_routed", real)
    return seen


def test_plan_batch_shares_no_memory_with_the_template(monkeypatch):
    """On the CPU a tensor made from a numpy plane shares its memory, so
    a plan batch aliasing the resident template would let the solve and
    the template write into each other: every array of a plan's batch
    is its own copy (a worker's solve batch aliases the template's node
    planes, which the test first shows)."""
    P = overlay_pkg("port")
    h = filled(P)
    t = h.solver._world.template
    arrays = [v for v in vars(t).values() if isinstance(v, np.ndarray)]
    real = P.solve._run_kernel_routed
    worker = []

    def spy(pb, *a, **kw):
        worker.append(pb)
        return real(pb, *a, **kw)
    monkeypatch.setattr(P.solve, "_run_kernel_routed", spy)
    register(P, h, mk_job(P, "again", 50, 1, 100))
    monkeypatch.setattr(P.solve, "_run_kernel_routed", real)
    assert any(np.shares_memory(worker[0].avail, x) for x in arrays)
    seen = plan_batches(monkeypatch, h)
    assert seen
    for pb, _ in seen:
        for f, v in vars(pb).items():
            if isinstance(v, np.ndarray):
                assert not any(np.shares_memory(v, x) for x in arrays), f


def test_plan_result_fed_during_a_plan_changes_nothing_it_reads(
        monkeypatch):
    """A worker's `note_plan_result` feed landing while an HTTP thread's
    plan solve is between its pack and its kernel advances the world
    (its usage moves) but not the plan's planes, which the plan took
    under the world lock."""
    P = overlay_pkg("port")
    h = filled(P)
    world = h.solver._world
    node = h.store.node_by_id("node-000")
    moved = []

    def feed(pb):
        a = P.mock.alloc()
        a.id = "fed-during-plan"
        a.node_id = node.id
        a.job = mk_job(P, "fed", 50, 1, 100)
        a.job_id = "fed"
        a.client_status = P.structs.ALLOC_CLIENT_RUNNING
        before = world.template.used0.copy()
        h.solver.note_plan_result(None, types.SimpleNamespace(
            node_update={}, node_preemptions={},
            node_allocation={node.id: [a]}))
        moved.append(not np.array_equal(before, world.template.used0))

    seen = plan_batches(monkeypatch, h, feed=feed)
    assert seen and moved and all(moved)
    for pb, before in seen:
        for f, v in before.items():
            np.testing.assert_array_equal(getattr(pb, f), v, err_msg=f)
