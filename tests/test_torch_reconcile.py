"""The port's reconciler (`nomad_tpu_torch.scheduler.reconcile`) against the
JAX package's on the scenarios of tests/test_reconcile.py.

Each scenario is built by ONE function for both packages (each package's
own mock and structs) with fixed alloc, node and deployment ids and the
same `now`, and both reconcilers must return identical results: place,
stop, in-place and destructive results, attribute updates, the
deployment and its status updates, `desired_tg_updates` and the
follow-up evals (whose fresh uuids compare by position)."""
import copy
import dataclasses
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler import reconcile as ref_reconcile
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler import reconcile as port_reconcile

PKGS = {"ref": (ref_mock, ref_structs, ref_reconcile),
        "port": (port_mock, port_structs, port_reconcile)}


def ignore_update_fn(alloc, job, tg):
    return True, False, None


def destructive_update_fn(alloc, job, tg):
    return False, True, None


def inplace_update_fn(alloc, job, tg):
    updated = copy.copy(alloc)
    updated.job = job
    return False, False, updated


class B:
    """One package's factories for a scenario."""

    def __init__(self, pkg, now):
        self.mock, self.st, self.rec = PKGS[pkg]
        self.now = now
        self._n = 0

    def job(self, batch=False, **kw):
        j = (self.mock.batch_job if batch else self.mock.job)(
            id=kw.pop("id", "job-r"), **kw)
        return j

    def node(self, name, **kw):
        return self.mock.node(id=f"node-{name}", name=name, **kw)

    def alloc(self, job, i, tg="web", client=None, node_id="node-0"):
        a = self.mock.alloc(job=job)
        self._n += 1
        a.id = f"alloc-{self._n:03d}"
        a.task_group = tg
        a.name = self.st.alloc_name(job.id, tg, i)
        a.client_status = client or self.st.ALLOC_CLIENT_RUNNING
        a.node_id = node_id
        return a

    def running(self, job, n, tg="web"):
        return [self.alloc(job, i, tg) for i in range(n)]

    def failed(self, a, finished_at=None):
        a.client_status = self.st.ALLOC_CLIENT_FAILED
        a.task_states = {"web": self.st.TaskState(
            state="dead", failed=True,
            finished_at=self.now if finished_at is None else finished_at)}
        return a

    def deployment(self, job, dep_id="dep-1", status=None, **tgs):
        d = self.st.Deployment(id=dep_id, job_id=job.id,
                               job_version=job.version,
                               job_create_index=job.create_index)
        if status:
            d.status = status
        for name, state in tgs.items():
            d.task_groups[name] = self.st.DeploymentState(**state)
        return d

    def policy(self, **kw):
        base = dict(attempts=3, interval_s=3600, delay_s=0,
                    unlimited=False, delay_function="constant")
        base.update(kw)
        return self.st.ReschedulePolicy(**base)


# ------------------------------------------------------------- scenarios
# each returns the Reconciler's keyword arguments (besides eval id, now)

def s_place_new(b):
    job = b.job()
    job.task_groups[0].count = 4
    return dict(job=job, allocs=[])


def s_scale_up(b):
    job = b.job()
    job.task_groups[0].count = 5
    return dict(job=job, allocs=b.running(job, 3))


def s_scale_down(b):
    job = b.job()
    job.task_groups[0].count = 3
    return dict(job=job, allocs=b.running(job, 5))


def s_stopped_job(b):
    job = b.job()
    job.stop = True
    return dict(job=job, allocs=b.running(job, 4))


def s_removed_group(b):
    job = b.job()
    job.task_groups[0].count = 2
    return dict(job=job, allocs=b.running(job, 2, tg="old-group"))


def s_lost_node(b):
    job = b.job()
    job.task_groups[0].count = 3
    down = b.node("down", status=b.st.NODE_STATUS_DOWN)
    allocs = b.running(job, 3)
    allocs[0].node_id = down.id
    return dict(job=job, allocs=allocs, tainted={down.id: down})


def s_deregistered_node(b):
    job = b.job()
    job.task_groups[0].count = 1
    allocs = b.running(job, 1)
    allocs[0].node_id = "gone"
    return dict(job=job, allocs=allocs, tainted={"gone": None})


def s_drain_migrates(b):
    job = b.job()
    job.task_groups[0].count = 2
    drain = b.node("drain")
    allocs = b.running(job, 2)
    allocs[0].node_id = drain.id
    allocs[0].desired_transition = b.st.DesiredTransition(migrate=True)
    return dict(job=job, allocs=allocs, tainted={drain.id: drain})


def s_ignore_unchanged(b):
    job = b.job()
    job.task_groups[0].count = 3
    return dict(job=job, allocs=b.running(job, 3))


def _old_and_new(b, count, **update):
    job = b.job()
    job.version = 1
    job.task_groups[0].count = count
    if update:
        job.task_groups[0].update = b.st.UpdateStrategy(**update)
    old = b.job(id=job.id)
    old.version = 0
    return job, old


def s_inplace_update(b):
    job, old = _old_and_new(b, 2)
    return dict(job=job, allocs=b.running(old, 2),
                update_fn=inplace_update_fn)


def s_destructive_unlimited(b):
    job, old = _old_and_new(b, 3)
    job.update = None
    for tg in job.task_groups:
        tg.update = None
    return dict(job=job, allocs=b.running(old, 3),
                update_fn=destructive_update_fn)


def s_destructive_max_parallel(b):
    job, old = _old_and_new(b, 6, max_parallel=2, canary=0)
    return dict(job=job, allocs=b.running(old, 6),
                update_fn=destructive_update_fn)


def s_canaries_created(b):
    job, old = _old_and_new(b, 4, max_parallel=2, canary=2)
    return dict(job=job, allocs=b.running(old, 4),
                update_fn=destructive_update_fn)


def s_promoted_canaries_roll(b):
    job, old = _old_and_new(b, 4, max_parallel=2, canary=2)
    allocs = b.running(old, 4)
    canaries = []
    for i in range(2):
        c = b.alloc(job, i)
        c.deployment_id = "dep-1"
        c.deployment_status = b.st.AllocDeploymentStatus(healthy=True,
                                                         canary=True)
        canaries.append(c)
    dep = b.deployment(job, web=dict(
        promoted=True, desired_canaries=2, desired_total=4,
        placed_canaries=[c.id for c in canaries], healthy_allocs=2,
        placed_allocs=2))
    return dict(job=job, allocs=allocs + canaries, deployment=dep,
                update_fn=destructive_update_fn)


def s_paused_deployment(b):
    job = b.job()
    job.task_groups[0].count = 5
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=2)
    dep = b.deployment(job, status=b.st.DEPLOYMENT_STATUS_PAUSED,
                       web=dict(desired_total=5))
    return dict(job=job, allocs=[], deployment=dep)


def s_failed_deployment_migrates(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1)
    dep = b.deployment(job, status=b.st.DEPLOYMENT_STATUS_FAILED,
                       web=dict(desired_total=2))
    node = b.node("drain")
    allocs = b.running(job, 2)
    allocs[0].node_id = node.id
    allocs[0].desired_transition = b.st.DesiredTransition(migrate=True)
    return dict(job=job, allocs=allocs, deployment=dep,
                tainted={node.id: node})


def s_reschedule_now(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].reschedule_policy = b.policy()
    allocs = b.running(job, 2)
    b.failed(allocs[0])
    return dict(job=job, allocs=allocs)


def s_paused_replaces_lost(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1)
    dep = b.deployment(job, status=b.st.DEPLOYMENT_STATUS_PAUSED,
                       web=dict(desired_total=2))
    down = b.node("down", status=b.st.NODE_STATUS_DOWN)
    allocs = b.running(job, 2)
    allocs[0].node_id = down.id
    return dict(job=job, allocs=allocs, deployment=dep,
                tainted={down.id: down})


def s_reschedule_no_deployment(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1)
    job.task_groups[0].reschedule_policy = b.policy()
    allocs = b.running(job, 2)
    b.failed(allocs[0])
    return dict(job=job, allocs=allocs)


def s_promoted_canary_survives_failed(b):
    job = b.job()
    job.task_groups[0].count = 1
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1,
                                                    canary=1)
    canary = b.alloc(job, 0)
    canary.deployment_id = "dep-1"
    canary.deployment_status = b.st.AllocDeploymentStatus(healthy=True,
                                                          canary=True)
    dep = b.deployment(job, status=b.st.DEPLOYMENT_STATUS_FAILED, web=dict(
        promoted=True, desired_canaries=1, desired_total=1,
        placed_canaries=[canary.id], healthy_allocs=1))
    return dict(job=job, allocs=[canary], deployment=dep)


def s_unhealthy_deployment(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1)
    dep = b.deployment(job, web=dict(desired_total=2, placed_allocs=2,
                                     healthy_allocs=0))
    allocs = b.running(job, 2)
    for a in allocs:
        a.deployment_id = dep.id
    return dict(job=job, allocs=allocs, deployment=dep)


def s_scale_up_consumes_limit(b):
    job, old = _old_and_new(b, 8, max_parallel=2)
    return dict(job=job, allocs=b.running(old, 6),
                update_fn=destructive_update_fn)


def s_reschedule_later(b):
    job = b.job()
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy = b.policy(delay_s=60)
    allocs = b.running(job, 1)
    b.failed(allocs[0])
    return dict(job=job, allocs=allocs)


def s_reschedule_later_batched(b):
    job = b.job()
    job.task_groups[0].count = 3
    job.task_groups[0].reschedule_policy = b.policy(attempts=5, delay_s=60)
    allocs = b.running(job, 3)
    for i, a in enumerate(allocs):
        b.failed(a, finished_at=b.now + i)
    return dict(job=job, allocs=allocs)


def s_exhausted_attempts(b):
    job = b.job()
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy = b.policy(attempts=1)
    a = b.failed(b.running(job, 1)[0])
    a.reschedule_tracker = b.st.RescheduleTracker(events=[
        b.st.RescheduleEvent(reschedule_time=b.now - 10, delay_s=0)])
    return dict(job=job, allocs=[a])


def s_batch_complete(b):
    job = b.job(batch=True)
    job.task_groups[0].count = 2
    allocs = b.running(job, 2)
    allocs[0].client_status = b.st.ALLOC_CLIENT_COMPLETE
    allocs[0].task_states = {"web": b.st.TaskState(
        state="dead", failed=False, finished_at=b.now)}
    return dict(job=job, allocs=allocs, batch=True)


def s_batch_failed(b):
    job = b.job(batch=True)
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy = b.policy(interval_s=86400)
    return dict(job=job, allocs=[b.failed(b.running(job, 1)[0])],
                batch=True)


def s_already_rescheduled(b):
    job = b.job()
    job.task_groups[0].count = 2
    a, c = b.running(job, 2)
    a.client_status = b.st.ALLOC_CLIENT_FAILED
    a.next_allocation = "replacement-id"
    return dict(job=job, allocs=[a, c])


def s_deployment_completes(b):
    job = b.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = b.st.UpdateStrategy(max_parallel=1)
    dep = b.deployment(job, web=dict(desired_total=2, placed_allocs=2,
                                     healthy_allocs=2))
    allocs = b.running(job, 2)
    for a in allocs:
        a.deployment_id = dep.id
        a.deployment_status = b.st.AllocDeploymentStatus(healthy=True)
    return dict(job=job, allocs=allocs, deployment=dep)


def s_old_deployment_cancelled(b):
    job = b.job()
    job.version = 2
    job.task_groups[0].count = 1
    dep = b.deployment(job)
    dep.job_version = 1
    return dict(job=job, allocs=b.running(job, 1), deployment=dep)


def s_failed_deployment_canaries_stopped(b):
    job, old = _old_and_new(b, 2, max_parallel=1, canary=1)
    allocs = b.running(old, 2)
    canary = b.alloc(job, 0)
    canary.deployment_id = "dep-1"
    canary.deployment_status = b.st.AllocDeploymentStatus(canary=True)
    dep = b.deployment(job, status=b.st.DEPLOYMENT_STATUS_FAILED, web=dict(
        desired_canaries=1, desired_total=2, placed_canaries=[canary.id]))
    return dict(job=job, allocs=allocs + [canary], deployment=dep,
                update_fn=destructive_update_fn)


def s_deleted_job(b):
    job = b.job()
    return dict(job=None, allocs=b.running(job, 3), job_id=job.id)


SCENARIOS = {name[2:]: fn for name, fn in globals().items()
             if name.startswith("s_") and callable(fn)}


# ------------------------------------------------------------- observe
def observe(res):
    """The results with fresh uuids replaced by positions."""
    fu = {}
    followups = {}
    for tg, evs in sorted(res.desired_followup_evals.items()):
        rows = []
        for k, e in enumerate(evs):
            fu[e.id] = (tg, k)
            rows.append((e.triggered_by, e.status, e.type, e.job_id,
                         e.namespace, e.priority, round(e.wait_until, 6)))
        followups[tg] = rows
    new_dep = res.deployment.id if res.deployment is not None else None

    def dep_id(x):
        return "<new>" if x and x == new_dep else x

    def dep(d):
        if d is None:
            return None
        return (d.status, d.status_description, d.job_id, d.job_version,
                {tg: dataclasses.asdict(s)
                 for tg, s in sorted(d.task_groups.items())})

    def prev(a):
        return a.id if a is not None else None

    return {
        "place": [(p.name, p.task_group.name, prev(p.previous_alloc),
                   p.reschedule, p.canary) for p in res.place],
        "destructive": [(d.place_name, d.place_task_group.name,
                         d.stop_alloc.id, d.stop_status_description)
                        for d in res.destructive_update],
        "inplace": [(a.id, a.job.version if a.job else None)
                    for a in res.inplace_update],
        "stop": [(s.alloc.id, s.client_status, s.status_description)
                 for s in res.stop],
        "attribute_updates": {
            aid: (a.id, fu.get(a.follow_up_eval_id, a.follow_up_eval_id))
            for aid, a in res.attribute_updates.items()},
        "deployment": dep(res.deployment),
        "deployment_updates": [(dep_id(u.deployment_id), u.status,
                                u.status_description)
                               for u in res.deployment_updates],
        "desired_tg_updates": {tg: dataclasses.asdict(u) for tg, u in
                               sorted(res.desired_tg_updates.items())},
        "followups": followups,
    }


def reconcile(pkg, scenario, now):
    b = B(pkg, now)
    kw = scenario(b)
    job = kw["job"]
    r = b.rec.Reconciler(kw.get("update_fn", ignore_update_fn),
                         kw.get("batch", False),
                         kw.get("job_id") or job.id, job,
                         kw.get("deployment"), kw["allocs"],
                         kw.get("tainted") or {}, "eval-1", now=now)
    return observe(r.compute())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reconciler_matches_reference(name):
    now = time.time()
    ref = reconcile("ref", SCENARIOS[name], now)
    port = reconcile("port", SCENARIOS[name], now)
    for key in ref:
        assert port[key] == ref[key], key


def test_scenarios_cover_every_result_kind():
    """The scenario set reaches every kind of result the comparison
    holds (so an empty comparison cannot pass for all of them)."""
    now = time.time()
    seen = set()
    for fn in SCENARIOS.values():
        out = reconcile("port", fn, now)
        seen |= {k for k, v in out.items() if v}
    assert seen == {"place", "destructive", "inplace", "stop",
                    "attribute_updates", "deployment",
                    "deployment_updates", "desired_tg_updates",
                    "followups"}
