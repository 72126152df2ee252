"""The port's deployment watcher (`nomad_tpu_torch.server.deployment_watcher`)
with the port's `SimClient` against the JAX package's, case by case.

Each case of the reference's `tests/test_deployment_watcher.py` runs on
both packages (`pkg` = "ref" or "port"; the port's `Server` with
`device="cpu"`) over four simulated nodes and must give the same outcome:
alloc names and client statuses, deployment status and description,
promotion, job version and stability.  Covered: the initial deployment,
a multi-batch rolling update driven by health, canary auto-promote,
manual promote, a failed canary's auto-revert and the progress deadline.
Every wait is bounded and every server and client is stopped in
`finally`."""
import copy
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.client import sim as ref_sim
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.client import sim as port_sim
from nomad_tpu_torch.server.server import Server as PortServer

PKGS = {"ref": (ref_mock, ref_structs, ref_sim, RefServer, {}),
        "port": (port_mock, port_structs, port_sim, PortServer,
                 {"device": "cpu"})}


def start_cluster(pkg, nodes):
    mock, _st, sim, ServerCls, kw = PKGS[pkg]
    server = ServerCls(num_workers=2, **kw)
    server.start()
    clients = [sim.SimClient(server, n) for n in nodes]
    for c in clients:
        c.start()
    return server, clients


def stop_cluster(server, clients):
    try:
        for c in clients:
            c.stop()
    finally:
        server.stop()


@pytest.fixture(params=["ref", "port"])
def cluster(request):
    mock, st, sim = PKGS[request.param][:3]
    server, clients = start_cluster(request.param,
                                    [mock.node() for _ in range(4)])
    try:
        yield server, mock, st, sim.wait_until
    finally:
        stop_cluster(server, clients)


def service_job(mock, st, count=3, max_parallel=1, canary=0,
                auto_revert=False, auto_promote=False):
    job = mock.job()
    job.task_groups[0].count = count
    job.task_groups[0].update = st.UpdateStrategy(
        max_parallel=max_parallel, canary=canary,
        auto_revert=auto_revert, auto_promote=auto_promote,
        min_healthy_time_s=0.0, healthy_deadline_s=30.0,
        progress_deadline_s=60.0)
    job.update = job.task_groups[0].update
    return job


def deployment(server, job_id, version=None):
    for d in server.store.deployments_by_job("default", job_id):
        if version is None or d.job_version == version:
            return d
    return None


def dep_status(server, job_id, version):
    d = deployment(server, job_id, version)
    return d.status if d is not None else None


def running_allocs(server, st, job_id):
    return [a for a in server.store.allocs_by_job("default", job_id)
            if a.client_status == st.ALLOC_CLIENT_RUNNING
            and not a.server_terminal_status()]


def names(allocs):
    return sorted(a.name for a in allocs)


def updated(server, job_id, **env):
    job2 = copy.deepcopy(server.store.job_by_id("default", job_id))
    job2.task_groups[0].tasks[0].env = dict(env)
    job2.create_index = job2.modify_index = job2.job_modify_index = 0
    return job2


def test_initial_deployment_completes_and_marks_stable(cluster):
    server, mock, st, wait_until = cluster
    job = service_job(mock, st, count=3)
    server.register_job(job)
    assert wait_until(lambda: len(running_allocs(server, st, job.id)) == 3,
                      timeout=40)
    assert wait_until(lambda: dep_status(server, job.id, None)
                      == st.DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40), \
        "watcher must flip the deployment successful"
    assert wait_until(
        lambda: server.store.job_by_id("default", job.id).stable,
        timeout=60), "successful deployment must mark the version stable"
    outcome = {"running": names(running_allocs(server, st, job.id)),
               "deployment": dep_status(server, job.id, 0),
               "stable": server.store.job_by_id("default", job.id).stable}
    assert outcome == {"running": [f"{job.id}.web[{i}]" for i in range(3)],
                       "deployment": st.DEPLOYMENT_STATUS_SUCCESSFUL,
                       "stable": True}


def test_multi_batch_rolling_update_completes_on_health(cluster):
    """max_parallel=1 x 3 replicas: each batch is unblocked by the
    previous batch's health signal."""
    server, mock, st, wait_until = cluster
    job = service_job(mock, st, count=3, max_parallel=1)
    server.register_job(job)
    assert wait_until(lambda: len(running_allocs(server, st, job.id)) == 3,
                      timeout=40)
    assert wait_until(lambda: dep_status(server, job.id, 0)
                      == st.DEPLOYMENT_STATUS_SUCCESSFUL, timeout=40)
    # destructive update: change the task env
    server.register_job(updated(server, job.id, VERSION="2"))
    # the rollout must finish: new deployment successful, all 3 allocs on
    # the new version, purely from health-driven next-batch evals
    assert wait_until(lambda: dep_status(server, job.id, 1)
                      == st.DEPLOYMENT_STATUS_SUCCESSFUL, timeout=60), \
        "rolling deployment must complete on health signals"
    new_allocs = [a for a in running_allocs(server, st, job.id)
                  if a.job and a.job.version == 1]
    outcome = {"v1": names(new_allocs),
               "healthy": deployment(server, job.id, 1)
               .task_groups["web"].healthy_allocs >= 3}
    assert outcome == {"v1": [f"{job.id}.web[{i}]" for i in range(3)],
                       "healthy": True}


def test_canary_auto_promote_completes(cluster):
    server, mock, st, wait_until = cluster
    job = service_job(mock, st, count=3)
    server.register_job(job)
    assert wait_until(lambda: len(running_allocs(server, st, job.id)) == 3,
                      timeout=40)
    job2 = updated(server, job.id, VERSION="2")
    job2.task_groups[0].update.canary = 1
    job2.task_groups[0].update.auto_promote = True
    server.register_job(job2)
    assert wait_until(lambda: dep_status(server, job.id, 1)
                      == st.DEPLOYMENT_STATUS_SUCCESSFUL, timeout=60), \
        "auto-promote + rollout must complete"
    dep = deployment(server, job.id, 1)
    assert {"promoted": dep.task_groups["web"].promoted,
            "status": dep.status} == {
        "promoted": True, "status": st.DEPLOYMENT_STATUS_SUCCESSFUL}


def test_canary_manual_promote(cluster):
    server, mock, st, wait_until = cluster
    job = service_job(mock, st, count=2)
    server.register_job(job)
    assert wait_until(lambda: len(running_allocs(server, st, job.id)) == 2,
                      timeout=40)
    job2 = updated(server, job.id, VERSION="2")
    job2.task_groups[0].update.canary = 1
    server.register_job(job2)
    # canary placed + healthy, deployment waits (not promoted)
    assert wait_until(lambda: (
        deployment(server, job.id, 1) is not None
        and deployment(server, job.id, 1).task_groups["web"]
        .placed_canaries), timeout=40)
    time.sleep(0.5)
    dep = deployment(server, job.id, 1)
    before = {"status": dep.status,
              "promoted": dep.task_groups["web"].promoted,
              "canaries": len(dep.task_groups["web"].placed_canaries)}
    assert before == {"status": st.DEPLOYMENT_STATUS_RUNNING,
                      "promoted": False, "canaries": 1}
    assert server.promote_deployment(dep.id) is not None
    assert wait_until(lambda: dep_status(server, job.id, 1)
                      == st.DEPLOYMENT_STATUS_SUCCESSFUL, timeout=60)


def test_failed_canary_auto_reverts_to_stable(cluster):
    server, mock, st, wait_until = cluster
    job = service_job(mock, st, count=2, auto_revert=True)
    server.register_job(job)
    assert wait_until(lambda: len(running_allocs(server, st, job.id)) == 2,
                      timeout=40)
    assert wait_until(
        lambda: server.store.job_by_id("default", job.id).stable,
        timeout=40)
    # v1: canary that fails
    job2 = updated(server, job.id, VERSION="2")
    job2.task_groups[0].tasks[0].config = {
        "mock_outcome": "fail", "mock_runtime_s": 0.05}
    job2.task_groups[0].update.canary = 1
    job2.task_groups[0].update.auto_revert = True
    server.register_job(job2)
    assert wait_until(lambda: dep_status(server, job.id, 1)
                      == st.DEPLOYMENT_STATUS_FAILED, timeout=60), \
        "failed canary must fail the deployment"
    dep = deployment(server, job.id, 1)
    # auto-revert re-registers the stable v0 spec as a new version
    assert wait_until(lambda: server.store.job_by_id(
        "default", job.id).version == 2, timeout=40)
    reverted = server.store.job_by_id("default", job.id)
    task = reverted.task_groups[0].tasks[0]
    outcome = {"rolling_back": "rolling back" in dep.status_description,
               "version": reverted.version,
               "env": task.env.get("VERSION"),
               "outcome": task.config.get("mock_outcome")}
    assert outcome == {"rolling_back": True, "version": 2, "env": None,
                       "outcome": None}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_progress_deadline_fails_stuck_deployment(pkg):
    mock, st, sim = PKGS[pkg][:3]
    # one tiny node: capacity for exactly one alloc of this size
    node = mock.node()
    node.node_resources.cpu = 700
    node.node_resources.memory_mb = 512
    node.compute_class()
    server, clients = start_cluster(pkg, [node])
    try:
        job = service_job(mock, st, count=3)
        for tg in job.task_groups:
            tg.update.progress_deadline_s = 1.0
            for t in tg.tasks:
                t.resources.cpu = 500
                t.resources.networks = []
        server.register_job(job)
        assert sim.wait_until(lambda: any(
            d.status == st.DEPLOYMENT_STATUS_FAILED
            and "progress deadline" in d.status_description
            for d in server.store.deployments_by_job("default", job.id)),
            timeout=60), "stuck deployment must fail on progress deadline"
        live = [a for a in server.store.allocs_by_job("default", job.id)
                if not a.server_terminal_status()]
        assert len(live) == 1, pkg
    finally:
        stop_cluster(server, clients)
