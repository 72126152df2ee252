"""The end-to-end slice on the port's `Server(device="cpu")` with the
port's `SimClient` against the JAX package's, case by case: submit a job
-> eval -> solve -> plan -> apply -> the simulated client runs the task.

Each case of the reference's `tests/test_e2e_slice.py` runs on both
packages (`pkg` = "ref" or "port") over four simulated nodes and must
give the same outcome: alloc names, client statuses and eval statuses.
Covered: a service job, a batch job that completes, a failed alloc
rescheduled, a node going down and its allocs replaced, a rolling job
update, a system job covering a joining node, and a blocked eval that
unblocks on new capacity.  Every wait is bounded and every server and
client is stopped in `finally`."""
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


class Slice:
    def __init__(self, pkg):
        self.pkg = pkg
        self.mock, self.st, self.sim, ServerCls, kw = PKGS[pkg]
        self.wait_until = self.sim.wait_until
        self.server = ServerCls(num_workers=2, **kw)
        self.server.start()
        self.clients = []
        for _ in range(4):
            self.add_client()

    def add_client(self):
        c = self.sim.SimClient(self.server, self.mock.node())
        c.start()
        self.clients.append(c)
        return c

    def stop(self):
        try:
            for c in self.clients:
                c.stop()
        finally:
            self.server.stop()

    def allocs(self, job_id):
        return self.server.store.allocs_by_job("default", job_id)

    def live(self, job_id, status=None):
        out = [a for a in self.allocs(job_id)
               if not a.server_terminal_status()]
        if status:
            out = [a for a in out if a.client_status == status]
        return out


@pytest.fixture(params=["ref", "port"])
def cluster(request):
    s = Slice(request.param)
    try:
        yield s
    finally:
        s.stop()


def names(allocs):
    return sorted(a.name for a in allocs)


def test_service_job_end_to_end(cluster):
    c, st = cluster, cluster.st
    job = c.mock.job()
    job.task_groups[0].count = 4
    c.server.register_job(job)
    assert c.wait_until(lambda: len(c.live(
        job.id, st.ALLOC_CLIENT_RUNNING)) == 4, timeout=10)
    ev = c.server.store.evals_by_job("default", job.id)[0]
    assert c.wait_until(lambda: c.server.store.eval_by_id(ev.id).status
                        == st.EVAL_STATUS_COMPLETE, timeout=5)
    assert names(c.live(job.id, st.ALLOC_CLIENT_RUNNING)) == [
        f"{job.id}.web[{i}]" for i in range(4)]


def test_batch_job_completes(cluster):
    c, st = cluster, cluster.st
    job = c.mock.batch_job()
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].config = {"mock_outcome": "complete",
                                          "mock_runtime_s": 0.05}
    c.server.register_job(job)
    assert c.wait_until(lambda: len([
        a for a in c.allocs(job.id)
        if a.client_status == st.ALLOC_CLIENT_COMPLETE]) == 3, timeout=10)
    # completed batch allocs are not replaced
    time.sleep(0.3)
    assert sorted((a.name, a.client_status) for a in c.allocs(job.id)) == [
        (f"{job.id}.web[{i}]", st.ALLOC_CLIENT_COMPLETE) for i in range(3)]


def test_failed_alloc_rescheduled(cluster):
    c, st = cluster, cluster.st
    job = c.mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy = st.ReschedulePolicy(
        unlimited=True, delay_s=0, delay_function="constant")
    job.task_groups[0].tasks[0].config = {"mock_outcome": "fail",
                                          "mock_runtime_s": 0.05}
    c.server.register_job(job)
    # the failed alloc gets a replacement chained to it
    assert c.wait_until(lambda: any(
        a.previous_allocation for a in c.allocs(job.id)), timeout=10)
    by_id = {a.id: a for a in c.allocs(job.id)}
    chained = [a for a in by_id.values() if a.previous_allocation]
    prev = by_id[chained[0].previous_allocation]
    assert (chained[0].name, prev.name, prev.client_status) == (
        f"{job.id}.web[0]", f"{job.id}.web[0]", st.ALLOC_CLIENT_FAILED)


def test_node_down_triggers_replacement(cluster):
    c, st = cluster, cluster.st
    job = c.mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].reschedule_policy = st.ReschedulePolicy(
        unlimited=True, delay_s=0, delay_function="constant")
    c.server.register_job(job)
    assert c.wait_until(lambda: len(c.live(
        job.id, st.ALLOC_CLIENT_RUNNING)) == 4, timeout=10)

    victim_node = c.live(job.id)[0].node_id
    lost = {a.name for a in c.live(job.id) if a.node_id == victim_node}
    for cl in c.clients:
        if cl.node.id == victim_node:
            cl.stop()
    c.server.update_node_status(victim_node, st.NODE_STATUS_DOWN)

    def replaced():
        return len([a for a in c.live(job.id)
                    if a.node_id != victim_node
                    and not a.client_terminal_status()]) == 4
    assert c.wait_until(replaced, timeout=10)
    moved = {a.name for a in c.live(job.id) if a.node_id != victim_node}
    assert moved == {f"{job.id}.web[{i}]" for i in range(4)} and lost


def test_job_update_rolls(cluster):
    c, st = cluster, cluster.st
    job = c.mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].update = st.UpdateStrategy(max_parallel=4)
    c.server.register_job(job)
    assert c.wait_until(lambda: len(c.live(
        job.id, st.ALLOC_CLIENT_RUNNING)) == 4, timeout=10)

    job2 = c.mock.job(id=job.id)
    job2.task_groups[0].count = 4
    job2.task_groups[0].update = st.UpdateStrategy(max_parallel=4)
    job2.task_groups[0].tasks[0].config = {"command": "/bin/v2"}
    c.server.register_job(job2)

    def v2():
        return [a for a in c.live(job.id, st.ALLOC_CLIENT_RUNNING)
                if a.job and a.job.task_groups[0].tasks[0].config
                == {"command": "/bin/v2"}]
    assert c.wait_until(lambda: len(v2()) == 4, timeout=10)
    # a deployment tracked the rollout
    assert c.server.store.deployments_by_job("default", job.id)
    assert names(v2()) == [f"{job.id}.web[{i}]" for i in range(4)]


def test_system_job_covers_new_node(cluster):
    c, st = cluster, cluster.st
    job = c.mock.system_job()
    c.server.register_job(job)
    assert c.wait_until(lambda: len(c.live(
        job.id, st.ALLOC_CLIENT_RUNNING)) == 4, timeout=10)
    extra = c.add_client()
    assert c.wait_until(lambda: len(c.live(
        job.id, st.ALLOC_CLIENT_RUNNING)) == 5, timeout=10)
    on_extra = [a.name for a in c.live(job.id) if a.node_id == extra.node.id]
    assert on_extra == [f"{job.id}.web[0]"]


def test_blocked_eval_unblocks_on_capacity(cluster):
    c, st = cluster, cluster.st
    job = c.mock.job()
    job.task_groups[0].count = 30     # exceeds 4-node capacity
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
        t.resources.cpu = 600
    c.server.register_job(job)
    stats = c.server.blocked_evals.stats
    assert c.wait_until(lambda: stats()["total_blocked"]
                        + stats()["total_escaped"] > 0, timeout=10)
    placed_before = len(c.live(job.id))
    assert placed_before < 30
    # add capacity: the blocked eval should fire and place more
    c.add_client()
    assert c.wait_until(lambda: len(c.live(job.id)) > placed_before,
                        timeout=10)
    assert len({a.name for a in c.live(job.id)}) == len(c.live(job.id))
