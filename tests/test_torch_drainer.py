"""The port's node drainer (`nomad_tpu_torch.server.drainer`) with the
port's `SimClient` against the JAX package's, case by case.

Each case of the reference's `tests/test_drainer.py` runs on both
packages (`pkg` = "ref" or "port"; the port's `Server` with
`device="cpu"`) and must give the same outcome: alloc names by node
(node 0 is drained, node 1 is the target), client statuses, the most
migrations in flight, and the node's drain strategy and eligibility.
Covered: paced waves within `migrate.max_parallel`, the deadline that
forces the rest, system jobs drained last, and system jobs ignored.
Every wait is bounded and every server and client is stopped in
`finally`."""
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
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


class Cluster:
    def __init__(self, pkg, n_nodes=2):
        self.mock, self.st, sim, ServerCls, kw = PKGS[pkg]
        self.wait_until = sim.wait_until
        self.server = ServerCls(num_workers=2, **kw)
        self.server.start()
        self.clients = [sim.SimClient(self.server, self.mock.node())
                        for _ in range(n_nodes)]
        for c in self.clients:
            c.start()
        self.index = {c.node.id: i for i, c in enumerate(self.clients)}

    def stop(self):
        try:
            for c in self.clients:
                c.stop()
        finally:
            self.server.stop()

    def allocs(self, job_id):
        return self.server.store.allocs_by_job("default", job_id)

    def running_on(self, job_id, node_ix):
        return [a for a in self.allocs(job_id)
                if a.node_id == self.clients[node_ix].node.id
                and a.client_status == self.st.ALLOC_CLIENT_RUNNING]

    def by_node(self, job_id):
        """(node index, name, client status) of each alloc the server
        still wants running."""
        return sorted((self.index[a.node_id], a.name, a.client_status)
                      for a in self.allocs(job_id)
                      if not a.server_terminal_status())

    def migrating(self, job_id):
        return [a for a in self.allocs(job_id)
                if a.desired_transition.should_migrate()]

    def drain_state(self, node_ix):
        node = self.server.store.node_by_id(self.clients[node_ix].node.id)
        return node.drain_strategy is None, node.scheduling_eligibility

    def job_on_node0(self, count=4, max_parallel=2):
        """A job whose allocs all land on node 0 (the others are made
        ineligible during placement)."""
        for c in self.clients[1:]:
            self.server.update_node_eligibility(c.node.id, "ineligible")
        job = self.mock.job()
        job.task_groups[0].count = count
        job.task_groups[0].migrate = self.st.MigrateStrategy(
            max_parallel=max_parallel)
        for t in job.task_groups[0].tasks:
            t.resources.networks = []
            t.resources.cpu = 100
            t.resources.memory_mb = 64
        self.server.register_job(job)
        assert self.wait_until(lambda: len(self.running_on(job.id, 0))
                               == count, timeout=15)
        return job

    def system_job(self, n_running):
        sysjob = self.mock.system_job()
        sysjob.constraints = []
        for t in sysjob.task_groups[0].tasks:
            t.resources.networks = []
        self.server.register_job(sysjob)
        assert self.wait_until(lambda: len([
            a for a in self.allocs(sysjob.id)
            if a.client_status == self.st.ALLOC_CLIENT_RUNNING])
            == n_running, timeout=15)
        return sysjob

    def drain(self, node_ix, **kw):
        self.server.update_node_drain(self.clients[node_ix].node.id,
                                      self.st.DrainStrategy(**kw))


@BOTH
def test_drain_paced_waves_respect_max_parallel(pkg):
    c = Cluster(pkg, 2)
    try:
        job = c.job_on_node0(count=4, max_parallel=2)
        # replacements are unplaceable (other node ineligible), so the
        # first wave must stall at exactly max_parallel
        c.drain(0, deadline_s=3600.0)
        assert c.wait_until(lambda: len(c.migrating(job.id)) >= 2,
                            timeout=10)
        time.sleep(0.5)          # give the drainer a chance to overshoot
        first_wave = len(c.migrating(job.id))
        # open capacity: replacements place, then the next wave fires
        c.server.update_node_eligibility(c.clients[1].node.id, "eligible")
        assert c.wait_until(lambda: len(c.running_on(job.id, 1)) == 4,
                            timeout=20), \
            "all four allocs must migrate to the other node"
        # drain completes: strategy cleared, node stays ineligible
        assert c.wait_until(lambda: c.drain_state(0)[0], timeout=10)
        outcome = {"first_wave": first_wave,
                   "live": c.by_node(job.id),
                   "drain": c.drain_state(0)}
        run = c.st.ALLOC_CLIENT_RUNNING
        assert outcome == {
            "first_wave": 2,
            "live": [(1, f"{job.id}.web[{i}]", run) for i in range(4)],
            "drain": (True, "ineligible")}, pkg
    finally:
        c.stop()


@BOTH
def test_drain_deadline_forces_remaining(pkg):
    c = Cluster(pkg, 2)
    try:
        job = c.job_on_node0(count=4, max_parallel=1)
        node_id = c.clients[0].node.id
        # replacements unplaceable and a short deadline: everything must
        # be force-migrated at the deadline
        c.drain(0, deadline_s=1.0)
        assert c.wait_until(lambda: len(c.migrating(job.id)) == 4,
                            timeout=10), "deadline must force all allocs"
        assert c.wait_until(lambda: all(
            a.server_terminal_status() or a.client_terminal_status()
            for a in c.allocs(job.id) if a.node_id == node_id),
            timeout=15)
        on0 = [a for a in c.allocs(job.id) if a.node_id == node_id]
        assert sorted(a.name for a in on0) == [
            f"{job.id}.web[{i}]" for i in range(4)], pkg
    finally:
        c.stop()


@BOTH
def test_drain_system_jobs_last(pkg):
    c = Cluster(pkg, 2)
    try:
        sysjob = c.system_job(2)
        job = c.job_on_node0(count=2, max_parallel=2)
        node_id = c.clients[0].node.id
        c.server.update_node_eligibility(c.clients[1].node.id, "eligible")
        c.drain(0, deadline_s=3600.0)
        # the service allocs migrate; the system alloc must outlive them
        assert c.wait_until(lambda: len(c.running_on(job.id, 1)) == 2,
                            timeout=20)
        # then the system alloc drains and the node finishes
        assert c.wait_until(lambda: all(
            a.terminal_status() for a in c.allocs(sysjob.id)
            if a.node_id == node_id), timeout=15)
        assert c.wait_until(lambda: c.drain_state(0)[0], timeout=10)
        run = c.st.ALLOC_CLIENT_RUNNING
        outcome = {"service": c.by_node(job.id),
                   "system": c.by_node(sysjob.id),
                   "drain": c.drain_state(0)}
        assert outcome == {
            "service": [(1, f"{job.id}.web[{i}]", run) for i in range(2)],
            "system": [(1, f"{sysjob.id}.web[0]", run)],
            "drain": (True, "ineligible")}, pkg
    finally:
        c.stop()


@BOTH
def test_drain_ignore_system_jobs(pkg):
    c = Cluster(pkg, 1)
    try:
        sysjob = c.system_job(1)
        c.drain(0, deadline_s=3600.0, ignore_system_jobs=True)
        # drain completes while the system alloc keeps running
        assert c.wait_until(lambda: c.drain_state(0)[0], timeout=10)
        run = c.st.ALLOC_CLIENT_RUNNING
        assert c.by_node(sysjob.id) == [(0, f"{sysjob.id}.web[0]", run)], \
            pkg
    finally:
        c.stop()
