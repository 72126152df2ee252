"""The port's state store (`nomad_tpu_torch.state.store`) against the JAX
package's: one function drives the same sequence of writes into each
package's StateStore (nodes, job versions, evals, allocs, client
updates, plan results with a deployment, deployment status updates,
node status / drain / eligibility, scheduler config, CSI volumes and
claims, deletes), with fixed ids and times, and every table, secondary
index, table index, job summary and change-log entry must be equal, in
the live store and in a snapshot taken part-way."""
import copy
import dataclasses

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.state import store as ref_store
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.state import store as port_store

PKGS = {"ref": (ref_mock, ref_structs, ref_store),
        "port": (port_mock, port_structs, port_store)}


def norm(x):
    """A plain-data image of `x` (dataclasses and store objects as dicts,
    sets sorted) for equality across the two packages' classes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(norm(v) for v in x)
    if hasattr(x, "__dict__"):
        return {"<type>": type(x).__name__, **norm(vars(x))}
    return x


def dump(s):
    """Every table (in insertion order), its index and the store index."""
    return {"tables": {name: [(norm(k), norm(v)) for k, v in t.items()]
                       for name, t in s._t.items()},
            "indexes": dict(s._ix), "index": s.index}


class World:
    """The write sequence, for one package."""

    def __init__(self, pkg):
        self.mock, self.st, self.mod = PKGS[pkg]
        self.s = self.mod.StateStore()

    def node(self, i, **kw):
        n = self.mock.node(id=f"node-{i}", name=f"node-{i}", **kw)
        n.secret_id = f"secret-{i}"
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        n.compute_class()
        return n

    def job(self):
        j = self.mock.job(id="job-a")
        j.task_groups[0].count = 3
        j.task_groups[0].tasks[0].services = [self.st.Service(
            name="web-svc", port_label="http", tags=["v1"])]
        return j

    def alloc(self, job, k, node):
        a = self.mock.alloc(job=job, node_id=node)
        a.id = f"alloc-{k}"
        a.eval_id = "eval-1"
        a.name = self.st.alloc_name(job.id, "web", k)
        a.create_time = a.modify_time = 1000.0 + k
        return a

    def run(self):
        st, s = self.st, self.s
        nodes = [self.node(i, datacenter="dc1" if i < 4 else "dc2")
                 for i in range(6)]
        for i, n in enumerate(nodes):
            s.upsert_node(10 + i, n)
        job = self.job()
        s.upsert_job(20, job)
        job2 = copy.deepcopy(job)
        job2.task_groups[0].count = 4
        s.upsert_job(21, job2)                 # spec change: version 1
        s.upsert_job(22, copy.deepcopy(job2))  # same spec: no bump
        job = s.job_by_id("default", "job-a")
        ev = self.mock.eval_(id="eval-1", job_id=job.id)
        s.upsert_evals(23, [ev])
        allocs = [self.alloc(job, k, f"node-{k % 3}") for k in range(4)]
        s.upsert_allocs(24, allocs)
        upd = copy.copy(allocs[0])
        upd.client_status = st.ALLOC_CLIENT_RUNNING
        upd.task_states = {"web": st.TaskState(state="running")}
        s.update_allocs_from_client(25, [upd])
        self.snap = s.snapshot()

        dep = st.Deployment(id="dep-1", job_id=job.id,
                            job_version=job.version)
        dep.task_groups["web"] = st.DeploymentState(desired_total=4)
        stopped = copy.copy(allocs[1])
        stopped.desired_status = st.ALLOC_DESIRED_STOP
        stopped.job = None
        new = self.alloc(job, 4, "node-4")
        new.deployment_id = dep.id
        result = st.PlanResult(node_update={stopped.node_id: [stopped]},
                               node_allocation={new.node_id: [new]},
                               deployment=dep, alloc_index=26)
        s.upsert_plan_results(26, result, job=job)
        s.upsert_plan_results(27, st.PlanResult(deployment_updates=[
            st.DeploymentStatusUpdate(
                deployment_id=dep.id,
                status=st.DEPLOYMENT_STATUS_SUCCESSFUL,
                status_description="done")]))
        s.update_job_summary_queued(28, "default", job.id, {"web": 1})
        s.update_node_status(29, "node-5", st.NODE_STATUS_DOWN)
        s.update_node_drain(30, "node-3", st.DrainStrategy())
        s.update_node_eligibility(31, "node-2",
                                  st.NODE_SCHED_INELIGIBLE)
        s.set_scheduler_config(32, self.mod.SchedulerConfiguration(
            preemption_service=True))
        s.upsert_csi_volume(33, st.CSIVolume(id="vol-1", plugin_id="p1"))
        s.claim_csi_volume(34, "default", "vol-1", st.CLAIM_WRITE,
                           "alloc-2", "node-2")
        s.delete_eval(35, ["eval-1"], ["alloc-3"])
        s.delete_node(36, "node-0")
        return self


@pytest.fixture(scope="module")
def worlds():
    return World("ref").run(), World("port").run()


def test_tables_and_indexes_match(worlds):
    ref, port = worlds
    r, p = dump(ref.s), dump(port.s)
    assert p["index"] == r["index"] == 36
    assert p["indexes"] == r["indexes"]
    for name in r["tables"]:
        assert p["tables"][name] == r["tables"][name], name
    assert set(p["tables"]) == set(r["tables"])
    # the sequence reached every kind of entry it meant to
    for name in ("nodes", "jobs", "job_versions", "job_summaries",
                 "allocs", "deployments", "scheduler_config",
                 "csi_volumes", "services", "_allocs_by_node",
                 "_allocs_by_job"):
        assert r["tables"][name], name


def test_snapshot_isolated_and_matches(worlds):
    ref, port = worlds
    r, p = dump(ref.snap), dump(port.snap)
    assert p == r
    assert p["index"] == 25
    assert port.snap.node_by_id("node-0") is not None
    assert port.s.node_by_id("node-0") is None
    assert port.snap.alloc_by_id("alloc-4") is None


def test_reads_match(worlds):
    ref, port = worlds

    def reads(w):
        s = w.s
        ready, by_dc = s.ready_nodes_in_dcs(["dc1", "dc2"])
        return {
            "ready": [n.id for n in ready], "by_dc": by_dc,
            "by_job": sorted(a.id for a in s.allocs_by_job("default",
                                                           "job-a")),
            "by_node": {n: sorted(a.id for a in s.allocs_by_node(n))
                        for n in ("node-1", "node-2", "node-4")},
            "live_node_1": [a.id for a in s.allocs_by_node_terminal(
                "node-1", False)],
            "versions": [j.version for j in s.job_versions("default",
                                                           "job-a")],
            "stable": [j.stable for j in s.job_versions("default",
                                                        "job-a")],
            "job_status": s.job_by_id("default", "job-a").status,
            "summary": norm(s.job_summary("default", "job-a")),
            "latest_dep": s.latest_deployment_by_job("default",
                                                     "job-a").status,
            "config": norm(s.scheduler_config()),
            "services": [r.id for r in s.services_by_name("default",
                                                          "web-svc")],
            "vol_claims": s.csi_volume_by_id("default",
                                             "vol-1").write_claims,
        }
    assert reads(port) == reads(ref)
    got = reads(port)
    assert got["ready"] == ["node-1", "node-4"]
    assert got["summary"]["summary"]["web"]["queued"] == 1
    assert got["stable"][0] is True


def test_changelog_matches(worlds):
    ref, port = worlds
    assert port.s.changelog._entries == ref.s.changelog._entries
    for lo, hi in ((0, 36), (24, 26), (29, 31), (36, 40)):
        assert (port.s.changes_since(lo, hi)
                == ref.s.changes_since(lo, hi))
    assert ("alloc", "alloc-4") in {(k, key) for _i, k, key in
                                    port.s.changes_since(25, 26)}


@pytest.mark.parametrize("cap", [4, 16])
def test_changelog_ring_truncation(cap):
    """The bounded ring drops its oldest half past 2 * cap and refuses a
    window that reaches below what it dropped, in both packages."""
    logs = [port_store.ChangeLog(cap=cap), ref_store.ChangeLog(cap=cap)]
    for log in logs:
        for i in range(1, 3 * cap + 2):
            log.append(i, "alloc" if i % 2 else "node", f"k{i}")
    port, ref = logs
    assert port.floor == ref.floor > 0
    assert port._entries == ref._entries
    assert port.since(0, 10 ** 6) is None and ref.since(0, 10 ** 6) is None
    assert (port.since(port.floor, 10 ** 6)
            == ref.since(ref.floor, 10 ** 6))


def test_alloc_index_reads_while_the_writer_runs():
    """`allocs_by_node` / `allocs_by_job` on the live store from other
    threads (a client agent, the drainer) while the FSM's writer adds
    and removes allocs of that node and job: a read never raises and
    returns only allocs of the node (the index set is copied in one
    step; a loop over the live set can meet "Set changed size during
    iteration")."""
    import sys
    import threading
    import time
    store = port_store.StateStore()
    node = port_mock.node(id="node-0", name="node-0")
    store.upsert_node(1, node)
    job = port_mock.job(id="job-0")
    store.upsert_job(2, job)
    errors, reads = [], [0]
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                got = store.allocs_by_node(node.id)
                got += store.allocs_by_job(job.namespace, job.id)
                assert all(a.node_id == node.id for a in got)
                reads[0] += 1
            except Exception as e:          # read after the join
                errors.append(repr(e))
                return
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        index = 3
        deadline = time.monotonic() + 2.0
        k = 0
        while time.monotonic() < deadline and not errors:
            a = port_mock.alloc(job=job, node_id=node.id)
            a.id = f"alloc-{k}"
            store.upsert_allocs(index, [a])
            if k >= 50:
                store.delete_eval(index + 1, [], [f"alloc-{k - 50}"])
            index += 2
            k += 1
    finally:
        stop.set()
        for t in threads:
            t.join(5.0)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and reads[0] > 0 and k > 100
