"""The port's server plane end to end on the CPU: a running
`nomad_tpu_torch.server.server.Server(device="cpu")` with its worker
threads, broker, solve coordinator, plan applier and raft.

With the reference's default serving tier (2 workers, coordinator and
pipeline on, adaptive batching, group commit) the server places every
job's allocs, completes every eval, oversubscribes no node and leaves
nothing unacked; the jobs are registered before `start()`, so leadership
enqueues them together and the first dequeue fuses them on the
coordinator.  With one worker and the fixed batch size
(`serving_config={"adaptive": False}`) the whole backlog is one
`process_fleet` round, whose placements must equal the JAX package's
server on the same cluster and jobs.  A system job (placed on every
node, then on a joining node, then deregistered) and service preemption
at the default eviction width give the same allocs and victims as the
JAX package's server.  Every wait is bounded and every server is
stopped in `finally`."""
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.utils import codec as ref_codec
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server.server import Server
from nomad_tpu_torch.utils import codec as port_codec
from nomad_tpu_torch.utils.metrics import global_metrics

PKGS = {"ref": (ref_mock, ref_structs, RefServer),
        "port": (port_mock, port_structs, Server)}
CODECS = {"ref": ref_codec, "port": port_codec}


def build(pkg, n_nodes, n_jobs, count, **server_kw):
    mock, st, ServerCls = PKGS[pkg]
    if pkg == "port":
        server_kw["device"] = "cpu"
    s = ServerCls(**server_kw)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:03d}", name=f"node-{i}",
                      datacenter=f"dc{i % 2}")
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        n.compute_class()
        s.register_node(n)
        nodes.append(n)
    jobs = []
    for i in range(n_jobs):
        j = mock.job(id=f"job-{i}")
        j.datacenters = ["dc0", "dc1"]
        j.task_groups[0].count = count
        j.task_groups[0].tasks[0].resources.networks = []
        jobs.append(j)
    evals = [s.register_job(j) for j in jobs]
    return s, nodes, jobs, evals, st


def wait_complete(s, evals, st, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(s.store.eval_by_id(e.id).status == st.EVAL_STATUS_COMPLETE
               for e in evals) and s.broker.stats()["total_unacked"] == 0:
            return True
        time.sleep(0.02)
    return False


def placements(s, nodes, jobs):
    ids = [n.id for n in nodes]
    return {j.id: sorted((a.name, ids.index(a.node_id))
                         for a in s.store.allocs_by_job("default", j.id))
            for j in jobs}


def test_default_serving_tier_places_every_job():
    rounds0 = global_metrics.dump()["counters"].get("coordinator.rounds",
                                                    0.0)
    s, nodes, jobs, evals, st = build("port", 12, 10, 4)
    try:
        assert len(s.workers) == 2 and s.solve_coordinator is not None
        assert s.serving.adaptive and s.serving.pipeline
        assert s.serving.group_commit == 8
        s.start()
        assert wait_complete(s, evals, st)
        for j in jobs:
            live = [a for a in s.store.allocs_by_job("default", j.id)
                    if not a.terminal_status()]
            assert len(live) == 4, j.id
            assert len({a.name for a in live}) == 4
        for n in nodes:
            fit, dim, _ = st.allocs_fit(
                n, s.store.allocs_by_node_terminal(n.id, False))
            assert fit, (n.id, dim)
        assert s.blocked_evals.stats()["total_blocked"] == 0
        counters = global_metrics.dump()["counters"]
        assert counters.get("coordinator.rounds", 0.0) > rounds0
    finally:
        s.stop()
    assert all(not w.is_alive() for w in s.workers)


def test_single_worker_fixed_batch_matches_reference():
    out = {}
    for pkg in ("ref", "port"):
        s, nodes, jobs, evals, st = build(
            pkg, 8, 6, 3, num_workers=1,
            serving_config={"adaptive": False})
        try:
            assert s.solve_coordinator is None
            s.start()
            assert wait_complete(s, evals, st), pkg
            out[pkg] = placements(s, nodes, jobs)
        finally:
            s.stop()
    assert out["port"] == out["ref"]
    assert all(len(v) == 3 for v in out["port"].values())


def test_server_without_gpu_raises_at_first_solve(monkeypatch):
    """`Server()` defaults every worker's solver to `cuda`; where no GPU
    is present the solver raises instead of running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = Server(num_workers=1)
    try:
        assert s.device is None
        with pytest.raises(RuntimeError, match="CUDA"):
            s.workers[0].fleet_solver()
    finally:
        s.stop()


def system_run(pkg):
    """A system job on a 4-node server, one node joining after its eval
    completed (the join's node-update eval places there), then the job
    deregistered.  Returns the placements by node index after the join
    and the live allocs after the deregistration."""
    s, nodes, _jobs, _evals, st = build(pkg, 4, 0, 1, num_workers=1)
    mock = PKGS[pkg][0]
    try:
        s.start()
        job = mock.system_job(id="job-system")
        job.datacenters = ["dc0", "dc1"]
        ev = s.register_job(job)
        assert wait_complete(s, [ev], st), pkg
        n = mock.node(id="node-004", name="node-4", datacenter="dc0")
        n.node_resources.networks[0].ip = "10.0.0.5"
        n.compute_class()
        s.register_node(n)
        nodes.append(n)
        deadline = time.monotonic() + 30.0
        while (len(s.store.allocs_by_job("default", job.id)) < 5
               and time.monotonic() < deadline):
            time.sleep(0.02)
        evals = [e for e in s.store.evals() if e.job_id == job.id]
        assert wait_complete(s, evals, st), pkg
        placed = placements(s, nodes, [job])[job.id]
        triggers = sorted(e.triggered_by for e in evals)
        stop = s.deregister_job("default", job.id)
        assert wait_complete(s, [stop], st), pkg
        live = [a for a in s.store.allocs_by_job("default", job.id)
                if not a.server_terminal_status()]
        return placed, triggers, len(live)
    finally:
        s.stop()


def test_system_job_matches_reference():
    """A `system` job through both servers: one alloc on every node,
    including a node that joins later, then none after the job is
    deregistered."""
    out = {pkg: system_run(pkg) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    placed, triggers, live = out["port"]
    assert sorted(ix for _name, ix in placed) == list(range(5))
    assert triggers == ["job-register", "node-update"]
    assert live == 0


def test_serving_tier_reads_no_environment(monkeypatch):
    """The serving tier and broker read the reference's `NOMAD_TPU_*`
    variables when the server is built, and `serving_config` wins over
    them: both packages under the same setting resolve the same knobs
    (the name is kept from when the port read no environment)."""
    for name, value in (("NOMAD_TPU_BROKER_SHARDS", "4"),
                        ("NOMAD_TPU_NUM_WORKERS", "3"),
                        ("NOMAD_TPU_GROUP_COMMIT", "2"),
                        ("NOMAD_TPU_MAX_BATCH", "7")):
        monkeypatch.setenv(name, value)

    def knobs(pkg, cfg):
        ServerCls = PKGS[pkg][2]
        kw = {"device": "cpu"} if pkg == "port" else {}
        s = ServerCls(serving_config=cfg, **kw)
        try:
            return (len(s.workers), s.broker.num_shards,
                    s.serving.group_commit, s.serving.max_batch)
        finally:
            s.stop()

    for cfg, want in ((None, (3, 4, 2, 7)),
                      ({"broker_shards": 2, "max_batch": "16"},
                       (3, 2, 2, 16))):
        out = {pkg: knobs(pkg, cfg) for pkg in ("ref", "port")}
        assert out["port"] == out["ref"] == want


def test_eviction_width_from_serving_config(monkeypatch):
    """The workers' solvers take the eviction-plane width from
    `serving_config`; without it each resident world reads
    `NOMAD_TPU_EVICT_E` when it is built, else 8 (the reference's
    `tensorize.evict_width`)."""
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    for env, cfg, want in ((None, None, 8), ("3", None, 3),
                           ("3", {"evict_e": 0}, 0),
                           ("3", {"evict_e": "4"}, 4)):
        if env is not None:
            monkeypatch.setenv("NOMAD_TPU_EVICT_E", env)
        s = Server(num_workers=1, device="cpu", serving_config=cfg)
        try:
            assert s.serving.evict_e == (None if cfg is None else want)
            assert s.workers[0].fleet_solver().evict_e == want
        finally:
            s.stop()


def preempt_run(pkg):
    """A running one-worker server at the default eviction width: 600
    nodes (above the resident threshold), each full with one priority-20
    alloc entered through raft, service preemption on, then a
    priority-70 job of 3 whose placements need evictions.  Returns the
    job's placements by node index and the victims by alloc id."""
    mock, st, ServerCls = PKGS[pkg]
    codec = CODECS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    s = ServerCls(num_workers=1, serving_config={"adaptive": False}, **kw)
    try:
        nodes = []
        for i in range(600):
            n = mock.node(id=f"node-{i:03d}", name=f"node-{i}")
            n.node_resources.networks[0].ip = f"10.0.{i // 250}.{i % 250 + 1}"
            n.node_resources.cpu, n.node_resources.memory_mb = 1300, 4096
            n.reserved_resources.cpu, n.reserved_resources.memory_mb = 100, 0
            n.compute_class()
            s.register_node(n)
            nodes.append(n)
        low = mock.job(id="job-low", priority=20)
        low.task_groups[0].count = len(nodes)
        low.task_groups[0].tasks[0].resources.networks = []
        s._propose("job_upsert", {"job": codec.to_wire(low)})
        result = st.PlanResult()
        for i, n in enumerate(nodes):
            a = mock.alloc(id=f"low-{i:03d}", name=f"job-low.web[{i}]",
                           job_id=low.id, node_id=n.id)
            a.job = None
            a.client_status = st.ALLOC_CLIENT_RUNNING
            tr = a.allocated_resources.tasks["web"]
            tr.cpu, tr.memory_mb, tr.networks = 800, 256, []
            a.allocated_resources.shared.networks = []
            result.node_allocation.setdefault(n.id, []).append(a)
        s._propose("plan_result", {"result": codec.to_wire(result),
                                   "job": codec.to_wire(low)})
        s._propose("scheduler_config", {"config": {
            "preemption_service_enabled": True}})
        s.start()
        high = mock.job(id="job-high", priority=70)
        high.task_groups[0].count = 3
        high.task_groups[0].tasks[0].resources.cpu = 700
        high.task_groups[0].tasks[0].resources.networks = []
        ev = s.register_job(high)
        assert wait_complete(s, [ev], st), pkg
        ids = [n.id for n in nodes]
        allocs = s.store.allocs_by_job("default", high.id)
        return (sorted((a.name, ids.index(a.node_id),
                        tuple(a.preempted_allocations)) for a in allocs),
                sorted(a.id for a in s.store.allocs()
                       if a.desired_status == st.ALLOC_DESIRED_EVICT))
    finally:
        s.stop()


def test_server_preemption_matches_reference(monkeypatch):
    """Service preemption through both running servers at the default
    eviction width: the same placements and the same victims, chosen by
    the kernel's eviction pass in both packages."""
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    before = global_metrics.dump()["counters"].get(
        "scheduler.preempt.kernel", 0.0)
    out = {pkg: preempt_run(pkg) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    placed, evicted = out["port"]
    assert len(placed) == 3 and len(evicted) == 3
    assert all(len(v) == 1 for _name, _ix, v in placed)
    assert global_metrics.dump()["counters"].get(
        "scheduler.preempt.kernel", 0.0) - before == 3.0


def test_server_leads_again_after_losing_leadership():
    """A server that loses leadership and wins it back starts fresh
    workers (a worker thread starts once; the reference starts the
    stopped ones again and raises in its leadership callback) and
    schedules again."""
    s, nodes, jobs, evals, st = build("port", 4, 1, 2, num_workers=1)
    try:
        s.start()
        assert wait_complete(s, evals, st)
        old = list(s.workers)
        s._revoke_leadership()
        s._establish_leadership()
        assert all(w.is_alive() for w in s.workers)
        assert not any(a is b for a, b in zip(old, s.workers))
        job = port_mock.job(id="job-again")
        job.datacenters = ["dc0", "dc1"]
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].resources.networks = []
        ev = s.register_job(job)
        assert wait_complete(s, [ev], st)
        assert len(s.store.allocs_by_job("default", job.id)) == 2
    finally:
        s.stop()
