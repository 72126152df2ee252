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
server on the same cluster and jobs.  Every wait is bounded and every
server is stopped in `finally`."""
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server.server import Server
from nomad_tpu_torch.utils.metrics import global_metrics

PKGS = {"ref": (ref_mock, ref_structs, RefServer),
        "port": (port_mock, port_structs, Server)}


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


def test_gossip_autopilot_is_not_ported():
    s = Server(num_workers=0, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="membership"):
            s.attach_gossip(object())
        with pytest.raises(NotImplementedError, match="membership"):
            s._autopilot_reconcile()
    finally:
        s.stop()


def test_system_eval_fails_visibly():
    """A `system` job's eval goes through the worker's error path: the
    scheduler is not ported, so the eval is marked failed with the
    scheduler's `NotImplementedError`, not left pending."""
    s, _nodes, _jobs, _evals, st = build("port", 2, 0, 1, num_workers=1)
    try:
        s.start()
        job = port_mock.system_job(id="job-system")
        ev = s.register_job(job)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            got = s.store.eval_by_id(ev.id)
            if got.status == st.EVAL_STATUS_FAILED:
                break
            time.sleep(0.02)
        assert got.status == st.EVAL_STATUS_FAILED
        assert "system scheduler is not ported" in got.status_description
        assert not s.store.allocs_by_job("default", job.id)
    finally:
        s.stop()


def test_serving_tier_reads_no_environment(monkeypatch):
    """The port's serving tier and broker take their knobs from
    `serving_config` only: an environment set for the reference does
    not change them."""
    for name, value in (("NOMAD_TPU_BROKER_SHARDS", "4"),
                        ("NOMAD_TPU_NUM_WORKERS", "3"),
                        ("NOMAD_TPU_GROUP_COMMIT", "2"),
                        ("NOMAD_TPU_MAX_BATCH", "7")):
        monkeypatch.setenv(name, value)
    s = Server(device="cpu")
    try:
        assert len(s.workers) == 2
        assert s.broker.num_shards == 1
        assert s.serving.group_commit == 8
        assert s.serving.max_batch == 64
    finally:
        s.stop()
    s = Server(device="cpu", serving_config={"broker_shards": 2,
                                             "max_batch": "16"})
    try:
        assert s.broker.num_shards == 2
        assert s.serving.max_batch == 16
    finally:
        s.stop()
