"""The port's node agent (`nomad_tpu_torch.client.agent.Client` with its
alloc and task runners over the raw_exec driver) against the JAX
package's, on the CPU.

Each case of `tests/test_client_agent.py` runs on both packages (`pkg` =
"ref" / "port"): each side starts its own `Server(num_workers=2)` (the
port's on `device="cpu"`) and its own `Client` on a fresh data dir, runs
real subprocesses under raw_exec, and returns an outcome of what it saw
(alloc and task states, restarts, what the task printed, whether the
pid survived an agent restart and was re-attached).  The port's outcome
must equal the reference's.  The fingerprint case gives both agents a
registry of raw_exec and mock only (the port has no `exec` driver yet).
Every case shuts its agent down with `halt_tasks=True` and stops its
server in `finally`, so no task outlives it.
"""
import os

import pytest

from tests.test_torch_drivers import PKG_NAMES, Agents, Outcomes

BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)


def rawexec_job(P, command="/bin/sh", args=None, count=1, **kw):
    j = P.mock.job(**kw)
    j.task_groups[0].count = count
    task = j.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": command, "args": args or []}
    task.resources.networks = []        # keep placement trivial
    return j


def batch_once(P, job):
    job.type = P.structs.JOB_TYPE_BATCH
    for tg in job.task_groups:
        tg.reschedule_policy = P.structs.ReschedulePolicy(
            attempts=0, unlimited=False)
    return job


def running_allocs(P, server, job_id):
    return [a for a in server.store.allocs_by_job("default", job_id)
            if a.client_status == P.structs.ALLOC_CLIENT_RUNNING]


def task_pid(client, alloc_id):
    tr = client.get_alloc_runner(alloc_id).task_runners[0]
    return tr.handle.driver_state["pid"]


def case_rawexec_end_to_end_real_subprocess(P, tmp_path):
    with Agents(P, tmp_path) as r:
        server, client = r.server, r.client
        job = rawexec_job(P, args=["-c", "sleep 30"])
        server.register_job(job)
        ran = P.wait_until(lambda: len(running_allocs(P, server, job.id))
                           == 1, timeout=15)
        alloc = running_allocs(P, server, job.id)[0]
        pid = task_pid(client, alloc.id)
        alive = P.executor.pid_alive(pid)
        # stopping the job kills the real process
        server.deregister_job("default", job.id)
        gone = P.wait_until(lambda: not P.executor.pid_alive(pid),
                            timeout=15)
        terminal = P.wait_until(
            lambda: all(a.client_terminal_status() for a in
                        server.store.allocs_by_job("default", job.id)),
            timeout=10)
        return [ran, alive, gone, terminal]


def case_agent_restart_reattaches_task(P, tmp_path):
    """Kill the agent, restart it, and the task is re-attached (same pid),
    not re-run."""
    with Agents(P, tmp_path) as r:
        server, client = r.server, r.client
        node = client.node
        job = rawexec_job(P, args=["-c", "sleep 60"])
        server.register_job(job)
        ran = P.wait_until(lambda: len(running_allocs(P, server, job.id))
                           == 1, timeout=15)
        alloc = running_allocs(P, server, job.id)[0]
        pid = task_pid(client, alloc.id)
        started_at = client.get_alloc_runner(alloc.id) \
            .task_runners[0].task_state().started_at
        # hard-stop the agent WITHOUT touching the workload
        client.shutdown(halt_tasks=False)
        r.clients.remove(client)
        survived = P.executor.pid_alive(pid)
        client2 = r.add(tmp_path / "agent0", node=node)
        restored = P.wait_until(lambda: client2.get_alloc_runner(alloc.id)
                                is not None, timeout=5)
        tr = client2.get_alloc_runner(alloc.id).task_runners[0]
        attached = P.wait_until(lambda: tr.handle is not None, timeout=5)
        out = {"ran": ran, "survived": survived, "restored": restored,
               "attached": attached,
               "same_pid": tr.handle.driver_state["pid"] == pid,
               "alive": P.executor.pid_alive(pid),
               "same_start": tr.task_state().started_at == started_at,
               "restarts": tr.task_state().restarts}
        # and the re-attached task can still be stopped normally
        server.deregister_job("default", job.id)
        out["stopped"] = P.wait_until(
            lambda: not P.executor.pid_alive(pid), timeout=15)
        return out


def case_batch_job_completes_with_exit_zero(P, tmp_path):
    with Agents(P, tmp_path) as r:
        server = r.server
        job = batch_once(P, rawexec_job(P, command="/bin/true"))
        server.register_job(job)
        done = P.wait_until(lambda: any(
            a.client_status == P.structs.ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id)),
            timeout=15)
        alloc = server.store.allocs_by_job("default", job.id)[0]
        ts = server.store.alloc_by_id(alloc.id).task_states["web"]
        return [done, ts.state, ts.failed]


def case_failing_batch_task_restarts_then_fails(P, tmp_path):
    with Agents(P, tmp_path) as r:
        server = r.server
        job = batch_once(P, rawexec_job(P, command="/bin/false"))
        for tg in job.task_groups:
            tg.restart_policy = P.structs.RestartPolicy(
                attempts=1, interval_s=300.0, delay_s=0.05, mode="fail")
        server.register_job(job)
        failed = P.wait_until(lambda: any(
            a.client_status == P.structs.ALLOC_CLIENT_FAILED
            for a in server.store.allocs_by_job("default", job.id)),
            timeout=20)
        alloc = server.store.allocs_by_job("default", job.id)[0]
        ts = server.store.alloc_by_id(alloc.id).task_states["web"]
        return [failed, ts.failed, ts.restarts]


def case_task_env_and_stdout_capture(P, tmp_path):
    with Agents(P, tmp_path) as r:
        server, client = r.server, r.client
        job = batch_once(P, rawexec_job(
            P, args=["-c", 'echo "alloc=$NOMAD_ALLOC_ID '
                           'task=$NOMAD_TASK_NAME job=$NOMAD_JOB_ID '
                           'custom=$FOO"']))
        server.register_job(job)
        done = P.wait_until(lambda: any(
            a.client_status == P.structs.ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id)),
            timeout=15)
        alloc = server.store.allocs_by_job("default", job.id)[0]
        out_path = client.get_alloc_runner(alloc.id) \
            .alloc_dir.stdout_path("web")
        written = P.wait_until(lambda: os.path.exists(out_path)
                               and os.path.getsize(out_path) > 0,
                               timeout=5)
        out = open(out_path).read()
        return [done, written,
                out.replace(alloc.id, "<alloc>").replace(job.id, "<job>")]


def case_deployment_health_reported(P, tmp_path):
    with Agents(P, tmp_path) as r:
        server = r.server
        job = rawexec_job(P, args=["-c", "sleep 30"])
        job.task_groups[0].update = P.structs.UpdateStrategy(
            max_parallel=1, min_healthy_time_s=0.2,
            healthy_deadline_s=30.0)
        server.register_job(job)
        ran = P.wait_until(lambda: len(running_allocs(P, server, job.id))
                           == 1, timeout=15)
        alloc = running_allocs(P, server, job.id)[0]
        healthy = P.wait_until(
            lambda: (server.store.alloc_by_id(alloc.id).deployment_status
                     is not None
                     and server.store.alloc_by_id(alloc.id)
                     .deployment_status.is_healthy()),
            timeout=10)
        return [ran, bool(alloc.deployment_id), healthy]


def case_node_fingerprint_registers_drivers(P, tmp_path):
    reg = P.drivers.DriverRegistry()
    reg.register(P.RawExecDriver())
    reg.register(P.MockDriver())
    with Agents(P, tmp_path, registry=reg) as r:
        node = r.server.store.node_by_id(r.client.node.id)
        return {"ready": node is not None and node.ready(),
                "raw_exec": node.attributes.get("driver.raw_exec"),
                "mock": node.attributes.get("driver.mock_driver"),
                "numcores": node.attributes.get("cpu.numcores")
                == str(os.cpu_count() or 1),
                "class": bool(node.computed_class),
                "drivers": sorted(k for k in node.attributes
                                  if k.startswith("driver."))}


def case_node_identity_persisted_across_restarts(P, tmp_path):
    server = P.Server(num_workers=2)
    server.start()
    try:
        c1 = P.Client(server, data_dir=str(tmp_path))
        node_id, secret = c1.node.id, c1.node.secret_id
        c1.start()
        c1.shutdown()
        c2 = P.Client(server, data_dir=str(tmp_path))
        try:
            return [c2.node.id == node_id, c2.node.secret_id == secret]
        finally:
            c2.state_db.close()
    finally:
        server.stop()


OUTCOMES = Outcomes({
    "rawexec_end_to_end_real_subprocess":
        case_rawexec_end_to_end_real_subprocess,
    "agent_restart_reattaches_task": case_agent_restart_reattaches_task,
    "batch_job_completes_with_exit_zero":
        case_batch_job_completes_with_exit_zero,
    "failing_batch_task_restarts_then_fails":
        case_failing_batch_task_restarts_then_fails,
    "task_env_and_stdout_capture": case_task_env_and_stdout_capture,
    "deployment_health_reported": case_deployment_health_reported,
    "node_fingerprint_registers_drivers":
        case_node_fingerprint_registers_drivers,
    "node_identity_persisted_across_restarts":
        case_node_identity_persisted_across_restarts,
})


@BOTH
def test_rawexec_end_to_end_real_subprocess(pkg, tmp_path_factory):
    assert OUTCOMES.check("rawexec_end_to_end_real_subprocess", pkg,
                          tmp_path_factory) == [True] * 4


@BOTH
def test_agent_restart_reattaches_task(pkg, tmp_path_factory):
    out = OUTCOMES.check("agent_restart_reattaches_task", pkg,
                         tmp_path_factory)
    assert out == {"ran": True, "survived": True, "restored": True,
                   "attached": True, "same_pid": True, "alive": True,
                   "same_start": True, "restarts": 0, "stopped": True}


@BOTH
def test_batch_job_completes_with_exit_zero(pkg, tmp_path_factory):
    assert OUTCOMES.check("batch_job_completes_with_exit_zero", pkg,
                          tmp_path_factory) == [True, "dead", False]


@BOTH
def test_failing_batch_task_restarts_then_fails(pkg, tmp_path_factory):
    # one restart attempt before failing
    assert OUTCOMES.check("failing_batch_task_restarts_then_fails", pkg,
                          tmp_path_factory) == [True, True, 1]


@BOTH
def test_task_env_and_stdout_capture(pkg, tmp_path_factory):
    done, written, out = OUTCOMES.check("task_env_and_stdout_capture", pkg,
                                        tmp_path_factory)
    assert done and written
    # the mock job's env FOO=bar, interpolated
    assert out == "alloc=<alloc> task=web job=<job> custom=bar\n"


@BOTH
def test_deployment_health_reported(pkg, tmp_path_factory):
    assert OUTCOMES.check("deployment_health_reported", pkg,
                          tmp_path_factory) == [True, True, True]


@BOTH
def test_node_fingerprint_registers_drivers(pkg, tmp_path_factory):
    out = OUTCOMES.check("node_fingerprint_registers_drivers", pkg,
                         tmp_path_factory)
    assert out["ready"] and out["numcores"] and out["class"]
    assert (out["raw_exec"], out["mock"]) == ("1", "1")


@BOTH
def test_node_identity_persisted_across_restarts(pkg, tmp_path_factory):
    assert OUTCOMES.check("node_identity_persisted_across_restarts", pkg,
                          tmp_path_factory) == [True, True]
