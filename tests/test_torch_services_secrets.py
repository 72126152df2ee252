"""The port's native service registrations and secret delivery, driven by
its node agent, against the JAX package's, on the CPU.

The five cases of `tests/test_services_secrets.py` run on both packages
(`pkg` = "ref" / "port"), each with its own `Server(num_workers=2)` (the
port's on `device="cpu"`) and `Client`: a task's service registered and
deregistered with it, the secret store over HTTP, `${secret.<path>.<key>}`
resolved into a task's env, a task failed by an unresolvable secret, and
a script check driving the registration's health.  The port's outcome
must equal the reference's.  Every agent is shut down with
`halt_tasks=True` and every server stopped in `finally`.
"""
import json
import os
import urllib.request

import pytest

from tests.test_torch_drivers import PKG_NAMES, Agents, Outcomes

BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)


def raw_job(P, args, env=None):
    j = P.mock.job()
    tg = j.task_groups[0]
    tg.count = 1
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", args]}
    task.resources.networks = []
    if env:
        task.env = dict(env)
    return j


def env_dump_job(P, out_file, env):
    # write-then-rename: the watcher must never read a half-written dump
    return raw_job(P, f"env > {out_file}.tmp && mv {out_file}.tmp "
                      f"{out_file}; sleep 30", env)


def read_env(path):
    return dict(line.split("=", 1) for line in open(path).read()
                .splitlines() if "=" in line)


def case_services_follow_task_lifecycle(P, tmp):
    with Agents(P, tmp) as w:
        srv = w.server
        job = raw_job(P, "sleep 60")
        job.task_groups[0].tasks[0].services = [P.structs.Service(
            name="web", port_label="http", tags=["frontend", "v1"])]
        srv.register_job(job)
        registered = P.wait_until(lambda: srv.store.services_by_name(
            "default", "web"), timeout=25)
        regs = srv.store.services_by_name("default", "web")
        out = {"registered": registered, "n": len(regs),
               "job": regs[0].job_id == job.id, "task": regs[0].task,
               "tags": sorted(regs[0].tags),
               "names": srv.store.service_names()}
        # stopping the job deregisters
        srv.deregister_job("default", job.id)
        out["deregistered"] = P.wait_until(
            lambda: not srv.store.services_by_name("default", "web"),
            timeout=20)
        return out


def case_secret_store_crud_and_http(P, tmp):
    srv = P.Server(num_workers=0)
    srv.start()
    http = P.HTTPAgentServer(srv)
    http.start()
    try:
        srv.upsert_secret("default", "db/creds",
                          {"user": "app", "pass": "hunter2"})
        out = [srv.store.secret_by_path("default", "db/creds")]

        def call(method, path, body=None):
            req = urllib.request.Request(
                http.address + path, method=method,
                data=json.dumps(body).encode() if body else None,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                return json.loads(r.read())
        call("PUT", "/v1/secret/api/key", {"data": {"token": "t0k"}})
        out.append(call("GET", "/v1/secrets"))
        out.append(call("GET", "/v1/secret/api/key")["data"])
        call("DELETE", "/v1/secret/api/key")
        out.append(call("GET", "/v1/secrets"))
        return out
    finally:
        http.stop()
        srv.stop()


def case_task_env_resolves_secret_references(P, tmp):
    with Agents(P, tmp, secrets=[("db/creds", {"pass": "hunter2"})]) as w:
        out_file = str(tmp / "envdump")
        w.server.register_job(env_dump_job(
            P, out_file, {"DB_PASS": "${secret.db/creds.pass}",
                          "PLAIN": "asis"}))
        dumped = P.wait_until(lambda: os.path.exists(out_file), timeout=25)
        env = read_env(out_file)
        return [dumped, env["DB_PASS"], env["PLAIN"]]


def case_unresolvable_secret_fails_task(P, tmp):
    with Agents(P, tmp) as w:
        srv = w.server
        j = raw_job(P, "sleep 5", {"X": "${secret.missing/path.key}"})
        srv.register_job(j)
        failed = P.wait_until(lambda: any(
            a.client_status == P.structs.ALLOC_CLIENT_FAILED
            for a in srv.store.allocs_by_job("default", j.id)),
            timeout=25)
        alloc = srv.store.allocs_by_job("default", j.id)[0]
        events = [(e.type, e.message, e.failure) for e in
                  srv.store.alloc_by_id(alloc.id).task_states["web"].events
                  if e.type == "Driver Failure"]
        return [failed, events[:1]]


def case_service_checks_drive_registration_health(P, tmp):
    flag = str(tmp / "healthy-flag")
    with Agents(P, tmp) as w:
        srv = w.server
        j = raw_job(P, "sleep 60")
        j.task_groups[0].tasks[0].services = [P.structs.Service(
            name="api", checks=[P.structs.ServiceCheck(
                name="flag", type="script", command="/bin/sh",
                args=["-c", f"test -f {flag}"], interval_s=0.3,
                timeout_s=2.0)])]
        srv.register_job(j)
        # registered but UNHEALTHY while the check fails
        registered = P.wait_until(lambda: srv.store.services_by_name(
            "default", "api"), timeout=25)
        unhealthy = P.wait_until(lambda: srv.store.services_by_name(
            "default", "api")[0].healthy is False, timeout=10)
        # flip the check -> healthy propagates through task-state sync
        open(flag, "w").write("ok")
        healthy = P.wait_until(lambda: srv.store.services_by_name(
            "default", "api")[0].healthy, timeout=15)
        return [registered, unhealthy, healthy]


OUTCOMES = Outcomes({
    "services_follow_task_lifecycle": case_services_follow_task_lifecycle,
    "secret_store_crud_and_http": case_secret_store_crud_and_http,
    "task_env_resolves_secret_references":
        case_task_env_resolves_secret_references,
    "unresolvable_secret_fails_task": case_unresolvable_secret_fails_task,
    "service_checks_drive_registration_health":
        case_service_checks_drive_registration_health,
})


@BOTH
def test_services_follow_task_lifecycle(pkg, tmp_path_factory):
    out = OUTCOMES.check("services_follow_task_lifecycle", pkg,
                         tmp_path_factory)
    assert out == {"registered": True, "n": 1, "job": True, "task": "web",
                   "tags": ["frontend", "v1"],
                   "names": [{"ServiceName": "web",
                              "Tags": ["frontend", "v1"]}],
                   "deregistered": True}


@BOTH
def test_secret_store_crud_and_http(pkg, tmp_path_factory):
    assert OUTCOMES.check("secret_store_crud_and_http", pkg,
                          tmp_path_factory) == [
        {"user": "app", "pass": "hunter2"}, ["api/key", "db/creds"],
        {"token": "t0k"}, ["db/creds"]]


@BOTH
def test_task_env_resolves_secret_references(pkg, tmp_path_factory):
    assert OUTCOMES.check("task_env_resolves_secret_references", pkg,
                          tmp_path_factory) == [True, "hunter2", "asis"]


@BOTH
def test_unresolvable_secret_fails_task(pkg, tmp_path_factory):
    failed, events = OUTCOMES.check("unresolvable_secret_fails_task", pkg,
                                    tmp_path_factory)
    assert failed and events[0][2]
    assert "unresolvable secret" in events[0][1]


@BOTH
def test_service_checks_drive_registration_health(pkg, tmp_path_factory):
    assert OUTCOMES.check("service_checks_drive_registration_health", pkg,
                          tmp_path_factory) == [True, True, True]
