"""The port's agent monitor and pprof endpoints
(`nomad_tpu_torch.utils.monitor`, `/v1/agent/monitor`,
`/v1/agent/pprof/*`) against the JAX package's, on the CPU.

The cases of `tests/test_monitor.py` that need neither the agent client
nor the CLI run on both packages (`pkg` = "ref" / "port"), each against
its own `Server` and `HTTPAgentServer(server, None)`: backlog and live
lines, level filters, the sampled CPU profile with the goroutine dump
and cmdline, the pprof ACL gate, the monitor primitives.  The port's
outcome must equal the reference's.  The solver profile
(`?mode=solver`) records with `torch.profiler` on the port (CPU
activities for a CPU server) and exports a Chrome trace."""
import json
import logging
import os
import threading
import urllib.request

import pytest

from tests.test_torch_http_api import PKG_NAMES, Agent, Outcomes, api_pkg

LOGGER = {"ref": "nomad_tpu", "port": "nomad_tpu_torch"}


def fetch(url, timeout=15.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode(errors="replace")


def monitor_agent(P, **kw):
    # the monitor observes whatever the logging config emits; the dev
    # agent sets this from its log_level stanza — the tests do it here
    logging.getLogger(LOGGER[P.name]).setLevel(logging.DEBUG)
    return Agent(P, num_workers=1, nodes=0, **kw)


def case_monitor_streams_backlog_and_live_lines(P):
    with monitor_agent(P) as ag:
        log = logging.getLogger(LOGGER[P.name] + ".test_monitor")
        log.info("backlog-marker-1")
        live = threading.Timer(0.4, lambda: log.warning("live-marker-2"))
        live.start()
        try:
            body = fetch(f"{ag.http.address}/v1/agent/monitor"
                         "?duration_s=1.5")
        finally:
            live.cancel()
        return ["backlog-marker-1" in body, "live-marker-2" in body]


def case_monitor_log_level_filters(P):
    with monitor_agent(P) as ag:
        log = logging.getLogger(LOGGER[P.name] + ".test_monitor")
        log.debug("noisy-debug-line")
        log.error("important-error-line")
        body = fetch(f"{ag.http.address}/v1/agent/monitor"
                     "?log_level=error&duration_s=0.3")
        return ["important-error-line" in body,
                "noisy-debug-line" in body]


def case_pprof_profile_and_goroutine(P):
    with monitor_agent(P) as ag:
        api = ag.api
        burn = threading.Thread(
            target=lambda: sum(i * i for i in range(3_000_000)),
            daemon=True, name="burner")
        burn.start()
        prof, _ = api.get("/v1/agent/pprof/profile", seconds=0.3)
        g, _ = api.get("/v1/agent/pprof/goroutine")
        cl, _ = api.get("/v1/agent/pprof/cmdline")
        with pytest.raises(P.client.APIError) as ei:
            api.get("/v1/agent/pprof/bogus")
        return {"seconds": prof["seconds"], "hz": prof["hz"],
                "samples": "samples:" in prof["profile"],
                "stacks": "thread " in g["stacks"],
                "threads": g["threads"] >= 2, "cmdline": bool(cl["cmdline"]),
                "bogus": ei.value.code}


def case_pprof_requires_agent_write_acl(P):
    with Agent(P, num_workers=1, nodes=0, acl_enabled=True) as ag:
        ApiClient = P.client.ApiClient
        boot, _ = ApiClient(address=ag.http.address).post(
            "/v1/acl/bootstrap")
        api = ApiClient(address=ag.http.address, token=boot["secret_id"])
        g, _ = api.get("/v1/agent/pprof/goroutine")
        api.post("/v1/acl/policy/readonly", {
            "rules": 'namespace "default" { policy = "read" } '
                     'agent { policy = "read" }'})
        tok, _ = api.post("/v1/acl/tokens", {"name": "t", "type": "client",
                                             "policies": ["readonly"]})
        ro = ApiClient(address=ag.http.address, token=tok["secret_id"])
        with pytest.raises(P.client.APIError) as ei:
            ro.get("/v1/agent/pprof/goroutine")
        with pytest.raises(P.client.APIError) as anon:
            ApiClient(address=ag.http.address).get(
                "/v1/agent/pprof/goroutine")
        return {"mgmt": "thread " in g["stacks"], "ro": ei.value.code,
                "anon": anon.value.code}


def case_log_monitor_primitives(P):
    m = P.monitor
    mon = m.LogMonitor(capacity=4)
    rec = logging.LogRecord(LOGGER[P.name] + ".x", logging.INFO, "f", 1,
                            "hello %s", ("world",), None)
    mon.emit(rec)
    q = mon.subscribe()
    level, line = q.get_nowait()
    mon.unsubscribe(q)
    out = m.sample_profile(seconds=0.05, hz=50)
    return {"level": level, "line": "hello world" in line,
            "dump": bool(m.thread_dump()),
            "profile": out.startswith("samples:"),
            "levels": [m.parse_level(x) for x in
                       ("trace", "debug", "info", "warn", "error", "", "?")]}


OUTCOMES = Outcomes({
    "monitor_streams_backlog_and_live_lines":
        case_monitor_streams_backlog_and_live_lines,
    "monitor_log_level_filters": case_monitor_log_level_filters,
    "pprof_profile_and_goroutine": case_pprof_profile_and_goroutine,
    "pprof_requires_agent_write_acl": case_pprof_requires_agent_write_acl,
    "log_monitor_primitives": case_log_monitor_primitives,
})


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_monitor_streams_backlog_and_live_lines(pkg):
    assert OUTCOMES.check("monitor_streams_backlog_and_live_lines",
                          pkg) == [True, True]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_monitor_log_level_filters(pkg):
    assert OUTCOMES.check("monitor_log_level_filters", pkg) == [True,
                                                                False]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_pprof_profile_and_goroutine(pkg):
    out = OUTCOMES.check("pprof_profile_and_goroutine", pkg)
    assert out == {"seconds": 0.3, "hz": 100, "samples": True,
                   "stacks": True, "threads": True, "cmdline": True,
                   "bogus": 404}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_pprof_requires_agent_write_acl(pkg):
    out = OUTCOMES.check("pprof_requires_agent_write_acl", pkg)
    assert out == {"mgmt": True, "ro": 403, "anon": 403}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_log_monitor_primitives(pkg):
    out = OUTCOMES.check("log_monitor_primitives", pkg)
    assert out["level"] == logging.INFO and out["line"]
    assert out["dump"] and out["profile"]


def test_solver_profile_records_a_chrome_trace_on_the_cpu():
    """`/v1/agent/pprof/profile?mode=solver&job_id=` drives what-if plan
    solves of the job through the worker's plan view inside a
    `torch.profiler` window (CPU activities: the server solves on the
    CPU) and answers the reference's keys; the artifact directory holds
    the exported Chrome trace, with the solves' CPU events in it.  An
    unknown job answers 500, as a failed profiler window does."""
    P = api_pkg("port")
    with Agent(P, num_workers=1) as ag:
        job, _ = ag.register_httpd()
        prof, _ = ag.api.get("/v1/agent/pprof/profile", seconds=0.3,
                             mode="solver", job_id="httpd")
        assert sorted(prof) == ["artifact", "mode", "seconds", "solves"]
        assert prof["mode"] == "solver" and prof["solves"] > 0
        path = os.path.join(prof["artifact"],
                            P.http_server.SOLVER_TRACE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert events and all(e.get("cat") != "kernel" for e in events)
        with pytest.raises(P.client.APIError) as ei:
            ag.api.get("/v1/agent/pprof/profile", seconds=0.1,
                       mode="solver", job_id="no-such-job")
        assert ei.value.code == 500
