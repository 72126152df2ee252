"""The port's agent client routes (`/v1/client/fs/*`, `/v1/client/stats`,
`/v1/client/allocation/:id/stats`, the monitor's `?node_id=`) and their
forwarding to the owning agent, against the JAX package's, on the CPU.

The six cases of `tests/test_client_fs.py` that need no CLI,
`test_logs_route_to_owning_agent` and `test_unknown_alloc_still_404s` of
`tests/test_client_routing.py`, `test_client_logs_endpoint` of
`tests/test_http_api.py` and `test_monitor_routes_to_owning_node` of
`tests/test_monitor.py` run on both packages (`pkg` = "ref" / "port").
Each package gets one cluster for the module: a `Server(num_workers=2)`
(the port's on `device="cpu"`), two `Client`s, each with its own
`HTTPAgentServer` advertising `unique.advertise.http`, and two raw_exec
jobs pinned to the second agent, so that every read through the first
agent is forwarded.  A case returns an outcome of what it saw; the
port's must equal the reference's.  The clusters shut their agents down
with `halt_tasks=True` at the end of the module.
"""
import json
import logging
import urllib.error
import urllib.request
from urllib.parse import urlencode

import pytest

from tests.test_torch_drivers import PKG_NAMES, Agents, agent_pkg

BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)
LOGGER = {"ref": "nomad_tpu", "port": "nomad_tpu_torch"}


def pinned_job(P, job_id, args, node_id):
    job = P.mock.job()
    job.id = job_id
    job.name = job_id
    tg = job.task_groups[0]
    tg.count = 1
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", args]}
    task.resources.networks = []
    job.constraints = [P.structs.Constraint("${node.unique.id}", node_id,
                                            "=")]
    return job


def running_alloc(P, server, job):
    assert P.wait_until(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job(job.namespace, job.id)),
        timeout=60)
    return next(a for a in server.store.allocs_by_job(job.namespace, job.id)
                if a.client_status == "running")


class Cluster(Agents):
    """One package's server, two agents with HTTP, and the two jobs."""

    def __init__(self, P, tmp):
        super().__init__(P, tmp, 2, http=True)
        try:
            self.c1, self.c2 = self.clients
            self.h1, self.h2 = self.https
            self.api1 = P.ApiClient(address=self.h1.address)
            self.api2 = P.ApiClient(address=self.h2.address)
            fs_job = pinned_job(P, "fsjob",
                                "echo payload > $NOMAD_TASK_DIR/out.txt; "
                                "echo line1; sleep 120", self.c2.node.id)
            routed = pinned_job(P, "routed-logs",
                                "echo routed-log-line; sleep 120",
                                self.c2.node.id)
            for job in (fs_job, routed):
                self.server.register_job(job)
            self.alloc = running_alloc(P, self.server, fs_job)
            self.routed = running_alloc(P, self.server, routed)
            assert P.wait_until(lambda: "line1" in self.api1.allocations
                                .logs(self.alloc.id, task="web"),
                                timeout=20)
        except BaseException:
            self.close()
            raise


CLUSTERS = {}
SEEN = {}


@pytest.fixture(scope="module", autouse=True)
def _close_clusters():
    yield
    while CLUSTERS:
        CLUSTERS.popitem()[1].close()
    SEEN.clear()


def outcome(case, pkg, tmp_path_factory):
    """The case's outcome on `pkg` (computed once); on the port it must
    equal the reference's."""
    def get(p):
        if (case, p) not in SEEN:
            if p not in CLUSTERS:
                CLUSTERS[p] = Cluster(agent_pkg(p),
                                      tmp_path_factory.mktemp(f"fs-{p}"))
            SEEN[(case, p)] = CASES[case](CLUSTERS[p])
        return SEEN[(case, p)]
    out = get(pkg)
    if pkg == "port":
        assert out == get("ref")
    return out


def api_error(cl, fn):
    with pytest.raises(cl.P.APIError) as e:
        fn()
    return e.value.code, e.value.msg


# -------------------------------------------------- test_client_fs.py
def case_logs_visible_while_task_running(cl):
    """stdout written before the task's sleep is readable through
    /v1/client/fs/logs while the task is still up."""
    runner = cl.c2.get_alloc_runner(cl.alloc.id)
    return [runner is not None and not runner.is_done(),
            "line1" in cl.api1.allocations.logs(cl.alloc.id, task="web")]


def case_fs_ls_and_stat(cl):
    entries = cl.api1.allocations.fs_ls(cl.alloc.id, "/")
    logs = cl.api1.allocations.fs_ls(cl.alloc.id, "alloc/logs")
    st = cl.api1.allocations.fs_stat(cl.alloc.id, "web/local/out.txt")
    return {"root": sorted(e["name"] for e in entries),
            "logs": sorted(e["name"] for e in logs
                           if e["name"].startswith("web.")),
            "stat": (st["name"], st["is_dir"], st["size"])}


def case_fs_cat_and_readat(cl):
    return [cl.api1.allocations.fs_cat(cl.alloc.id, "web/local/out.txt"),
            cl.api1.allocations.fs_readat(cl.alloc.id, "web/local/out.txt",
                                          offset=3, limit=4)]


def case_fs_stream_follows_growth(cl):
    api1 = cl.api1
    path = "alloc/logs/web.stdout.0"
    st = api1.allocations.fs_stat(cl.alloc.id, path)
    runner = cl.c2.get_alloc_runner(cl.alloc.id)
    step0 = api1.allocations.fs_stream(cl.alloc.id, path,
                                       offset=st["size"], wait=0.2)
    # append through the running task's own stdout file on disk
    with open(runner.alloc_dir.stdout_path("web"), "ab") as f:
        f.write(b"line2\n")
    step1 = api1.allocations.fs_stream(cl.alloc.id, path,
                                       offset=st["size"], wait=5.0)
    return [step0["data"], step1["data"],
            step1["offset"] == st["size"] + len(step1["data"])]


def case_fs_denies_secrets_and_escape(cl):
    api1 = cl.api1
    return [api_error(cl, lambda: api1.allocations.fs_ls(cl.alloc.id,
                                                         "web/secrets")),
            api_error(cl, lambda: api1.allocations.fs_cat(
                cl.alloc.id, "../../../../etc/passwd"))]


def case_host_and_alloc_stats(cl):
    st = cl.api1.nodes.stats()                       # agent 1's host
    st2 = cl.api1.nodes.stats(cl.c2.node.id)         # routed to agent 2
    astats = cl.api1.allocations.stats(cl.alloc.id)  # routed too
    ts = astats["tasks"]["web"]
    return {"memory": st["memory"]["total"] > 0,
            "uptime": st["uptime_s"] > 0, "keys": sorted(st), "routed_memory": st2["memory"]["total"] > 0,
            "disk": st2["disk"]["path"] == cl.c2.data_dir,
            "alloc_id": astats["alloc_id"] == cl.alloc.id,
            "task": sorted(ts), "procs": ts["num_procs"] >= 1,
            "rss": ts["rss_bytes"] > 0}


# ---------------------------------------------- test_client_routing.py
def case_logs_route_to_owning_agent(cl):
    alloc = cl.routed
    local = cl.P.wait_until(lambda: "routed-log-line" in cl.api2.allocations
                            .logs(alloc.id, task="web"), timeout=20)
    # the same request against agent 1 (which does NOT run the alloc)
    # returns the same logs by routing
    return [alloc.node_id == cl.c2.node.id, local,
            cl.api1.allocations.logs(alloc.id, task="web")]


def case_unknown_alloc_still_404s(cl):
    return api_error(cl, lambda: cl.api1.allocations.logs(
        "ffffffff-dead-beef", task="web"))


# ---------------------------------------------------- test_http_api.py
def case_client_logs_endpoint(cl):
    """Alloc log retrieval from the local agent, over plain HTTP."""
    alloc = cl.routed

    def logs(**params):
        url = (f"{cl.h2.address}/v1/client/fs/logs/{alloc.id}"
               + ("?" + urlencode(params) if params else ""))
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.loads(r.read())
    seen = cl.P.wait_until(lambda: "routed-log-line" in logs()["data"],
                           timeout=10)
    return [seen, logs(), logs(type="stderr"), logs(tail_lines=1)]


# ----------------------------------------------------- test_monitor.py
def fetch(url, timeout=15.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode(errors="replace")


def case_monitor_routes_to_owning_node(cl):
    """?node_id= of this agent's own node is served here; an unknown node
    is a 404; another agent's node is relayed from that agent."""
    root = LOGGER[cl.P.name]
    logging.getLogger(root).setLevel(logging.DEBUG)
    logging.getLogger(root + ".test_monitor").info("routed-marker-3")
    own = fetch(f"{cl.h1.address}/v1/agent/monitor"
                f"?node_id={cl.c1.node.id[:8]}&duration_s=0.3")
    with pytest.raises(urllib.error.HTTPError) as ei:
        fetch(f"{cl.h1.address}/v1/agent/monitor"
              f"?node_id=doesnotexist&duration_s=0.2")
    relayed = fetch(f"{cl.h1.address}/v1/agent/monitor"
                    f"?node_id={cl.c2.node.id[:8]}&duration_s=0.3")
    return ["routed-marker-3" in own, ei.value.code,
            "routed-marker-3" in relayed]


CASES = {
    "logs_visible_while_task_running": case_logs_visible_while_task_running,
    "fs_ls_and_stat": case_fs_ls_and_stat,
    "fs_cat_and_readat": case_fs_cat_and_readat,
    "fs_stream_follows_growth": case_fs_stream_follows_growth,
    "fs_denies_secrets_and_escape": case_fs_denies_secrets_and_escape,
    "host_and_alloc_stats": case_host_and_alloc_stats,
    "logs_route_to_owning_agent": case_logs_route_to_owning_agent,
    "unknown_alloc_still_404s": case_unknown_alloc_still_404s,
    "client_logs_endpoint": case_client_logs_endpoint,
    "monitor_routes_to_owning_node": case_monitor_routes_to_owning_node,
}


@BOTH
def test_logs_visible_while_task_running(pkg, tmp_path_factory):
    assert outcome("logs_visible_while_task_running", pkg,
                   tmp_path_factory) == [True, True]


@BOTH
def test_fs_ls_and_stat(pkg, tmp_path_factory):
    out = outcome("fs_ls_and_stat", pkg, tmp_path_factory)
    assert {"alloc", "web"} <= set(out["root"])
    assert "web.stdout.0" in out["logs"]
    assert out["stat"] == ("out.txt", False, len("payload\n"))


@BOTH
def test_fs_cat_and_readat(pkg, tmp_path_factory):
    assert outcome("fs_cat_and_readat", pkg,
                   tmp_path_factory) == [b"payload\n", b"load"]


@BOTH
def test_fs_stream_follows_growth(pkg, tmp_path_factory):
    step0, step1, offset_ok = outcome("fs_stream_follows_growth", pkg,
                                      tmp_path_factory)
    assert step0 == b"" and b"line2" in step1 and offset_ok


@BOTH
def test_fs_denies_secrets_and_escape(pkg, tmp_path_factory):
    secrets, escape = outcome("fs_denies_secrets_and_escape", pkg,
                              tmp_path_factory)
    assert secrets[0] == 403 and escape[0] == 403


@BOTH
def test_host_and_alloc_stats(pkg, tmp_path_factory):
    out = outcome("host_and_alloc_stats", pkg, tmp_path_factory)
    assert out["memory"] and out["uptime"] and out["routed_memory"]
    assert out["disk"] and out["alloc_id"] and out["procs"] and out["rss"]


@BOTH
def test_logs_route_to_owning_agent(pkg, tmp_path_factory):
    owner, local, routed = outcome("logs_route_to_owning_agent", pkg,
                                   tmp_path_factory)
    assert owner and local and "routed-log-line" in routed


@BOTH
def test_unknown_alloc_still_404s(pkg, tmp_path_factory):
    code, _msg = outcome("unknown_alloc_still_404s", pkg, tmp_path_factory)
    assert code == 404


@BOTH
def test_client_logs_endpoint(pkg, tmp_path_factory):
    seen, out, err, tail = outcome("client_logs_endpoint", pkg,
                                   tmp_path_factory)
    assert seen and "routed-log-line" in out["data"]
    assert err["type"] == "stderr"
    assert tail["data"].strip() == "routed-log-line"


@BOTH
def test_monitor_routes_to_owning_node(pkg, tmp_path_factory):
    assert outcome("monitor_routes_to_owning_node", pkg,
                   tmp_path_factory) == [True, 404, True]
