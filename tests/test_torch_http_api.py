"""The port's HTTP API (`nomad_tpu_torch.api`) against the JAX package's,
on the CPU.

Each case of `tests/test_http_api.py` that needs neither the CLI nor the
agent client runs on both packages (`pkg` = "ref" / "port"): each side
builds its own `Server(num_workers=2)` (the port's on `device="cpu"`),
one `SimClient` node from its own `client/sim.py` (it "runs" the
`raw_exec` job) and `HTTPAgentServer(server, None)`, and drives it
through its own `ApiClient`.  A case returns an outcome of what it saw:
status codes, error bodies, job / eval / alloc statuses, whether a
blocking query's index moved, the plan's annotations and its `diff`;
the port's outcome must equal the reference's.  The agent-client routes
answer as the reference's on an agent with no node agent; those that
wait for the `exec` driver and CSI answer the port's unknown-route 404."""
import copy
import threading
import time
import types
import urllib.request

import pytest

PKG_NAMES = ("ref", "port")

HCL = """
job "httpd" {
  datacenters = ["dc1"]
  group "web" {
    count = 2
    task "sleep" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args    = ["-c", "sleep 60"]
      }
      resources { cpu = 100  memory = 64 }
    }
  }
}
"""


def api_pkg(name):
    """The modules one side of a case uses, by package."""
    if name == "ref":
        from nomad_tpu import mock, structs
        from nomad_tpu.api import client, http_server
        from nomad_tpu.client import sim
        from nomad_tpu.server import search
        from nomad_tpu.server.server import Server
        from nomad_tpu.state.store import StateStore
        from nomad_tpu.structs import diff
        from nomad_tpu.utils import codec, metrics, monitor, tracing
        server_kw = {}
    else:
        from nomad_tpu_torch import mock, structs
        from nomad_tpu_torch.api import client, http_server
        from nomad_tpu_torch.client import sim
        from nomad_tpu_torch.server import search
        from nomad_tpu_torch.server.server import Server
        from nomad_tpu_torch.state.store import StateStore
        from nomad_tpu_torch.structs import diff
        from nomad_tpu_torch.utils import codec, metrics, monitor, tracing
        server_kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, mock=mock, structs=structs, client=client,
        http_server=http_server, sim=sim, search=search,
        StateStore=StateStore, diff=diff, codec=codec, metrics=metrics,
        monitor=monitor, tracing=tracing,
        Server=lambda **kw: Server(**server_kw, **kw))


class Outcomes:
    """Each case's outcome per package, computed once: the port's case
    compares its outcome with the reference's (run on demand)."""

    def __init__(self, cases, make=None):
        self.cases = cases
        self.make = make or api_pkg
        self.seen = {}

    def get(self, case, pkg):
        key = (case, pkg)
        if key not in self.seen:
            self.seen[key] = self.cases[case](self.make(pkg))
        return self.seen[key]

    def check(self, case, pkg):
        out = self.get(case, pkg)
        if pkg == "port":
            assert out == self.get(case, "ref")
        return out


def sim_node(P, i=0):
    n = P.mock.node(id=f"node-{i:04d}-aaaa-bbbb", name=f"node-{i}")
    n.attributes["driver.raw_exec"] = "1"
    n.compute_class()
    return n


class Agent:
    """One package's server, simulated node and HTTP agent."""

    def __init__(self, P, num_workers=2, nodes=1, acl_enabled=False):
        self.P = P
        self.server = P.Server(num_workers=num_workers)
        self.server.start()
        self.sims = []
        try:
            for i in range(nodes):
                c = P.sim.SimClient(self.server, sim_node(P, i))
                c.start()
                self.sims.append(c)
            self.http = P.http_server.HTTPAgentServer(
                self.server, None, port=0, acl_enabled=acl_enabled)
            self.http.start()
        except BaseException:
            self.close()
            raise
        self.api = P.client.ApiClient(address=self.http.address)

    def close(self):
        if getattr(self, "http", None) is not None:
            self.http.stop()
        for c in self.sims:
            c.stop()
        self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def register_httpd(self):
        """Register the HCL job over HTTP and wait for both allocs to
        run; returns the register response."""
        api = self.api
        job = api.jobs.parse(HCL)
        resp = api.jobs.register(job)
        assert self.P.sim.wait_until(lambda: len(
            api.jobs.allocations("httpd")) == 2 and all(
            a["ClientStatus"] == "running"
            for a in api.jobs.allocations("httpd")), timeout=30)
        return job, resp

    def quiesce(self, settle_s=1.0):
        """Wait until the store's index stops moving for `settle_s`."""
        stable = {}

        def quiet():
            cur = self.server.store.latest_index()
            if stable.get("idx") != cur:
                stable["idx"] = cur
                stable["t"] = time.monotonic()
                return False
            return time.monotonic() - stable["t"] > settle_s
        assert self.P.sim.wait_until(quiet, timeout=20)


def error_of(P, fn):
    with pytest.raises(P.client.APIError) as e:
        fn()
    return e.value.code, e.value.msg


# ------------------------------------------------------------- cases
def case_parse_register_and_status(P):
    with Agent(P) as ag:
        api = ag.api
        job, resp = ag.register_httpd()
        info, index = api.jobs.info("httpd")
        evs = api.jobs.evaluations("httpd")
        ev = api.evaluations.info(resp["eval_id"])
        assert P.sim.wait_until(lambda: api.jobs.summary(
            "httpd")["summary"]["web"]["running"] == 2, timeout=10)
        return {"id": job["id"], "count": job["task_groups"][0]["count"],
                "eval_id": bool(resp["eval_id"]),
                "job_status": info["status"] in ("running", "pending"),
                "index": index > 0,
                "evals": [e["job_id"] for e in evs][:1],
                "eval_status": ev["status"],
                "allocs": sorted(a["ClientStatus"]
                                 for a in api.jobs.allocations("httpd"))}


def case_blocking_query_fires_on_change(P):
    with Agent(P) as ag:
        _, index = ag.api.jobs.list()
        result = {}

        def blocked():
            _jobs, new_index = ag.api.jobs.list(index=index, wait="10s")
            result["index"] = new_index
            result["t"] = time.monotonic()

        t0 = time.monotonic()
        th = threading.Thread(target=blocked)
        th.start()
        time.sleep(0.3)
        still_blocked = "index" not in result
        ag.server.register_job(P.mock.job())
        th.join(timeout=5.0)
        return {"blocked": still_blocked,
                "moved": result.get("index", 0) > index,
                "woke_on_write": result.get("t", 1e9) - t0 < 5.0}


def case_alloc_and_node_endpoints(P):
    with Agent(P) as ag:
        api = ag.api
        ag.register_httpd()
        allocs, _ = api.allocations.list()
        httpd = [al for al in allocs if al["JobID"] == "httpd"]
        a = api.allocations.info(httpd[0]["ID"])
        nodes, _ = api.nodes.list()
        node = api.nodes.info(nodes[0]["id"][:8])      # prefix resolution
        return {"httpd_allocs": len(httpd),
                "alloc_id": a["id"] == httpd[0]["ID"],
                "task_states": sorted(a["task_states"]),
                "nodes": len(nodes),
                "node": node["id"] == ag.sims[0].node.id,
                "node_allocs": len(api.nodes.allocations(node["id"]))}


def case_node_eligibility_and_drain(P):
    with Agent(P) as ag:
        node_id = ag.sims[0].node.id
        seen = []
        for eligible in (False, True):
            ag.api.nodes.eligibility(node_id, eligible)
            seen.append(ag.server.store.node_by_id(
                node_id).scheduling_eligibility)
        resp = ag.api.nodes.drain(node_id, deadline_s=60.0)
        seen.append(sorted(resp))
        seen.append(ag.server.store.node_by_id(
            node_id).scheduling_eligibility)
        return seen


def case_job_plan_dry_run_does_not_mutate(P):
    with Agent(P) as ag:
        api = ag.api
        job, _ = ag.register_httpd()
        ag.quiesce()
        before = ag.server.store.latest_index()
        n_allocs = len(ag.server.store.allocs())
        new = api.jobs.parse(HCL.replace('"httpd"', '"planonly"'))
        fresh = api.jobs.plan("planonly", new)
        more = copy.deepcopy(job)
        more["task_groups"][0]["count"] = 5
        grown = api.jobs.plan("httpd", more)
        return {"fresh": fresh["annotations"],
                "fresh_diff": fresh["diff"],
                "grown": grown["annotations"],
                "grown_diff": grown["diff"],
                "errors": [fresh["error"], grown["error"]],
                "stored": ag.server.store.job_by_id(
                    "default", "planonly") is not None,
                "index_moved": ag.server.store.latest_index() != before,
                "allocs_moved": len(ag.server.store.allocs()) != n_allocs}


def case_unknown_routes_and_errors(P):
    with Agent(P) as ag:
        api = ag.api
        return [error_of(P, lambda: api.get("/v1/nope")),
                error_of(P, lambda: api.jobs.info("no-such-job")),
                error_of(P, lambda: api.post("/v1/jobs", {"not_job": 1})),
                error_of(P, lambda: api.request("DELETE", "/v1/jobs"))]


def case_metrics_and_agent_self(P):
    with Agent(P) as ag:
        ag.register_httpd()
        self_ = ag.api.agent.self_()
        m = ag.api.agent.metrics()
        url = ag.http.address + "/v1/metrics?format=prometheus"
        with urllib.request.urlopen(url, timeout=10) as r:
            ctype = r.headers["Content-Type"]
            text = r.read().decode()
        return {"workers": self_["server"]["workers"],
                "client": self_["client"],
                "dequeue": m["counters"].get("worker.dequeue_eval", 0) > 0,
                "invoke": m["samples"][
                    "worker.invoke_scheduler_service"]["count"] > 0,
                "submit": m["samples"]["worker.submit_plan"]["p50"] >= 0,
                "evaluate": m["samples"]["plan.evaluate"]["count"] > 0,
                "prom_type": ctype.split(";")[0],
                "prom_counter": "# TYPE worker_dequeue_eval counter"
                                in text.splitlines()}


def case_ui_served(P):
    with Agent(P, num_workers=0, nodes=0) as ag:
        out = []
        for path in ("/ui", "/"):
            with urllib.request.urlopen(ag.http.address + path,
                                        timeout=5) as r:
                page = r.read().decode()
                out.append((r.status, "text/html" in
                            r.headers["Content-Type"]))
            out.append(all(s in page for s in (
                "nomad-tpu", "/v1/jobs", "viewJob", "viewNode", "viewAlloc",
                "/v1/client/fs/logs/", "a.ClientStatus")))
        return out


OUTCOMES = Outcomes({
    "parse_register_and_status": case_parse_register_and_status,
    "blocking_query_fires_on_change": case_blocking_query_fires_on_change,
    "alloc_and_node_endpoints": case_alloc_and_node_endpoints,
    "node_eligibility_and_drain": case_node_eligibility_and_drain,
    "job_plan_dry_run_does_not_mutate":
        case_job_plan_dry_run_does_not_mutate,
    "unknown_routes_and_errors": case_unknown_routes_and_errors,
    "metrics_and_agent_self": case_metrics_and_agent_self,
    "ui_served": case_ui_served,
})


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_parse_register_and_status_via_http(pkg):
    out = OUTCOMES.check("parse_register_and_status", pkg)
    assert out["id"] == "httpd" and out["count"] == 2
    assert out["eval_id"] and out["job_status"] and out["index"]
    assert out["evals"] == ["httpd"] and out["eval_status"] == "complete"
    assert out["allocs"] == ["running", "running"]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_blocking_query_fires_on_change(pkg):
    out = OUTCOMES.check("blocking_query_fires_on_change", pkg)
    assert out == {"blocked": True, "moved": True, "woke_on_write": True}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_alloc_and_node_endpoints(pkg):
    out = OUTCOMES.check("alloc_and_node_endpoints", pkg)
    assert out["httpd_allocs"] == 2 and out["alloc_id"]
    assert out["task_states"] and out["nodes"] == 1 and out["node"]
    assert out["node_allocs"] == 2


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_node_eligibility_and_drain_via_http(pkg):
    out = OUTCOMES.check("node_eligibility_and_drain", pkg)
    assert out == ["ineligible", "eligible", ["node_modify_index"],
                   "ineligible"]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_plan_dry_run_does_not_mutate(pkg):
    out = OUTCOMES.check("job_plan_dry_run_does_not_mutate", pkg)
    assert out["fresh"]["desired_tg_updates"]["web"]["place"] == 2
    assert out["grown"]["desired_tg_updates"]["web"]["place"] == 3
    assert sum(out["grown"]["desired_tg_updates"]["web"].values()) == 5
    assert out["fresh_diff"]["Type"] == "Added"
    assert out["grown_diff"]["Type"] == "Edited"
    assert out["errors"] == ["", ""]
    assert not (out["stored"] or out["index_moved"] or out["allocs_moved"])


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_unknown_routes_and_errors(pkg):
    nope, missing, bad, method = OUTCOMES.check(
        "unknown_routes_and_errors", pkg)
    assert nope == (404, "no handler for /v1/nope")
    assert missing[0] == 404 and bad[0] == 400 and method[0] == 405


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_metrics_and_agent_self(pkg):
    out = OUTCOMES.check("metrics_and_agent_self", pkg)
    assert out["workers"] == 2 and out["client"] is None
    assert out["dequeue"] and out["invoke"] and out["submit"]
    assert out["evaluate"] and out["prom_counter"]
    assert out["prom_type"] == "text/plain"


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_ui_served(pkg):
    assert OUTCOMES.check("ui_served", pkg) == [(200, True), True,
                                                (200, True), True]


#: the reference's agent-client routes that wait for the `exec` driver
#: and CSI (ROADMAP.md Queue 1 item 16b)
CLIENT_ROUTES = [("POST", "/v1/client/allocation/abcd1234/exec"),
                 ("POST", "/v1/client/csi/plugin/ebs")]
#: the agent-client routes the port serves
PORTED_CLIENT_ROUTES = [("GET", "/v1/client/fs/logs/abcd1234"),
                        ("GET", "/v1/client/fs/ls/abcd1234"),
                        ("GET", "/v1/client/stats"),
                        ("GET", "/v1/client/allocation/abcd1234/stats")]


def route_table(P, acl_enabled=False):
    """(HTTP agent, its server) of package P, not listening: the
    dispatch alone answers."""
    srv = P.Server(num_workers=0)
    http = P.http_server.HTTPAgentServer(srv, None,
                                         acl_enabled=acl_enabled)
    http._httpd.server_close()
    return http, srv


def has_handler(P, method, path):
    http, srv = route_table(P)
    try:
        return any(p.match(path) and method in methods
                   for p, methods in http._routes)
    finally:
        srv.stop()


@pytest.mark.parametrize("method,path", CLIENT_ROUTES)
def test_client_routes_wait_for_the_agent_client(method, path):
    """On the port each of these agent-client routes is an unknown route
    (404 from the dispatch, before any ACL check); the reference has a
    handler for it."""
    port, ref = api_pkg("port"), api_pkg("ref")
    http, srv = route_table(port, acl_enabled=True)
    try:
        with pytest.raises(port.http_server.HTTPError) as e:
            http.dispatch(method, path, {"cmd": ["true"]}, "")
        assert (e.value.code, e.value.msg) == (
            404, f"no handler for {path}")
    finally:
        srv.stop()
    assert has_handler(ref, method, path)


def dispatch_answer(P, method, path, acl_enabled):
    """(code, message) of the dispatch of one request on an agent with no
    node agent and an empty store."""
    http, srv = route_table(P, acl_enabled=acl_enabled)
    try:
        http.dispatch(method, path, None, "")
    except P.http_server.HTTPError as e:
        return e.code, e.msg
    finally:
        srv.stop()
    return 200, ""


@pytest.mark.parametrize("method,path", PORTED_CLIENT_ROUTES)
def test_ported_client_routes_answer_as_the_reference(method, path):
    """Each agent-client route the port serves has a handler on both
    packages, and both answer the same on an unknown alloc (or, for the
    host stats, on an agent with no node agent), with ACLs off and on."""
    port, ref = api_pkg("port"), api_pkg("ref")
    assert has_handler(port, method, path) and has_handler(ref, method,
                                                           path)
    for acl in (False, True):
        got = dispatch_answer(port, method, path, acl)
        assert got == dispatch_answer(ref, method, path, acl)
        assert got[0] == (403 if acl else
                          400 if path == "/v1/client/stats" else 404)


def test_client_exposes_no_environment_knobs(monkeypatch):
    """The port's ApiClient takes its address and token as arguments
    only: the reference's NOMAD_ADDR / NOMAD_TOKEN do not change it."""
    monkeypatch.setenv("NOMAD_ADDR", "http://10.9.9.9:1")
    monkeypatch.setenv("NOMAD_TOKEN", "from-env")
    c = api_pkg("port").client.ApiClient()
    assert c.address == "http://127.0.0.1:4646" and c.token == ""
    assert api_pkg("ref").client.ApiClient().token == "from-env"
