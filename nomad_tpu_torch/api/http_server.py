"""HTTP /v1 API (reference: command/agent/http.go:251-370 route table +
the command/agent/*_endpoint.go adapters).

Serves the server's verbs and the store's blocking queries over JSON.
Wire format is the codec's snake_case encoding of the domain structs
(this framework's own API; the shape parity with the reference is
per-route, not per-field). Blocking queries take ?index=N&wait=5s and
answer with the X-Nomad-Index header, exactly like the reference.

The counterpart of `nomad_tpu.api.http_server`, over the port's
`Server`.  The what-if plan (`/v1/job/:id/plan`) solves through the
first worker's `Solver.plan_view()`, on the server's device and its
kernels; the solver profile (`/v1/agent/pprof/profile?mode=solver`)
records with `torch.profiler` and exports a Chrome trace.  With a node
agent (`client=`) the agent client's routes answer (`/v1/client/fs/*`,
`/v1/client/stats`, `/v1/client/allocation/*/stats`), each forwarded to
the alloc's or node's owning agent by its advertised
`unique.advertise.http`: among them alloc exec, one-shot
(`POST /v1/client/allocation/*/exec`) and interactive over a websocket
(the same path upgraded, tunnelled to the owner), and CSI plugin
registration (`/v1/client/csi/plugin/*`).
"""
from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, unquote, urlparse

from ..jobspec import JobspecParseError, parse_duration_s, parse_job
from ..server.server import JobValidationError
from ..structs import Evaluation, Job, Plan, PlanResult
from ..utils.codec import from_wire, to_wire
from ..utils.metrics import global_metrics

import logging

_log = logging.getLogger(__name__)

MAX_BLOCK_S = 300.0     # reference: nomad/rpc.go:35 maxQueryTime
#: the Chrome trace the solver profile writes into its artifact directory
SOLVER_TRACE = "solver_trace.json"


class HTTPError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


class _DryRunPlanner:
    """Planner that records instead of committing (the Job.Plan path —
    reference: nomad/job_endpoint.go Job.Plan runs the scheduler against
    a snapshot with a no-op raft)."""

    def __init__(self, store):
        self.store = store
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []

    def submit_plan(self, plan: Plan):
        self.plans.append(plan)
        return PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=self.store.latest_index()), None

    def update_eval(self, ev): self.evals.append(ev)

    def create_eval(self, ev): self.evals.append(ev)

    def reblock_eval(self, ev): self.evals.append(ev)


class HTTPAgentServer:
    """The agent's HTTP listener. `server` is the in-proc control plane;
    `client` (optional) the local node agent for agent-local routes."""

    def __init__(self, server, client=None, host: str = "127.0.0.1",
                 port: int = 0, acl_enabled: bool = False, tls=None):
        """`tls`: utils.tlsutil.TLSConfig — serve /v1 over mutual TLS;
        a client without a CA-signed cert is rejected at handshake
        (reference: command/agent/http.go wraps the listener via
        tlsutil.NewTLSConfiguration when tls.http is set)."""
        self.server = server
        self.client = client
        self.acl_enabled = acl_enabled
        self.tls = tls
        # every agent exposes /v1/agent/monitor: capture the package's
        # logs from the moment the HTTP surface exists
        from ..utils.monitor import global_monitor
        global_monitor.install()
        self._routes = _build_routes(self)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                import ssl as _ssl
                # self.request is the raw accepted socket (setup() has
                # not assigned self.connection yet)
                if isinstance(self.request, _ssl.SSLSocket):
                    self.request.settimeout(10.0)
                    self.request.do_handshake()
                    self.request.settimeout(None)
                super().setup()

            def log_message(self, *args):   # quiet
                pass

            def _handle(self, method: str):
                upgrade = (self.headers.get("Upgrade") or "").lower()
                if (method == "GET" and upgrade == "websocket"
                        and "/exec" in self.path
                        and self.path.startswith("/v1/client/allocation/")):
                    outer.handle_exec_ws(self)
                    self.close_connection = True
                    return
                if (method == "GET"
                        and self.path.split("?")[0]
                        == "/v1/agent/monitor"):
                    outer.handle_monitor(self)
                    self.close_connection = True
                    return
                if (method == "GET"
                        and self.path.split("?")[0] == "/v1/metrics"
                        and "format=prometheus" in (self.path.split("?")
                                                    + [""])[1]):
                    # text exposition needs its own content type; the
                    # JSON dispatch below would re-encode it
                    outer.handle_prometheus(self)
                    return
                if method == "GET" and (self.path == "/ui"
                                        or self.path.startswith("/ui/")
                                        or self.path == "/"):
                    from .ui import UI_HTML
                    data = UI_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                try:
                    token = self.headers.get("X-Nomad-Token", "")
                    code, body, index = outer.dispatch(
                        method, self.path, self._read_body(), token)
                except HTTPError as e:
                    code, body, index = e.code, {"error": e.msg}, None
                except Exception as e:
                    import traceback
                    traceback.print_exc()
                    code, body, index = 500, {"error": str(e)}, None
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if index is not None:
                    self.send_header("X-Nomad-Index", str(index))
                self.end_headers()
                self.wfile.write(data)

            def _read_body(self):
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return None
                raw = self.rfile.read(length)
                if not raw:
                    return None
                try:
                    return json.loads(raw)
                except json.JSONDecodeError as e:
                    raise HTTPError(400, f"invalid JSON body: {e}")

            def do_GET(self): self._handle("GET")

            def do_POST(self): self._handle("POST")

            def do_PUT(self): self._handle("PUT")

            def do_DELETE(self): self._handle("DELETE")

        self._tl = threading.local()     # per-request token (for proxying)
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        if tls is not None and tls.enabled():
            from ..utils.tlsutil import server_context
            # do_handshake_on_connect=False: the handshake runs in the
            # per-connection handler thread (with a deadline, below) —
            # on-connect it would run inside accept() on the single
            # serve_forever thread, letting one stalled client hang the
            # whole API (the RPC server takes the same care)
            self._httpd.socket = server_context(tls).wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if (self.tls is not None
                             and self.tls.enabled()) else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        # advertise this agent's HTTP address on its node so any server
        # can route client endpoints (logs/exec/fs/stats) to the owning
        # agent (reference: servers reach clients over persistent
        # nodeConns, nomad/server.go:151-153 + nomad/client_rpc.go; the
        # TPU build routes over the agent HTTP surface instead — unique.
        # prefix keeps it out of the computed class)
        if self.client is not None:
            host, port = self._httpd.server_address[:2]
            if host in ("0.0.0.0", "::", ""):
                # wildcard bind: advertise the node's fingerprinted
                # address so cross-host routing reaches THIS machine
                nets = self.client.node.node_resources.networks
                host = (nets[0].ip if nets and nets[0].ip
                        else "127.0.0.1")
            self.client.node.attributes["unique.advertise.http"] = \
                f"{host}:{port}"
            try:
                self.client.servers.register_node(self.client.node)
            except Exception:
                _log.warning("could not re-register node with advertise "
                             "address", exc_info=True)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)

    # ----------------------------------------------------------- dispatch
    def dispatch(self, method: str, path: str, body, token: str = ""):
        url = urlparse(path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        for pattern, methods in self._routes:
            m = pattern.match(url.path)
            if not m:
                continue
            fn = methods.get(method)
            if fn is None:
                raise HTTPError(405, f"method {method} not allowed")
            # Path params arrive percent-encoded; decode AFTER matching
            # so an encoded '/' (dispatched child ids embed one:
            # <parent>/dispatch-<...>) routes as one segment but reaches
            # the handler as the real id (reference: the agent mux
            # handles these ids the same way).  The ACL check receives
            # each segment decoded the same way so it authorizes the
            # exact id the handler will act on.
            segs = [unquote(s) for s in url.path.split("/")]
            self._enforce_acl(method, url.path, q, body, token, segs)
            self._tl.token = token
            return fn(q, body, *(unquote(g) for g in m.groups()))
        raise HTTPError(404, f"no handler for {url.path}")

    def _valid_migrate_token(self, alloc_prefix: str, token: str) -> bool:
        """Does `token` authorize disk-migration reads of this alloc?
        HMAC under the OWNING node's secret (structs.funcs
        generate_migrate_token)."""
        if not token:
            return False
        from ..structs.funcs import compare_migrate_token
        alloc = self.server.store.alloc_by_id(alloc_prefix)
        if alloc is None:
            return False
        node = self.server.store.node_by_id(alloc.node_id)
        if node is None or not node.secret_id:
            # never verify under a missing/empty secret — an empty HMAC
            # key would make the token forgeable from the alloc id
            return False
        return compare_migrate_token(alloc.id, node.secret_id, token)

    def _alloc_namespace(self, prefix: str) -> str:
        """Namespace of the alloc a client endpoint will act on; an
        AMBIGUOUS prefix is rejected here so the capability check can
        never authorize against a different alloc than the handler
        resolves (both layers demand uniqueness)."""
        exact = self.server.store.alloc_by_id(prefix)
        if exact is not None:
            return exact.namespace
        matches = {al.namespace for al in self.server.store.allocs()
                   if al.id.startswith(prefix)}
        if len(matches) > 1:
            raise HTTPError(400, f"ambiguous alloc prefix {prefix!r}")
        return next(iter(matches), "default")

    def _enforce_acl(self, method: str, path: str, q, body,
                     token: str, segs=None) -> None:
        """Route-class capability checks (reference: each agent endpoint
        resolves the token and asserts one capability — e.g.
        job_endpoint.go requires submit-job to register, read-job to
        get). Disabled servers skip enforcement entirely."""
        if not self.acl_enabled or path == "/v1/acl/bootstrap":
            return
        if segs is None:
            segs = path.split("/")
        # a migrate token is not an ACL token: it authorizes exactly
        # one alloc's fs reads for disk migration (reference:
        # fs_endpoint.go CompareMigrateToken) and is checked before
        # token resolution
        if (path.startswith("/v1/client/fs/")
                and self._valid_migrate_token(segs[-1], token)):
            return
        from ..acl import acl as aclmod
        a = self.server.resolve_token(token) if token else None
        if a is None:
            raise HTTPError(403, "token required" if not token
                            else "invalid token")
        # the namespace the request ACTUALLY operates on must match
        # what the handler will use: job handlers take the submitted
        # job's body namespace (otherwise ?namespace=dev would launder a
        # prod-namespace body past the check); every other handler reads
        # the query parameter, so the check does too
        ns = q.get("namespace", "default")
        if path.startswith(("/v1/jobs", "/v1/job/")) \
                and isinstance(body, dict):
            job_body = body.get("job") if isinstance(body.get("job"),
                                                     dict) else None
            if job_body and job_body.get("namespace"):
                ns = job_body["namespace"]
        if path.startswith("/v1/acl"):
            # token/policy management is management-only (reference:
            # acl_endpoint.go IsManagement checks) — operator scope
            # must NOT mint tokens or read secrets
            if not a.management:
                raise HTTPError(403, "management token required")
            return
        write = (method in ("POST", "PUT", "DELETE")
                 and path != "/v1/search")
        if "/exec" in path and path.startswith("/v1/client/allocation/"):
            target_ns = self._alloc_namespace(segs[4])
            if not a.allow_namespace_op(target_ns,
                                        aclmod.CAP_ALLOC_EXEC):
                raise HTTPError(403, "missing capability alloc-exec")
            return
        if path.startswith("/v1/client/fs/logs/"):
            # task logs often carry secrets: require read-logs in the
            # ALLOC's namespace (resolved server-side, not caller-said)
            target_ns = self._alloc_namespace(segs[-1])
            if not a.allow_namespace_op(target_ns,
                                        aclmod.CAP_READ_LOGS):
                raise HTTPError(403, "missing capability read-logs")
            return
        if path.startswith("/v1/client/fs/"):
            # ls/stat/cat/readat/stream over the alloc dir: read-fs in
            # the alloc's namespace (reference: fs_endpoint.go ACL), OR
            # a migrate token scoped to exactly this alloc — the
            # replacement alloc's disk-migration read authority
            # (reference: fs_endpoint.go checks CompareMigrateToken)
            target_ns = self._alloc_namespace(segs[-1])
            if not a.allow_namespace_op(target_ns, aclmod.CAP_READ_FS):
                raise HTTPError(403, "missing capability read-fs")
            return
        if (path == "/v1/client/stats"
                or path.endswith("/stats")
                and path.startswith("/v1/client/allocation/")):
            # host stats = node:read; alloc stats = read-job in ns
            if path == "/v1/client/stats":
                if not a.allow_node_read():
                    raise HTTPError(403, "node permission denied")
            else:
                target_ns = self._alloc_namespace(segs[4])
                if not a.allow_namespace_op(target_ns,
                                            aclmod.CAP_READ_JOB):
                    raise HTTPError(403, "missing capability read-job")
            return
        if path.startswith("/v1/secret"):
            # secrets are write-class EVEN TO READ: a read-only job
            # token must not exfiltrate raw secret values
            if not a.allow_namespace_op(ns, aclmod.CAP_SUBMIT_JOB):
                raise HTTPError(403, "secrets require namespace write")
            return
        if path.startswith("/v1/job/") and path.endswith("/dispatch"):
            # dispatching is its own capability (reference:
            # job_endpoint.go Dispatch requires dispatch-job)
            if not a.allow_namespace_op(ns, aclmod.CAP_DISPATCH_JOB):
                raise HTTPError(403, "missing capability dispatch-job")
            return
        if path.startswith(("/v1/jobs", "/v1/job/", "/v1/allocation",
                            "/v1/evaluation", "/v1/deployment",
                            "/v1/search", "/v1/volume", "/v1/service")):
            cap = (aclmod.CAP_SUBMIT_JOB if write
                   else aclmod.CAP_READ_JOB)
            if not a.allow_namespace_op(ns, cap):
                raise HTTPError(403, f"missing capability {cap}")
            return
        if path.startswith("/v1/node"):
            ok = a.allow_node_write() if write else a.allow_node_read()
            if not ok:
                raise HTTPError(403, "node permission denied")
            return
        if path.startswith("/v1/agent/pprof"):
            # runtime profiles expose internals: agent WRITE, like the
            # reference's ACL-gated pprof (pprof.go:58 AgentWrite)
            if not a.allow_agent_write():
                raise HTTPError(403, "agent write permission required")
            return
        if path.startswith("/v1/agent") or path == "/v1/metrics" \
                or path.startswith(("/v1/trace", "/v1/traces",
                                    "/v1/telemetry")):
            # traces expose job/placement internals cluster-wide, the
            # same blast radius as /v1/metrics + /v1/agent/monitor:
            # agent read to look, agent write to export to disk
            ok = a.allow_agent_write() if write else a.allow_agent_read()
            if not ok:
                raise HTTPError(403, "agent permission denied")
            return
        if path.startswith(("/v1/operator", "/v1/system")):
            ok = (a.allow_operator_write() if write
                  else a.allow_operator_read())
            if not ok:
                raise HTTPError(403, "operator permission denied")
            return

    # ------------------------------------------------------- blocking wait
    def _block(self, q: Dict[str, str], table: str) -> int:
        """Run the blocking-query wait; returns the index to report."""
        store = self.server.store
        try:
            min_index = int(q.get("index", 0) or 0)
            wait_s = min(parse_duration_s(q.get("wait", "5m")),
                         MAX_BLOCK_S)
        except (ValueError, JobspecParseError) as e:
            raise HTTPError(400, f"invalid blocking-query params: {e}")
        if min_index <= 0:
            return store.latest_index()
        import time as _t
        deadline = _t.monotonic() + wait_s
        while True:
            # capture the head BEFORE the table check so a write landing
            # between the reads wakes the wait immediately (same pattern
            # as Server.get_client_allocs)
            head = store.latest_index()
            if store.table_index(table) > min_index:
                break
            remain = deadline - _t.monotonic()
            if remain <= 0:
                break
            store.wait_for_change(head, remain)
        return max(store.table_index(table), min_index)

    # -------------------------------------------------------------- jobs
    def jobs_list(self, q, body):
        index = self._block(q, "jobs")
        prefix = q.get("prefix", "")
        jobs = [j for j in self.server.store.jobs()
                if j.id.startswith(prefix)]
        out = []
        for j in sorted(jobs, key=lambda j: j.id):
            summary = self.server.store.job_summary(j.namespace, j.id)
            out.append({
                "id": j.id, "name": j.name, "namespace": j.namespace,
                "type": j.type, "priority": j.priority, "status": j.status,
                "stop": j.stop, "version": j.version,
                "create_index": j.create_index,
                "modify_index": j.modify_index,
                "summary": to_wire(summary) if summary else None})
        return 200, out, index

    def jobs_register(self, q, body):
        if not body or "job" not in body:
            raise HTTPError(400, "body must carry a 'job' object")
        job = from_wire(Job, body["job"])
        errs = job.validate()
        if errs:
            raise HTTPError(400, "; ".join(errs))
        try:
            ev = self.server.register_job(
                job, enforce_index=bool(body.get("enforce_index")),
                check_index=int(body.get("job_modify_index", 0)))
        except JobValidationError as e:
            raise HTTPError(400, str(e))
        except ValueError as e:
            raise HTTPError(409, str(e))
        return 200, {"eval_id": ev.id if ev else "",
                     "job_modify_index": job.modify_index}, None

    def jobs_parse(self, q, body):
        if not body or "job_hcl" not in body:
            raise HTTPError(400, "body must carry 'job_hcl'")
        try:
            job = parse_job(body["job_hcl"])
        except JobspecParseError as e:
            raise HTTPError(400, str(e))
        return 200, to_wire(job), None

    def _get_job(self, job_id: str) -> Job:
        job = self.server.store.job_by_id("default", job_id)
        if job is None:
            raise HTTPError(404, f"job {job_id!r} not found")
        return job

    def job_get(self, q, body, job_id):
        index = self._block(q, "jobs")
        return 200, to_wire(self._get_job(job_id)), index

    def job_update(self, q, body, job_id):
        return self.jobs_register(q, body)

    def job_delete(self, q, body, job_id):
        purge = q.get("purge", "").lower() == "true"
        ev = self.server.deregister_job("default", job_id, purge=purge)
        return 200, {"eval_id": ev.id if ev else ""}, None

    def job_allocations(self, q, body, job_id):
        index = self._block(q, "allocs")
        allocs = self.server.store.allocs_by_job("default", job_id)
        return 200, [a.stub() for a in allocs], index

    def job_evaluations(self, q, body, job_id):
        index = self._block(q, "evals")
        evals = self.server.store.evals_by_job("default", job_id)
        return 200, [to_wire(e) for e in evals], index

    def job_deployments(self, q, body, job_id):
        index = self._block(q, "deployments")
        deps = self.server.store.deployments_by_job("default", job_id)
        return 200, [to_wire(d) for d in deps], index

    def job_summary(self, q, body, job_id):
        index = self._block(q, "jobs")
        s = self.server.store.job_summary("default", job_id)
        if s is None:
            raise HTTPError(404, f"no summary for {job_id!r}")
        return 200, to_wire(s), index

    def job_versions(self, q, body, job_id):
        versions = self.server.store.job_versions("default", job_id)
        return 200, [to_wire(j) for j in versions], None

    def job_periodic_force(self, q, body, job_id):
        child = self.server.periodic.force_launch("default", job_id)
        if child is None:
            raise HTTPError(404,
                            f"{job_id!r} is not a tracked periodic job")
        return 200, {"child_job_id": child.id}, None

    def job_plan(self, q, body, job_id):
        """Dry-run the scheduler (reference: Job.Plan)."""
        if not body or "job" not in body:
            raise HTTPError(400, "body must carry a 'job' object")
        from ..scheduler.base import new_scheduler
        from ..structs import EVAL_STATUS_PENDING, EVAL_TRIGGER_JOB_REGISTER
        job = from_wire(Job, body["job"])
        job.canonicalize()
        planner = _DryRunPlanner(self.server.store)
        ev = Evaluation(namespace=job.namespace, job_id=job.id,
                        type=job.type, priority=job.priority,
                        triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                        status=EVAL_STATUS_PENDING, annotate_plan=True)
        # plan against a snapshot with the SUBMITTED job overlaid, so the
        # dry-run sees the proposed version without writing state
        snap = self.server.store.snapshot()
        snap_index = snap.index
        current = snap.job_by_id(job.namespace, job.id)
        job.version = (current.version + 1) if current else 0
        snap._t["jobs"] = dict(snap._t["jobs"])
        snap._t["jobs"][(job.namespace, job.id)] = job
        # what-if overlay solve: ride the first worker's
        # resident solver through its read-only plan view — the dry run
        # answers from the delta-maintained template at steady-state
        # speed, against a copy-on-read usage overlay, and never
        # touches the carried world state
        sched = new_scheduler(job.type, snap, planner,
                              solver=self._plan_solver())
        planner_err = sched.process(ev)
        ann = None
        if planner.plans and planner.plans[-1].annotations is not None:
            ann = to_wire(planner.plans[-1].annotations)
        diff = None
        if body.get("diff", True):
            from ..structs.diff import job_diff
            diff = job_diff(current, job)
        return 200, {
            "annotations": ann,
            "diff": diff,
            "created_evals": [to_wire(e) for e in planner.evals],
            "diff_seen_index": snap_index,
            "error": str(planner_err) if planner_err else "",
        }, None

    # ------------------------------------------------------------- evals
    def evals_list(self, q, body):
        index = self._block(q, "evals")
        evals = sorted(self.server.store.evals(), key=lambda e: e.id)
        return 200, [to_wire(e) for e in evals], index

    def eval_get(self, q, body, eval_id):
        index = self._block(q, "evals")    # wait BEFORE reading
        ev = self.server.store.eval_by_id(eval_id)
        if ev is None:
            raise HTTPError(404, f"eval {eval_id!r} not found")
        return 200, to_wire(ev), index

    def eval_allocations(self, q, body, eval_id):
        allocs = self.server.store.allocs_by_eval(eval_id)
        return 200, [a.stub() for a in allocs], None

    # ------------------------------------------------------------ allocs
    def allocs_list(self, q, body):
        index = self._block(q, "allocs")
        prefix = q.get("prefix", "")
        allocs = [a for a in self.server.store.allocs()
                  if a.id.startswith(prefix)]
        return 200, [a.stub() for a in sorted(allocs, key=lambda a: a.id)], \
            index

    def alloc_get(self, q, body, alloc_id):
        index = self._block(q, "allocs")
        a = self.server.store.alloc_by_id(alloc_id)
        if a is None:
            raise HTTPError(404, f"alloc {alloc_id!r} not found")
        return 200, to_wire(a), index

    def alloc_stop(self, q, body, alloc_id):
        ev = self.server.stop_alloc(alloc_id)
        if ev is None:
            raise HTTPError(404, f"alloc {alloc_id!r} not found")
        return 200, {"eval_id": ev.id}, None

    # ------------------------------------------------------------- nodes
    def nodes_list(self, q, body):
        index = self._block(q, "nodes")
        prefix = q.get("prefix", "")
        nodes = [n for n in self.server.store.nodes()
                 if n.id.startswith(prefix)]
        out = [{"id": n.id, "name": n.name, "datacenter": n.datacenter,
                "node_class": n.node_class, "status": n.status,
                "scheduling_eligibility": n.scheduling_eligibility,
                "drain": n.drain_strategy is not None,
                "modify_index": n.modify_index}
               for n in sorted(nodes, key=lambda n: n.id)]
        return 200, out, index

    def _resolve_node(self, node_id: str) -> str:
        node = self.server.store.node_by_id(node_id)
        if node is not None:
            return node.id
        matches = [n.id for n in self.server.store.nodes()
                   if n.id.startswith(node_id)]
        if len(matches) == 1:
            return matches[0]
        raise HTTPError(404, f"node {node_id!r} not found")

    def node_get(self, q, body, node_id):
        index = self._block(q, "nodes")
        node = self.server.store.node_by_id(self._resolve_node(node_id))
        return 200, to_wire(node), index

    def node_allocations(self, q, body, node_id):
        index = self._block(q, "allocs")
        allocs = self.server.store.allocs_by_node(
            self._resolve_node(node_id))
        return 200, [a.stub() for a in allocs], index

    def node_drain(self, q, body, node_id):
        from ..structs import DrainStrategy
        node_id = self._resolve_node(node_id)
        spec = (body or {}).get("drain_spec")
        strategy = None
        if spec is not None:
            strategy = DrainStrategy(
                deadline_s=float(spec.get("deadline_s", 3600.0)),
                ignore_system_jobs=bool(spec.get("ignore_system_jobs",
                                                 False)))
        index = self.server.update_node_drain(
            node_id, strategy,
            mark_eligible=bool((body or {}).get("mark_eligible", False)))
        return 200, {"node_modify_index": index}, None

    def node_eligibility(self, q, body, node_id):
        node_id = self._resolve_node(node_id)
        elig = (body or {}).get("eligibility", "")
        if elig not in ("eligible", "ineligible"):
            raise HTTPError(400, "eligibility must be eligible|ineligible")
        index = self.server.update_node_eligibility(node_id, elig)
        return 200, {"node_modify_index": index}, None

    def node_evaluate(self, q, body, node_id):
        node = self.server.store.node_by_id(self._resolve_node(node_id))
        self.server._create_node_evals(node, self.server.store.latest_index())
        return 200, {}, None

    # -------------------------------------------------------- deployments
    def deployments_list(self, q, body):
        index = self._block(q, "deployments")
        deps = sorted(self.server.store.deployments(), key=lambda d: d.id)
        return 200, [to_wire(d) for d in deps], index

    def _resolve_deployment(self, dep_id: str):
        d = self.server.store.deployment_by_id(dep_id)
        if d is not None:
            return d
        matches = [d for d in self.server.store.deployments()
                   if d.id.startswith(dep_id)]
        if len(matches) == 1:
            return matches[0]
        raise HTTPError(404, f"deployment {dep_id!r} not found")

    def deployment_get(self, q, body, dep_id):
        index = self._block(q, "deployments")
        return 200, to_wire(self._resolve_deployment(dep_id)), index

    def deployment_promote(self, q, body, dep_id):
        dep = self._resolve_deployment(dep_id)
        try:
            ev = self.server.promote_deployment(dep.id, all_groups=True)
        except ValueError as e:
            raise HTTPError(409, str(e))
        return 200, {"eval_id": ev.id if ev else ""}, None

    def deployment_fail(self, q, body, dep_id):
        dep = self._resolve_deployment(dep_id)
        ev = self.server.fail_deployment(dep.id)
        return 200, {"eval_id": ev.id if ev else ""}, None

    def deployment_allocations(self, q, body, dep_id):
        dep = self._resolve_deployment(dep_id)
        allocs = self.server.store.allocs_by_deployment(dep.id)
        return 200, [a.stub() for a in allocs], None

    # ------------------------------------------------------ agent / misc
    def agent_self(self, q, body):
        out = {"server": {"enabled": True,
                          "workers": len(self.server.workers)},
               "client": None, "version": "0.1.0"}
        if self.client is not None:
            out["client"] = {"enabled": True,
                            "node_id": self.client.node.id,
                            "allocs": self.client.num_allocs()}
        return 200, out, None

    def agent_members(self, q, body):
        """Server membership (reference: /v1/agent/members from serf).
        With gossip attached the real member list is served; a
        standalone dev server reports itself."""
        gossip = getattr(self.server, "gossip", None)
        if gossip is not None:
            leader_id = self.server.raft.leader_id
            return 200, {"members": [
                {"name": m.id, "addr": list(m.addr),
                 "region": m.region, "status": m.status,
                 "leader": m.id == leader_id}
                for m in gossip.members()]}, None
        return 200, {"members": [{
            "name": self.server.raft.id, "status": "alive",
            "leader": self.server.is_leader()}]}, None

    def regions_list(self, q, body):
        """Known federation regions, sorted (reference:
        nomad/regions_endpoint.go Regions.List from the WAN serf pool;
        a standalone server reports its own region)."""
        gossip = getattr(self.server, "gossip", None)
        if gossip is not None:
            try:
                return 200, sorted(set(gossip.regions())), None
            except Exception:
                pass
        region = getattr(self.server, "region", "") or "global"
        return 200, [region], None

    def status_leader(self, q, body):
        return 200, "127.0.0.1:4647", None

    def status_peers(self, q, body):
        return 200, ["127.0.0.1:4647"], None

    def metrics(self, q, body):
        return 200, global_metrics.dump(), None

    def handle_prometheus(self, handler) -> None:
        """/v1/metrics?format=prometheus — text exposition 0.0.4
        (served outside the JSON dispatch for the content type)."""
        from urllib.parse import parse_qs, urlparse
        url = urlparse(handler.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        token = handler.headers.get("X-Nomad-Token", "")
        try:
            self._enforce_acl("GET", "/v1/metrics", q, None, token)
            data = global_metrics.prometheus().encode()
            code, ctype = 200, ("text/plain; version=0.0.4; "
                                "charset=utf-8")
        except HTTPError as e:
            data = json.dumps({"error": e.msg}).encode()
            code, ctype = e.code, "application/json"
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    # -------------------------------------------------- flight recorder
    def trace_get(self, q, body, trace_id):
        """/v1/trace/:id — one eval's full recorded timeline (the
        trace id IS the eval id)."""
        from ..utils.tracing import global_tracer
        spans = global_tracer.get(trace_id)
        if spans is None:
            raise HTTPError(404, f"no trace {trace_id!r}")
        return 200, {"trace_id": trace_id, "spans": spans}, None

    def traces_list(self, q, body):
        """/v1/traces — newest-first summaries plus recorder stats."""
        from ..utils.tracing import global_tracer
        try:
            limit = int(q.get("limit", 50))
        except ValueError:
            raise HTTPError(400, "limit must be an integer")
        return 200, {"stats": global_tracer.stats(),
                     "traces": global_tracer.traces(limit)}, None

    def trace_corpus(self, q, body):
        """/v1/trace/corpus — the recorded per-eval placement corpus
        (the learned scorer's training substrate).  GET returns the rows;
        POST with {"path": ...} exports them as JSONL to that path on
        the agent host and returns the row count."""
        from ..utils.tracing import global_tracer
        if body is not None and isinstance(body, dict) \
                and body.get("path"):
            try:
                n = global_tracer.write_corpus(body["path"])
            except OSError as e:
                raise HTTPError(400, f"cannot write corpus: {e}")
            return 200, {"path": body["path"], "rows": n}, None
        return 200, {"rows": global_tracer.corpus_rows()}, None

    def agent_events(self, q, body):
        """/v1/agent/events — the mesh event log (elastic grow/shrink/
        move/fail/recover transitions with measured bytes/durations).
        `?since_seq=N` pages by cursor: only events with seq > N, plus
        the log's `last_seq` so pollers resume without overlap."""
        from ..utils.tracing import global_mesh_events
        try:
            limit = int(q.get("limit", 256))
            since_seq = int(q.get("since_seq", 0))
        except ValueError:
            raise HTTPError(400, "limit/since_seq must be integers")
        return 200, {
            "events": global_mesh_events.events(
                limit, kind=q.get("kind") or None,
                since_seq=since_seq),
            "last_seq": global_mesh_events.last_seq}, None

    # ------------------------------------------------- telemetry plane
    def telemetry_health(self, q, body):
        """/v1/telemetry/health — the latest fleet health report
        (server telemetry tick) plus the serving-tier SLO status and
        the recorder/series bookkeeping."""
        from ..telemetry.series import global_series
        from ..utils.tracing import global_tracer
        serving = getattr(self.server, "serving", None)
        health_fn = getattr(self.server, "last_health", None)
        return 200, {
            "health": health_fn() if callable(health_fn) else None,
            "serving": serving.stats() if serving is not None else None,
            "tracer": global_tracer.stats(),
            "series": global_series.stats(),
        }, None

    def telemetry_series(self, q, body):
        """/v1/telemetry/series?name=&res=&since= — one named series
        from the multi-resolution ring (bucket starts > since)."""
        from ..telemetry.series import global_series
        name = q.get("name", "")
        if not name:
            return 200, {"names": global_series.names()}, None
        try:
            res = int(q.get("res", 1))
            since = float(q.get("since", 0))
        except ValueError:
            raise HTTPError(400, "res/since must be numeric")
        try:
            points = global_series.points(name, res=res, since=since)
        except KeyError:
            raise HTTPError(
                400, f"unknown resolution {res}s (configured: "
                     f"{[r for r, _ in global_series.resolutions]})")
        return 200, {"name": name, "res": res, "points": points}, None

    # ----------------------------------------------- agent monitor/pprof
    def handle_monitor(self, handler) -> None:
        """/v1/agent/monitor — live log streaming (reference:
        command/agent/monitor/monitor.go:14 + agent_endpoint.go
        AgentMonitor): replay the ring of recent lines, then follow new
        ones until the client disconnects.  ?log_level= filters;
        ?node_id= routes to that node's agent and relays its stream."""
        import queue as _q
        from urllib.parse import parse_qs, urlparse
        from ..utils.monitor import global_monitor, parse_level

        url = urlparse(handler.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        token = handler.headers.get("X-Nomad-Token", "")
        try:
            self._enforce_acl("GET", "/v1/agent/monitor", q, None, token)
        except HTTPError as e:
            data = json.dumps({"error": e.msg}).encode()
            handler.send_response(e.code)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
            return

        node_id = q.get("node_id", "")
        if node_id and not (self.client is not None
                            and self.client.node.id.startswith(node_id)):
            self._relay_monitor(handler, node_id, q, token)
            return

        min_level = parse_level(q.get("log_level", "debug"))
        # bounded follow for polling clients/tests; 0 = until disconnect
        try:
            deadline_s = float(q.get("duration_s", 0) or 0)
        except ValueError:
            deadline_s = 0.0
        sub = global_monitor.subscribe(min_level=min_level)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type",
                                "text/plain; charset=utf-8")
            handler.send_header("X-Accel-Buffering", "no")
            handler.end_headers()
            end = (time.monotonic() + deadline_s) if deadline_s else None
            while True:
                timeout = 1.0
                if end is not None:
                    timeout = min(timeout, end - time.monotonic())
                    if timeout <= 0:
                        return
                try:
                    levelno, line = sub.get(timeout=max(timeout, 0.01))
                except _q.Empty:
                    continue
                if levelno < min_level:
                    continue
                handler.wfile.write(line.encode() + b"\n")
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            return
        finally:
            global_monitor.unsubscribe(sub)

    def _peer_conn(self, addr: str, timeout: float):
        """HTTP(S) connection to a peer agent: when this cluster runs
        TLS, every agent listener is HTTPS and relays must present this
        agent's certificate too."""
        import http.client as hc
        if self.tls is not None and self.tls.enabled():
            from ..utils.tlsutil import client_context
            if getattr(self, "_relay_ctx", None) is None:
                self._relay_ctx = client_context(self.tls)
            return hc.HTTPSConnection(addr, timeout=timeout,
                                      context=self._relay_ctx)
        return hc.HTTPConnection(addr, timeout=timeout)

    def _relay_monitor(self, handler, node_id: str, q, token) -> None:
        """Stream another agent's monitor through this one (the
        server-side hop of the reference's remote monitor)."""
        import http.client as hc
        from urllib.parse import urlencode
        matches = [n for n in self.server.store.nodes()
                   if n.id.startswith(node_id)]
        if len(matches) != 1:
            code = 400 if matches else 404
            data = json.dumps({"error": f"node {node_id!r} "
                               + ("ambiguous" if matches
                                  else "not found")}).encode()
            handler.send_response(code)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
            return
        addr = matches[0].attributes.get("unique.advertise.http", "")
        if not addr:
            handler.send_response(502)
            handler.end_headers()
            return
        qs = urlencode(dict(q, _routed="1"))
        conn = self._peer_conn(addr, timeout=330.0)
        try:
            conn.request("GET", f"/v1/agent/monitor?{qs}",
                         headers={"X-Nomad-Token": token or ""})
            resp = conn.getresponse()
            handler.send_response(resp.status)
            handler.send_header("Content-Type",
                                "text/plain; charset=utf-8")
            handler.end_headers()
            while True:
                chunk = resp.read(4096)
                if not chunk:
                    return
                handler.wfile.write(chunk)
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            return
        finally:
            conn.close()

    def agent_pprof(self, q, body, profile):
        """/v1/agent/pprof/* (reference: command/agent/pprof/pprof.go:58
        — ACL-gated runtime profiles).  Profiles: `profile` (sampled
        CPU stacks, ?seconds=), `goroutine` (all-thread dump),
        `cmdline`."""
        from ..utils import monitor as monmod
        if profile == "profile":
            try:
                seconds = min(float(q.get("seconds", 1.0)), 30.0)
            except ValueError:
                raise HTTPError(400, "seconds must be a number")
            if q.get("mode") == "solver":
                return self._solver_profile(q, seconds)
            hz = 100
            text = monmod.sample_profile(seconds=seconds, hz=hz)
            return 200, {"profile": text, "seconds": seconds,
                         "hz": hz}, None
        if profile == "goroutine":
            return 200, {"stacks": monmod.thread_dump(),
                         "threads": threading.active_count()}, None
        if profile == "cmdline":
            return 200, {"cmdline": " ".join(sys.argv)}, None
        raise HTTPError(404, f"unknown profile {profile!r} "
                             "(have: profile, goroutine, cmdline)")

    def _solver_profile(self, q, seconds: float):
        """/v1/agent/pprof/profile?mode=solver — wrap a steady-state
        solve window in `torch.profiler.profile` and export a Chrome
        trace (`SOLVER_TRACE` in the answered artifact directory).  It
        records the card's kernels (`ProfilerActivity.CUDA`) whenever
        the worker solver's device is `cuda`, chosen by the device and
        never by probing what the build offers.  The trace carries the
        solver's `nomad.` ranges (`utils.tracing.device_range`) on the
        kernels' clock, each wave and each host sync of the solves that
        take the device route on the profiler's own thread: the ?job_id=
        what-if solves (torch records host ops of that thread only).
        With ?job_id= the window is driven by repeated what-if plan
        solves of that job through the worker's read-only plan view
        (zero writes);
        without, the window passively captures whatever the live
        workers solve.  500 when the profiler fails."""
        import tempfile
        import time as _t
        logdir = tempfile.mkdtemp(prefix="nomad-tpu-solver-profile-")
        job_id = q.get("job_id", "")
        namespace = q.get("namespace", "default")
        solves = 0
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._plan_solver().device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                deadline = _t.monotonic() + seconds
                if job_id:
                    solves = self._drive_plan_solves(
                        namespace, job_id, deadline)
                else:
                    _t.sleep(seconds)
            prof.export_chrome_trace(os.path.join(logdir, SOLVER_TRACE))
        except Exception as e:
            raise HTTPError(500, f"profiler trace failed: {e}")
        return 200, {"artifact": logdir, "seconds": seconds,
                     "mode": "solver", "solves": solves}, None

    def _plan_solver(self):
        """The what-if plan's solver: the first worker's plan view, or
        without workers a store-less solver on the server's device (the
        scheduler's own default would run on `cuda` whatever the
        server's device)."""
        workers = getattr(self.server, "workers", None)
        if workers:
            return workers[0].fleet_solver().plan_view()
        from ..solver.solve import Solver
        return Solver(device=getattr(self.server, "device", None))

    def _drive_plan_solves(self, namespace: str, job_id: str,
                           deadline: float) -> int:
        """Steady-state solve load for the profiler window: repeated
        dry-run (what-if overlay) solves of an existing job."""
        import time as _t
        from ..scheduler.base import new_scheduler
        from ..structs import (EVAL_STATUS_PENDING,
                               EVAL_TRIGGER_JOB_REGISTER)
        job = self.server.store.job_by_id(namespace, job_id)
        if job is None:
            raise HTTPError(404, f"unknown job {job_id!r}")
        solver = self._plan_solver()
        solves = 0
        while _t.monotonic() < deadline:
            planner = _DryRunPlanner(self.server.store)
            ev = Evaluation(namespace=namespace, job_id=job_id,
                            type=job.type, priority=job.priority,
                            triggered_by=EVAL_TRIGGER_JOB_REGISTER,
                            status=EVAL_STATUS_PENDING,
                            annotate_plan=True)
            sched = new_scheduler(job.type, self.server.store.snapshot(),
                                  planner, solver=solver)
            sched.process(ev)
            solves += 1
        return solves

    def system_gc(self, q, body):
        self.server.force_gc()
        return 200, {}, None

    def search(self, q, body, *groups):
        """Prefix search over the ID spaces (reference:
        nomad/search_endpoint.go)."""
        if not body or "prefix" not in body:
            raise HTTPError(400, "body must carry 'prefix'")
        from ..server.search import search as do_search
        try:
            matches, truncations = do_search(
                self.server.store, body["prefix"],
                body.get("context", "all") or "all",
                namespace=body.get("namespace", "default"))
        except ValueError as e:
            raise HTTPError(400, str(e))
        return 200, {"matches": matches,
                     "truncations": truncations}, \
            self.server.store.latest_index()

    def client_logs(self, q, body, alloc_id):
        """Task log contents (reference: client/fs_endpoint.go logs;
        plain read of the alloc dir's rotated log files, ?task= and
        ?type=stdout|stderr, tail via ?offset/?limit or ?tail_lines).
        Routed to the owning agent when the alloc is not local."""
        remote = self._client_route(alloc_id, q)
        if remote is not None:
            return self._proxy_client_http(
                remote, "GET", f"/v1/client/fs/logs/{alloc_id}", q, None)
        runner = self._local_runner(alloc_id)
        names = [t.name for t in
                 (runner.alloc.job.lookup_task_group(
                     runner.alloc.task_group).tasks
                  if runner.alloc.job else [])]
        task = q.get("task")
        if not task:
            if len(names) != 1:
                raise HTTPError(400, "specify ?task= (multiple tasks)")
            task = names[0]
        elif task not in names:
            # also forecloses path traversal through the task name
            raise HTTPError(404, f"unknown task {task!r}")
        kind = q.get("type", "stdout")
        if kind not in ("stdout", "stderr"):
            raise HTTPError(400, "type must be stdout|stderr")
        path = (runner.alloc_dir.stdout_path(task) if kind == "stdout"
                else runner.alloc_dir.stderr_path(task))
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            data = b""
        tail = q.get("tail_lines")
        if tail:
            try:
                n = int(tail)
                if n <= 0:
                    raise ValueError
            except ValueError:
                raise HTTPError(400, "tail_lines must be a positive int")
            data = b"\n".join(data.splitlines()[-n:])
        text = data.decode("utf-8", errors="replace")
        return 200, {"task": task, "type": kind, "data": text,
                     "size": len(data)}, None

    # ---------------------------------------------- fs + stats surface
    def _local_runner(self, alloc_id: str):
        """The local alloc runner for an id/prefix, or 404."""
        if self.client is None:
            raise HTTPError(400, "no client agent on this node")
        runner = self.client.get_alloc_runner(alloc_id)
        if runner is None:
            matches = [r for aid, r in list(self.client.runners.items())
                       if aid.startswith(alloc_id)]
            if len(matches) != 1:
                raise HTTPError(404, f"alloc {alloc_id} not on node")
            runner = matches[0]
        return runner

    def _fs_call(self, q, alloc_id: str, verb: str, fn):
        """Route-or-serve shared shell for the fs verbs (reference:
        command/agent/fs_endpoint.go dispatching to the owning client
        via server RPC)."""
        from ..client import fs as fsmod
        remote = self._client_route(alloc_id, q)
        if remote is not None:
            return self._proxy_client_http(
                remote, "GET", f"/v1/client/fs/{verb}/{alloc_id}",
                q, None)
        runner = self._local_runner(alloc_id)
        try:
            return fn(fsmod, runner)
        except fsmod.FSError as e:
            raise HTTPError(e.code, e.msg)

    def client_fs_ls(self, q, body, alloc_id):
        """Directory listing inside the alloc dir (reference:
        client/fs_endpoint.go List)."""
        return self._fs_call(q, alloc_id, "ls", lambda fsmod, r: (
            200, {"files": fsmod.list_dir(r.alloc_dir.root,
                                          q.get("path", "/"))}, None))

    def client_fs_stat(self, q, body, alloc_id):
        """Stat one path (reference: client/fs_endpoint.go Stat)."""
        return self._fs_call(q, alloc_id, "stat", lambda fsmod, r: (
            200, {"file": fsmod.stat_path(r.alloc_dir.root,
                                          q.get("path", "/"))}, None))

    def client_fs_cat(self, q, body, alloc_id):
        """Whole-file read (reference: fs_endpoint.go Cat) — base64 in
        JSON so it survives the routing proxy byte-exact.  `size` is
        the FILE's size and `truncated` is explicit so callers can
        page the remainder with readat (the SDK does)."""
        import base64

        def run(fsmod, r):
            st = fsmod.stat_path(r.alloc_dir.root, q.get("path", "/"))
            data = fsmod.read_at(r.alloc_dir.root, q.get("path", "/"),
                                 0, 1 << 24)
            return 200, {"data": base64.b64encode(data).decode(),
                         "encoding": "base64", "size": st["size"],
                         "truncated": len(data) < st["size"]}, None
        return self._fs_call(q, alloc_id, "cat", run)

    def client_fs_readat(self, q, body, alloc_id):
        """Bounded range read (reference: fs_endpoint.go ReadAt)."""
        import base64

        def run(fsmod, r):
            try:
                offset = int(q.get("offset", 0))
                limit = int(q.get("limit", 1 << 20))
            except ValueError:
                raise HTTPError(400, "offset/limit must be integers")
            data = fsmod.read_at(r.alloc_dir.root, q.get("path", "/"),
                                 offset, limit)
            return 200, {"data": base64.b64encode(data).decode(),
                         "encoding": "base64", "offset": offset,
                         "size": len(data)}, None
        return self._fs_call(q, alloc_id, "readat", run)

    def client_fs_stream(self, q, body, alloc_id):
        """Follow a growing file: long-poll returning bytes past
        ?offset (reference: fs_endpoint.go Stream's follow frames,
        JSON-framed so it routes like everything else)."""
        import base64

        def run(fsmod, r):
            try:
                offset = int(q.get("offset", 0))
                wait_s = float(q.get("wait", 2.0))
            except ValueError:
                raise HTTPError(400, "offset/wait must be numeric")
            res = fsmod.stream_from(r.alloc_dir.root,
                                    q.get("path", "/"), offset, wait_s)
            return 200, {"data": base64.b64encode(res["data"]).decode(),
                         "encoding": "base64",
                         "offset": res["offset"],
                         "size": res["size"]}, None
        return self._fs_call(q, alloc_id, "stream", run)

    def client_host_stats(self, q, body):
        """Host resource gauges (reference: /v1/client/stats,
        client/stats/host.go); ?node_id= routes to that node's agent."""
        from ..client import fs as fsmod
        node_prefix = q.get("node_id", "")
        if (node_prefix and not q.get("_routed")
                and (self.client is None
                     or not self.client.node.id.startswith(node_prefix))):
            nodes = [n for n in self.server.store.nodes()
                     if n.id.startswith(node_prefix)]
            if len(nodes) != 1:
                raise HTTPError(404 if not nodes else 400,
                                f"node {node_prefix!r} "
                                + ("not found" if not nodes
                                   else "is ambiguous"))
            addr = nodes[0].attributes.get("unique.advertise.http", "")
            if not addr:
                raise HTTPError(502, "node has no advertised agent "
                                     "address")
            return self._proxy_client_http(addr, "GET",
                                           "/v1/client/stats", q, None)
        if self.client is None:
            raise HTTPError(400, "no client agent on this node")
        return 200, fsmod.host_stats(self.client.data_dir), None

    def client_alloc_stats(self, q, body, alloc_id):
        """Per-task resource usage for one alloc (reference:
        client/allocrunner stats hooks + pid_collector)."""
        from ..client import fs as fsmod
        remote = self._client_route(alloc_id, q)
        if remote is not None:
            return self._proxy_client_http(
                remote, "GET",
                f"/v1/client/allocation/{alloc_id}/stats", q, None)
        runner = self._local_runner(alloc_id)
        tasks = {}
        for tr in runner.task_runners:
            ds = (tr.handle.driver_state if tr.handle else None) or {}
            pid = ds.get("pid")
            tasks[tr.task.name] = (fsmod.task_stats(pid) if pid
                                   else None)
        return 200, {"alloc_id": runner.alloc.id, "tasks": tasks}, None

    def handle_exec_ws(self, handler) -> None:
        """Interactive exec over a websocket (reference: the alloc-exec
        stream — api/allocations.go Exec websocket frames bridged to
        plugins/drivers/execstreaming.go ExecTaskStreaming).

        Frames: client sends {"stdin": {"data": b64}} |
        {"stdin": {"close": true}} | {"tty_size": {"width", "height"}};
        server sends {"stdout": {"data": b64}} | {"exit": {"code": N}}.
        """
        import base64
        import select
        from urllib.parse import parse_qs, urlsplit

        from .websocket import WebSocketClosed, server_handshake

        parts = urlsplit(handler.path)
        q = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        token = handler.headers.get("X-Nomad-Token", "")
        if handler.headers.get("X-Nomad-Routed"):
            q["_routed"] = "1"      # never bounce a forwarded upgrade

        def refuse(code: int, msg: str) -> None:
            data = json.dumps({"error": msg}).encode()
            resp = (f"HTTP/1.1 {code} Error\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(data)}\r\n\r\n")
            handler.connection.sendall(resp.encode() + data)

        remote = None
        try:
            self._enforce_acl("POST", parts.path, q, None, token)
            alloc_id = parts.path.split("/")[4]
            remote = self._client_route(alloc_id, q)
            if remote is None:
                tr = self._resolve_task_runner(alloc_id, q.get("task"))
            cmd = json.loads(q.get("command") or "[]")
            if not isinstance(cmd, list) or not cmd:
                raise HTTPError(400, "query param 'command' must be a "
                                     "non-empty JSON array")
            tty = q.get("tty", "true") != "false"
            if not handler.headers.get("Sec-WebSocket-Key"):
                raise HTTPError(400, "missing Sec-WebSocket-Key")
        except HTTPError as e:
            refuse(e.code, e.msg)
            return
        except Exception as e:
            refuse(500, str(e))
            return

        if remote is not None:
            # splice the upgrade through to the owning agent
            # (reference: the alloc-exec stream forwarded over
            # nodeConns — nomad/client_alloc_endpoint.go)
            try:
                self._tunnel_ws(handler, remote)
            except OSError as e:
                refuse(502, f"routing to {remote} failed: {e}")
            return

        # spawn only after the request is fully validated; if the
        # upgrade still fails mid-handshake, reap the process instead
        # of leaking it
        try:
            stream = tr.driver.exec_task_streaming(
                tr.task_id, [str(c) for c in cmd], tty=tty)
        except Exception as e:
            refuse(500, str(e))
            return
        try:
            ws = server_handshake(handler)
        except Exception:
            stream.terminate()
            stream.close()
            raise
        stop = threading.Event()

        def pump_output():
            try:
                while not stop.is_set():
                    r, _, _ = select.select([stream.fd], [], [], 0.2)
                    if not r:
                        if stream.poll() is not None:
                            break
                        continue
                    try:
                        data = os.read(stream.fd, 65536)
                    except OSError:      # pty closed on child exit
                        break
                    if not data:
                        break
                    ws.send_json({"stdout": {
                        "data": base64.b64encode(data).decode()}})
            except WebSocketClosed:
                pass
            finally:
                # drain the exit code (bounded — the child may have
                # been killed by close)
                code = stream.poll()
                for _ in range(50):
                    if code is not None:
                        break
                    time.sleep(0.1)
                    code = stream.poll()
                try:
                    ws.send_json({"exit": {
                        "code": -1 if code is None else code}})
                except WebSocketClosed:
                    pass
                ws.send_close()

        out_t = threading.Thread(target=pump_output, daemon=True)
        out_t.start()
        try:
            while True:
                msg = ws.recv_json()
                if msg is None:
                    break
                if "stdin" in msg:
                    st = msg["stdin"]
                    if st.get("close"):
                        stream.close_stdin()
                    elif st.get("data"):
                        try:
                            os.write(stream.fd,
                                     base64.b64decode(st["data"]))
                        except OSError:
                            break
                elif "tty_size" in msg:
                    sz = msg["tty_size"]
                    stream.resize(int(sz.get("width", 80)),
                                  int(sz.get("height", 24)))
        finally:
            stop.set()
            if stream.poll() is None:
                stream.terminate()
            out_t.join(timeout=6.0)
            stream.close()

    # -------------------------------------------- server->client routing
    def _client_route(self, alloc_prefix: str,
                      q: Optional[Dict[str, str]] = None
                      ) -> Optional[str]:
        """Which agent owns this alloc?  None = this one (serve
        locally); otherwise the owning node's advertised HTTP address
        to route to (reference: nomad/client_rpc.go — any server
        forwards client RPCs to the node over a persistent connection;
        here the agent's advertised HTTP surface is the conduit)."""
        if q and q.get("_routed"):
            # already forwarded once: answer locally or fail — never
            # bounce a request around the cluster
            return None
        if self.client is not None:
            if (self.client.get_alloc_runner(alloc_prefix) is not None
                or any(aid.startswith(alloc_prefix)
                       for aid in list(self.client.runners))):
                return None
        exact = self.server.store.alloc_by_id(alloc_prefix)
        matches = [exact] if exact is not None else [
            al for al in self.server.store.allocs()
            if al.id.startswith(alloc_prefix)]
        # prefer live allocs, but still route terminal ones — the
        # owning agent keeps terminal runners (and their logs) around
        live = [al for al in matches if not al.terminal_status()]
        pool = live or matches
        if len(pool) > 1:
            raise HTTPError(400, f"ambiguous alloc prefix "
                                 f"{alloc_prefix!r}")
        if not pool:
            raise HTTPError(404, f"alloc {alloc_prefix} not found")
        alloc = pool[0]
        if (self.client is not None
                and alloc.node_id == self.client.node.id):
            return None
        node = self.server.store.node_by_id(alloc.node_id)
        addr = (node.attributes.get("unique.advertise.http", "")
                if node else "")
        if not addr:
            raise HTTPError(
                502, f"node {alloc.node_id[:8]} has no advertised "
                     "agent address to route to")
        return addr

    def _proxy_client_http(self, remote: str, method: str, path: str,
                           q: Dict[str, str], body):
        """Forward one client-endpoint request to the owning agent and
        relay its JSON reply."""
        from urllib.parse import urlencode
        qs = urlencode(dict(q, _routed="1"))
        # the forwarded request may itself run a command with a
        # caller-chosen timeout; allow it to finish plus slack
        try:
            budget = float((body or {}).get("timeout_s", 0)) + 30.0
        except (TypeError, ValueError):
            budget = 30.0
        conn = self._peer_conn(remote, timeout=max(60.0, budget))
        try:
            conn.request(
                method, f"{path}?{qs}",
                body=(json.dumps(body) if body is not None else None),
                headers={"X-Nomad-Token":
                         getattr(self._tl, "token", "") or "",
                         "Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        except OSError as e:
            raise HTTPError(502, f"routing to {remote} failed: {e}")
        finally:
            conn.close()
        try:
            payload = json.loads(data) if data else {}
        except json.JSONDecodeError:
            payload = {"error": data.decode("utf-8", "replace")}
        if resp.status != 200:
            raise HTTPError(resp.status,
                            payload.get("error", f"agent {remote} "
                                                 f"replied {resp.status}"))
        idx = resp.getheader("X-Nomad-Index")
        return 200, payload, (int(idx) if idx else None)

    def _tunnel_ws(self, handler, remote: str) -> None:
        """Splice a websocket upgrade through to the owning agent:
        replay the request bytes, then pump both directions until
        either side closes (the exec stream's routed form)."""
        import socket as _socket
        host, _, port = remote.rpartition(":")
        rsock = _socket.create_connection((host, int(port)), timeout=60)
        rsock.settimeout(None)   # connect-only timeout: an idle
        # interactive session must not be torn down after 60s of quiet
        lines = [f"{handler.command} {handler.path} HTTP/1.1",
                 f"Host: {remote}", "X-Nomad-Routed: 1"]
        for k, v in handler.headers.items():
            if k.lower() in ("host", "x-nomad-routed"):
                continue
            lines.append(f"{k}: {v}")
        rsock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        csock = handler.connection

        def pump(src, dst):
            try:
                while True:
                    chunk = src.recv(65536)
                    if not chunk:
                        break
                    dst.sendall(chunk)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(_socket.SHUT_RDWR)
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(rsock, csock),
                             daemon=True)
        t.start()
        pump(csock, rsock)
        t.join(timeout=10.0)
        rsock.close()

    def _resolve_task_runner(self, alloc_id: str, task):
        """Find the local task runner for (alloc prefix, task name)."""
        if self.client is None:
            raise HTTPError(400, "no client agent on this node")
        runner = self.client.get_alloc_runner(alloc_id)
        if runner is None:
            matches = [r for aid, r in list(self.client.runners.items())
                       if aid.startswith(alloc_id)]
            if len(matches) != 1:
                raise HTTPError(404, f"alloc {alloc_id} not on node")
            runner = matches[0]
        trs = runner.task_runners
        if task:
            trs = [tr for tr in trs if tr.task.name == task]
        if len(trs) != 1:
            raise HTTPError(400, "specify 'task' (multiple tasks)"
                            if not task else f"unknown task {task!r}")
        tr = trs[0]
        if tr.handle is None:
            raise HTTPError(409, "task is not running")
        return tr

    def client_exec(self, q, body, alloc_id):
        """One-shot command execution inside a task's context
        (reference: alloc exec, plugins/drivers ExecTask — the one-shot
        form; see handle_exec_ws for the interactive pty stream).
        Routed to the owning agent when the alloc is not local."""
        if not body or not body.get("cmd"):
            raise HTTPError(400, "body must carry 'cmd' (list)")
        remote = self._client_route(alloc_id, q)
        if remote is not None:
            return self._proxy_client_http(
                remote, "POST", f"/v1/client/allocation/{alloc_id}/exec",
                q, body)
        tr = self._resolve_task_runner(alloc_id, body.get("task"))
        try:
            timeout_s = float(body.get("timeout_s", 30.0))
        except (TypeError, ValueError):
            raise HTTPError(400, "timeout_s must be a number")
        out, code = tr.driver.exec_task(
            tr.task_id, list(body["cmd"]), timeout_s=timeout_s)
        return 200, {"output": out.decode("utf-8", errors="replace"),
                     "exit_code": code}, None

    def client_csi_plugin_register(self, q, body, name):
        """Register an external CSI plugin endpoint with this agent's
        node (reference: dynamic plugin registration; the reference
        does this via plugin-supervisor task hooks, here it is also a
        first-class agent API)."""
        if self.client is None:
            raise HTTPError(400, "no client agent on this node")
        if not body or "addr" not in body:
            raise HTTPError(400, "body must carry 'addr' [host, port]")
        try:
            self.client.register_csi_plugin(name, tuple(body["addr"]))
        except Exception as e:
            raise HTTPError(502, f"plugin registration failed: {e}")
        return 200, {"registered": name}, None

    def job_dispatch(self, q, body, job_id):
        """Instantiate a parameterized job with a payload + meta
        (reference: command/agent/job_endpoint.go Dispatch →
        nomad/job_endpoint.go Job.Dispatch)."""
        import base64
        body = body or {}
        payload = b""
        if body.get("payload"):
            try:
                payload = base64.b64decode(body["payload"])
            except Exception:
                raise HTTPError(400, "payload must be base64")
        meta = body.get("meta") or {}
        if not isinstance(meta, dict):
            raise HTTPError(400, "meta must be an object")
        ns = q.get("namespace", "default")
        try:
            child, ev = self.server.dispatch_job(ns, job_id,
                                                 payload=payload,
                                                 meta=meta)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return 200, {"dispatched_job_id": child.id,
                     "eval_id": ev.id if ev else "",
                     "job_create_index": child.create_index}, \
            self.server.store.latest_index()

    def job_revert(self, q, body, job_id):
        """Manual revert to a retained job version (reference:
        Job.Revert — /v1/job/:id/revert)."""
        body = body or {}
        if "job_version" not in body:
            raise HTTPError(400, "body must carry 'job_version'")
        ns = q.get("namespace", "default")
        try:
            new_version, ev = self.server.revert_job_version(
                ns, job_id, int(body["job_version"]),
                enforce_prior_version=body.get("enforce_prior_version"))
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e))
        return 200, {"job_version": new_version,
                     "eval_id": ev.id if ev else ""}, \
            self.server.store.latest_index()

    def job_stable(self, q, body, job_id):
        """Mark a job version (un)stable (reference: Job.Stable —
        /v1/job/:id/stable)."""
        body = body or {}
        if "job_version" not in body:
            raise HTTPError(400, "body must carry 'job_version'")
        ns = q.get("namespace", "default")
        try:
            self.server.set_job_stability(
                ns, job_id, int(body["job_version"]),
                bool(body.get("stable", True)))
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e))
        return 200, {"job_version": int(body["job_version"]),
                     "stable": bool(body.get("stable", True))}, \
            self.server.store.latest_index()

    def job_scale(self, q, body, job_id):
        """Adjust a task group's count (reference: Job.Scale,
        nomad/job_endpoint.go ScaleStatus/Scale — registers the updated
        job and evaluates it with the scaling trigger)."""
        if not body or "group" not in body or "count" not in body:
            raise HTTPError(400, "body must carry 'group' and 'count'")
        ns = q.get("namespace", "default")
        job = self.server.store.job_by_id(ns, job_id)
        if job is None:
            raise HTTPError(404, f"job {job_id} not found")
        try:
            count = int(body["count"])
        except (TypeError, ValueError):
            raise HTTPError(400, "count must be an integer")
        if count < 0:
            raise HTTPError(400, "count must be >= 0")
        import copy as _copy
        j2 = _copy.deepcopy(job)
        tg = j2.lookup_task_group(body["group"])
        if tg is None:
            raise HTTPError(400, f"unknown group {body['group']!r}")
        tg.count = count
        try:
            ev = self.server.register_job(j2)
        except ValueError as e:
            raise HTTPError(400, str(e))
        return 200, {"eval_id": ev.id if ev else "",
                     "index": self.server.store.latest_index()}, None

    def services_list(self, q, body):
        ns = q.get("namespace", "default")
        index = self._block(q, "services")
        return 200, self.server.store.service_names(ns), index

    def service_get(self, q, body, name):
        ns = q.get("namespace", "default")
        index = self._block(q, "services")
        regs = self.server.store.services_by_name(ns, name)
        return 200, [to_wire(r) for r in regs], index

    def secrets_list(self, q, body):
        ns = q.get("namespace", "default")
        return 200, self.server.store.secret_paths(ns), \
            self.server.store.table_index("secrets")

    def secret_get(self, q, body, path):
        ns = q.get("namespace", "default")
        d = self.server.store.secret_by_path(ns, path)
        if d is None:
            raise HTTPError(404, f"secret {path} not found")
        return 200, {"path": path, "data": d}, \
            self.server.store.table_index("secrets")

    def secret_put(self, q, body, path):
        ns = q.get("namespace", "default")
        if (not body or "data" not in body
                or not isinstance(body["data"], dict)):
            raise HTTPError(400, "body must carry a 'data' object")
        index = self.server.upsert_secret(ns, path, body["data"])
        return 200, {"index": index}, index

    def secret_delete(self, q, body, path):
        ns = q.get("namespace", "default")
        index = self.server.delete_secret(ns, path)
        return 200, {"index": index}, index

    def acl_bootstrap(self, q, body):
        try:
            token = self.server.bootstrap_acl()
        except ValueError as e:
            raise HTTPError(400, str(e))
        return 200, to_wire(token), self.server.store.latest_index()

    def acl_policies_list(self, q, body):
        return 200, [to_wire(p) for p in self.server.store.acl_policies()], \
            self.server.store.latest_index()

    def acl_policy_get(self, q, body, name):
        p = self.server.store.acl_policy_by_name(name)
        if p is None:
            raise HTTPError(404, f"policy {name} not found")
        return 200, to_wire(p), self.server.store.latest_index()

    def acl_policy_upsert(self, q, body, name):
        from ..acl import ACLPolicy
        if not body:
            raise HTTPError(400, "body must carry the policy")
        policy = from_wire(ACLPolicy, body)
        policy.name = name
        index = self.server.upsert_acl_policy(policy)
        return 200, {"index": index}, index

    def acl_policy_delete(self, q, body, name):
        index = self.server.delete_acl_policy(name)
        return 200, {"index": index}, index

    def acl_tokens_list(self, q, body):
        out = []
        for t in self.server.store.acl_tokens():
            w = to_wire(t)
            w.pop("secret_id", None)       # listings never leak secrets
            out.append(w)
        return 200, out, self.server.store.latest_index()

    def acl_token_upsert(self, q, body):
        from ..acl import ACLToken
        if not body:
            raise HTTPError(400, "body must carry the token")
        token = from_wire(ACLToken, body)
        index = self.server.upsert_acl_token(token)
        return 200, to_wire(token), index

    def acl_token_get(self, q, body, accessor):
        t = self.server.store.acl_token_by_accessor(accessor)
        if t is None:
            raise HTTPError(404, f"token {accessor} not found")
        return 200, to_wire(t), self.server.store.latest_index()

    def acl_token_delete(self, q, body, accessor):
        index = self.server.delete_acl_token(accessor)
        return 200, {"index": index}, index

    def volumes_list(self, q, body):
        ns = q.get("namespace", "default")
        vols = self.server.store.csi_volumes(ns)
        return 200, [to_wire(v) for v in vols], \
            self.server.store.latest_index()

    def volume_get(self, q, body, vol_id):
        ns = q.get("namespace", "default")
        v = self.server.store.csi_volume_by_id(ns, vol_id)
        if v is None:
            raise HTTPError(404, f"volume {vol_id} not found")
        return 200, to_wire(v), self.server.store.latest_index()

    def volume_register(self, q, body, vol_id):
        from ..structs import CSIVolume
        if not body:
            raise HTTPError(400, "body must carry the volume")
        vol = from_wire(CSIVolume, body.get("volume", body))
        vol.id = vol_id
        if "namespace" in q:
            vol.namespace = q["namespace"]
        index = self.server.register_csi_volume(vol)
        return 200, {"index": index}, index

    def volume_delete(self, q, body, vol_id):
        ns = q.get("namespace", "default")
        try:
            index = self.server.deregister_csi_volume(ns, vol_id)
        except ValueError as e:
            raise HTTPError(409, str(e))
        return 200, {"index": index}, index

    def operator_scheduler_config(self, q, body):
        cfg = self.server.store.scheduler_config()
        return 200, to_wire(cfg), None


def _build_routes(s: HTTPAgentServer):
    R = re.compile
    return [
        (R(r"^/v1/jobs$"), {"GET": s.jobs_list, "POST": s.jobs_register,
                            "PUT": s.jobs_register}),
        (R(r"^/v1/jobs/parse$"), {"POST": s.jobs_parse,
                                  "PUT": s.jobs_parse}),
        (R(r"^/v1/job/([^/]+)$"), {"GET": s.job_get, "POST": s.job_update,
                                   "PUT": s.job_update,
                                   "DELETE": s.job_delete}),
        (R(r"^/v1/job/([^/]+)/allocations$"), {"GET": s.job_allocations}),
        (R(r"^/v1/job/([^/]+)/evaluations$"), {"GET": s.job_evaluations}),
        (R(r"^/v1/job/([^/]+)/deployments$"), {"GET": s.job_deployments}),
        (R(r"^/v1/job/([^/]+)/summary$"), {"GET": s.job_summary}),
        (R(r"^/v1/job/([^/]+)/versions$"), {"GET": s.job_versions}),
        (R(r"^/v1/job/([^/]+)/plan$"), {"POST": s.job_plan,
                                        "PUT": s.job_plan}),
        (R(r"^/v1/job/([^/]+)/periodic/force$"),
         {"POST": s.job_periodic_force}),
        (R(r"^/v1/evaluations$"), {"GET": s.evals_list}),
        (R(r"^/v1/evaluation/([^/]+)$"), {"GET": s.eval_get}),
        (R(r"^/v1/evaluation/([^/]+)/allocations$"),
         {"GET": s.eval_allocations}),
        (R(r"^/v1/allocations$"), {"GET": s.allocs_list}),
        (R(r"^/v1/allocation/([^/]+)$"), {"GET": s.alloc_get}),
        (R(r"^/v1/allocation/([^/]+)/stop$"), {"POST": s.alloc_stop,
                                               "PUT": s.alloc_stop}),
        (R(r"^/v1/nodes$"), {"GET": s.nodes_list}),
        (R(r"^/v1/node/([^/]+)$"), {"GET": s.node_get}),
        (R(r"^/v1/node/([^/]+)/allocations$"), {"GET": s.node_allocations}),
        (R(r"^/v1/node/([^/]+)/drain$"), {"POST": s.node_drain,
                                          "PUT": s.node_drain}),
        (R(r"^/v1/node/([^/]+)/eligibility$"), {"POST": s.node_eligibility,
                                                "PUT": s.node_eligibility}),
        (R(r"^/v1/node/([^/]+)/evaluate$"), {"POST": s.node_evaluate,
                                             "PUT": s.node_evaluate}),
        (R(r"^/v1/deployments$"), {"GET": s.deployments_list}),
        (R(r"^/v1/deployment/promote/([^/]+)$"),
         {"POST": s.deployment_promote, "PUT": s.deployment_promote}),
        (R(r"^/v1/deployment/fail/([^/]+)$"),
         {"POST": s.deployment_fail, "PUT": s.deployment_fail}),
        (R(r"^/v1/deployment/allocations/([^/]+)$"),
         {"GET": s.deployment_allocations}),
        (R(r"^/v1/deployment/([^/]+)$"), {"GET": s.deployment_get}),
        (R(r"^/v1/regions$"), {"GET": s.regions_list}),
        (R(r"^/v1/agent/self$"), {"GET": s.agent_self}),
        (R(r"^/v1/agent/pprof/([^/]+)$"), {"GET": s.agent_pprof}),
        (R(r"^/v1/agent/members$"), {"GET": s.agent_members}),
        (R(r"^/v1/status/leader$"), {"GET": s.status_leader}),
        (R(r"^/v1/status/peers$"), {"GET": s.status_peers}),
        (R(r"^/v1/metrics$"), {"GET": s.metrics}),
        (R(r"^/v1/traces$"), {"GET": s.traces_list}),
        # literal /v1/trace/corpus must outrank the :id capture
        (R(r"^/v1/trace/corpus$"), {"GET": s.trace_corpus,
                                    "POST": s.trace_corpus,
                                    "PUT": s.trace_corpus}),
        (R(r"^/v1/trace/([^/]+)$"), {"GET": s.trace_get}),
        (R(r"^/v1/agent/events$"), {"GET": s.agent_events}),
        (R(r"^/v1/telemetry/health$"), {"GET": s.telemetry_health}),
        (R(r"^/v1/telemetry/series$"), {"GET": s.telemetry_series}),
        (R(r"^/v1/system/gc$"), {"PUT": s.system_gc,
                                 "POST": s.system_gc}),
        (R(r"^/v1/operator/scheduler/configuration$"),
         {"GET": s.operator_scheduler_config}),
        (R(r"^/v1/search$"), {"POST": s.search, "PUT": s.search}),
        (R(r"^/v1/volumes$"), {"GET": s.volumes_list}),
        (R(r"^/v1/volume/csi/([^/]+)$"), {"GET": s.volume_get,
                                          "PUT": s.volume_register,
                                          "POST": s.volume_register,
                                          "DELETE": s.volume_delete}),
        (R(r"^/v1/acl/bootstrap$"), {"POST": s.acl_bootstrap,
                                     "PUT": s.acl_bootstrap}),
        (R(r"^/v1/acl/policies$"), {"GET": s.acl_policies_list}),
        (R(r"^/v1/acl/policy/([^/]+)$"), {"GET": s.acl_policy_get,
                                          "POST": s.acl_policy_upsert,
                                          "PUT": s.acl_policy_upsert,
                                          "DELETE": s.acl_policy_delete}),
        (R(r"^/v1/acl/tokens$"), {"GET": s.acl_tokens_list,
                                  "POST": s.acl_token_upsert,
                                  "PUT": s.acl_token_upsert}),
        (R(r"^/v1/acl/token/([^/]+)$"), {"GET": s.acl_token_get,
                                         "DELETE": s.acl_token_delete}),
        (R(r"^/v1/client/fs/logs/([^/]+)$"), {"GET": s.client_logs}),
        (R(r"^/v1/client/fs/ls/([^/]+)$"), {"GET": s.client_fs_ls}),
        (R(r"^/v1/client/fs/stat/([^/]+)$"), {"GET": s.client_fs_stat}),
        (R(r"^/v1/client/fs/cat/([^/]+)$"), {"GET": s.client_fs_cat}),
        (R(r"^/v1/client/fs/readat/([^/]+)$"),
         {"GET": s.client_fs_readat}),
        (R(r"^/v1/client/fs/stream/([^/]+)$"),
         {"GET": s.client_fs_stream}),
        (R(r"^/v1/client/stats$"), {"GET": s.client_host_stats}),
        (R(r"^/v1/client/allocation/([^/]+)/stats$"),
         {"GET": s.client_alloc_stats}),
        (R(r"^/v1/client/allocation/([^/]+)/exec$"),
         {"POST": s.client_exec, "PUT": s.client_exec}),
        (R(r"^/v1/client/csi/plugin/([^/]+)$"),
         {"POST": s.client_csi_plugin_register,
          "PUT": s.client_csi_plugin_register}),
        (R(r"^/v1/job/([^/]+)/scale$"), {"POST": s.job_scale,
                                         "PUT": s.job_scale}),
        (R(r"^/v1/job/([^/]+)/dispatch$"), {"POST": s.job_dispatch,
                                            "PUT": s.job_dispatch}),
        (R(r"^/v1/job/([^/]+)/revert$"), {"POST": s.job_revert,
                                          "PUT": s.job_revert}),
        (R(r"^/v1/job/([^/]+)/stable$"), {"POST": s.job_stable,
                                          "PUT": s.job_stable}),
        (R(r"^/v1/services$"), {"GET": s.services_list}),
        (R(r"^/v1/service/([^/]+)$"), {"GET": s.service_get}),
        (R(r"^/v1/secrets$"), {"GET": s.secrets_list}),
        (R(r"^/v1/secret/(.+)$"), {"GET": s.secret_get,
                                   "PUT": s.secret_put,
                                   "POST": s.secret_put,
                                   "DELETE": s.secret_delete}),
    ]
