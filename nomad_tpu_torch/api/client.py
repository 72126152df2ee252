"""API client SDK (reference: api/ — api.NewClient api.go:400, per-
resource files jobs.go, nodes.go, allocations.go, evaluations.go,
deployments.go, operator.go).

Talks to the agent's HTTP /v1 surface; no imports from the server
packages — this is the external-consumer boundary the CLI uses.

The counterpart of `nomad_tpu.api.client`.  The address, token and TLS
settings are constructor arguments; without them the client reads
Nomad's `NOMAD_ADDR`, `NOMAD_TOKEN` and `NOMAD_CACERT` /
`NOMAD_CLIENT_CERT` / `NOMAD_CLIENT_KEY`, as the reference's does (the
port's CLI, `cli/main.py`, passes only its `-address`).
`allocations.exec_stream` runs an interactive exec over a websocket;
`text` reads a route that answers plain text (the Prometheus
exposition).
"""
from __future__ import annotations

import base64
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple


def _q(path_param: str) -> str:
    """Percent-encode a path parameter; dispatched child job ids embed a
    '/' (<parent>/dispatch-<...>) and must travel as one path segment."""
    return urllib.parse.quote(path_param, safe="")


class APIError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(f"HTTP {code}: {msg}")
        self.code = code
        self.msg = msg


class ApiClient:
    def __init__(self, address: Optional[str] = None,
                 timeout: float = 330.0, token: Optional[str] = None,
                 tls=None):
        """`tls`: a utils.tlsutil.TLSConfig (or env NOMAD_CACERT /
        NOMAD_CLIENT_CERT / NOMAD_CLIENT_KEY, like the reference api
        client) — mutual TLS to an https agent address."""
        self.address = (address or os.environ.get("NOMAD_ADDR")
                        or "http://127.0.0.1:4646").rstrip("/")
        # reference: api.Config.SecretID / NOMAD_TOKEN (api/api.go)
        self.token = token or os.environ.get("NOMAD_TOKEN", "")
        self.timeout = timeout
        if tls is None and os.environ.get("NOMAD_CACERT"):
            from ..utils.tlsutil import TLSConfig
            tls = TLSConfig(
                ca_file=os.environ.get("NOMAD_CACERT", ""),
                cert_file=os.environ.get("NOMAD_CLIENT_CERT", ""),
                key_file=os.environ.get("NOMAD_CLIENT_KEY", ""))
        self.ssl_context = None
        if tls is not None and getattr(tls, "enabled", lambda: False)():
            from ..utils.tlsutil import client_context
            self.ssl_context = client_context(tls)
        self.jobs = Jobs(self)
        self.nodes = Nodes(self)
        self.allocations = Allocations(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.system = System(self)
        self.agent = Agent(self)
        self.operator = Operator(self)

    # ------------------------------------------------------------ plumbing
    def request(self, method: str, path: str,
                params: Optional[Dict[str, Any]] = None,
                body: Any = None) -> Tuple[Any, int]:
        raw, index = self._send(method, path, params, body)
        return json.loads(raw or b"null"), index

    def text(self, path: str, **params) -> str:
        """GET a route that answers plain text."""
        return self._send("GET", path, params, None)[0].decode()

    def _send(self, method: str, path: str,
              params: Optional[Dict[str, Any]], body: Any
              ) -> Tuple[bytes, int]:
        url = f"{self.address}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v not in (None, "")})
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("X-Nomad-Token", self.token)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self.ssl_context) as resp:
                raw = resp.read()
                index = int(resp.headers.get("X-Nomad-Index") or 0)
                return raw, index
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:
                msg = str(e)
            raise APIError(e.code, msg)
        except urllib.error.URLError as e:
            raise APIError(0, f"cannot reach agent at {self.address}: "
                              f"{e.reason}")
        except OSError as e:
            # e.g. a plaintext dial against a TLS listener resets mid-
            # response; surface it as the same unreachable-agent error
            raise APIError(0, f"cannot reach agent at {self.address}: "
                              f"{e}")

    def get(self, path, **params):
        return self.request("GET", path, params=params)

    def post(self, path, body=None, **params):
        return self.request("POST", path, params=params, body=body)

    def delete(self, path, **params):
        return self.request("DELETE", path, params=params)


class _Sub:
    def __init__(self, client: ApiClient):
        self.c = client


class Jobs(_Sub):
    def list(self, prefix: str = "", index: int = 0, wait: str = ""):
        return self.c.get("/v1/jobs", prefix=prefix, index=index or None,
                          wait=wait)

    def register(self, job_wire: dict) -> dict:
        return self.c.post("/v1/jobs", {"job": job_wire})[0]

    def register_with_check(self, job_wire: dict,
                            check_index: int) -> dict:
        return self.c.post("/v1/jobs", {
            "job": job_wire, "enforce_index": True,
            "job_modify_index": check_index})[0]

    def parse(self, hcl: str) -> dict:
        return self.c.post("/v1/jobs/parse", {"job_hcl": hcl})[0]

    def info(self, job_id: str, index: int = 0, wait: str = ""):
        return self.c.get(f"/v1/job/{_q(job_id)}", index=index or None,
                          wait=wait)

    def deregister(self, job_id: str, purge: bool = False) -> dict:
        return self.c.delete(f"/v1/job/{_q(job_id)}",
                             purge="true" if purge else None)[0]

    def allocations(self, job_id: str) -> List[dict]:
        return self.c.get(f"/v1/job/{_q(job_id)}/allocations")[0]

    def evaluations(self, job_id: str) -> List[dict]:
        return self.c.get(f"/v1/job/{_q(job_id)}/evaluations")[0]

    def deployments(self, job_id: str) -> List[dict]:
        return self.c.get(f"/v1/job/{_q(job_id)}/deployments")[0]

    def summary(self, job_id: str) -> dict:
        return self.c.get(f"/v1/job/{_q(job_id)}/summary")[0]

    def versions(self, job_id: str) -> List[dict]:
        return self.c.get(f"/v1/job/{_q(job_id)}/versions")[0]

    def plan(self, job_id: str, job_wire: dict) -> dict:
        return self.c.post(f"/v1/job/{_q(job_id)}/plan",
                           {"job": job_wire})[0]

    def periodic_force(self, job_id: str) -> dict:
        return self.c.post(f"/v1/job/{_q(job_id)}/periodic/force")[0]

    def dispatch(self, job_id: str, payload: bytes = b"",
                 meta: Optional[Dict[str, str]] = None) -> dict:
        """Instantiate a parameterized job (reference: api/jobs.go
        Dispatch); returns {dispatched_job_id, eval_id}."""
        body: Dict[str, Any] = {}
        if payload:
            body["payload"] = base64.b64encode(payload).decode()
        if meta:
            body["meta"] = dict(meta)
        return self.c.post(f"/v1/job/{_q(job_id)}/dispatch", body)[0]

    def revert(self, job_id: str, version: int,
               enforce_prior_version: Optional[int] = None) -> dict:
        body: Dict[str, Any] = {"job_version": version}
        if enforce_prior_version is not None:
            body["enforce_prior_version"] = enforce_prior_version
        return self.c.post(f"/v1/job/{_q(job_id)}/revert", body)[0]

    def stable(self, job_id: str, version: int,
               stable: bool = True) -> dict:
        return self.c.post(f"/v1/job/{_q(job_id)}/stable",
                           {"job_version": version, "stable": stable})[0]

    def scale(self, job_id: str, group: str, count: int) -> dict:
        return self.c.post(f"/v1/job/{_q(job_id)}/scale",
                           {"group": group, "count": count})[0]


class Nodes(_Sub):
    def list(self, prefix: str = "", index: int = 0, wait: str = ""):
        return self.c.get("/v1/nodes", prefix=prefix, index=index or None,
                          wait=wait)

    def info(self, node_id: str) -> dict:
        return self.c.get(f"/v1/node/{node_id}")[0]

    def allocations(self, node_id: str) -> List[dict]:
        return self.c.get(f"/v1/node/{node_id}/allocations")[0]

    def drain(self, node_id: str, deadline_s: float = 3600.0,
              ignore_system_jobs: bool = False,
              disable: bool = False) -> dict:
        body = {"drain_spec": None if disable else
                {"deadline_s": deadline_s,
                 "ignore_system_jobs": ignore_system_jobs},
                "mark_eligible": disable}
        return self.c.post(f"/v1/node/{node_id}/drain", body)[0]

    def eligibility(self, node_id: str, eligible: bool) -> dict:
        return self.c.post(
            f"/v1/node/{node_id}/eligibility",
            {"eligibility": "eligible" if eligible else "ineligible"})[0]

    def stats(self, node_id: str = "") -> dict:
        """Host resource gauges from a node's agent (reference:
        /v1/client/stats; ?node_id routes to that node)."""
        params = {"node_id": node_id} if node_id else {}
        return self.c.get("/v1/client/stats", **params)[0]


class Allocations(_Sub):
    def list(self, prefix: str = "", index: int = 0, wait: str = ""):
        return self.c.get("/v1/allocations", prefix=prefix,
                          index=index or None, wait=wait)

    def info(self, alloc_id: str) -> dict:
        return self.c.get(f"/v1/allocation/{alloc_id}")[0]

    def stop(self, alloc_id: str) -> dict:
        return self.c.post(f"/v1/allocation/{alloc_id}/stop")[0]

    def logs(self, alloc_id: str, task: str = "",
             type: str = "stdout", tail_lines: int = 0) -> str:
        """Task log contents (routed to the owning agent by the server
        — reference: api/fs.go Logs)."""
        params = {"type": type}
        if task:
            params["task"] = task
        if tail_lines:
            params["tail_lines"] = tail_lines
        out, _ix = self.c.get(f"/v1/client/fs/logs/{alloc_id}", **params)
        return out.get("data", "")

    def exec(self, alloc_id: str, cmd, task: str = "",
             timeout_s: float = 30.0) -> dict:
        """One-shot exec in the task's context; returns
        {"output", "exit_code"} (routed to the owning agent)."""
        body = {"cmd": [str(c) for c in cmd], "timeout_s": timeout_s}
        if task:
            body["task"] = task
        return self.c.post(
            f"/v1/client/allocation/{alloc_id}/exec", body)[0]

    # alloc filesystem (reference: api/fs.go — routed by the server)
    def _fs_get(self, verb: str, alloc_id: str, fs_path: str,
                **extra):
        # request() directly: the kwarg-based get() collides with a
        # file param literally named "path"
        return self.c.request(
            "GET", f"/v1/client/fs/{verb}/{alloc_id}",
            params=dict(extra, path=fs_path))[0]

    def fs_ls(self, alloc_id: str, path: str = "/") -> List[dict]:
        return self._fs_get("ls", alloc_id, path)["files"]

    def fs_stat(self, alloc_id: str, path: str) -> dict:
        return self._fs_get("stat", alloc_id, path)["file"]

    def fs_cat(self, alloc_id: str, path: str) -> bytes:
        """Full file contents; pages past the server's single-response
        cap with readat so large files come back complete."""
        out = self._fs_get("cat", alloc_id, path)
        data = base64.b64decode(out.get("data", ""))
        total = out.get("size", len(data))
        while out.get("truncated") and len(data) < total:
            chunk = self.fs_readat(alloc_id, path, offset=len(data),
                                   limit=1 << 20)
            if not chunk:
                break
            data += chunk
        return data

    def fs_readat(self, alloc_id: str, path: str, offset: int = 0,
                  limit: int = 1 << 20) -> bytes:
        out = self._fs_get("readat", alloc_id, path, offset=offset,
                           limit=limit)
        return base64.b64decode(out.get("data", ""))

    def fs_stream(self, alloc_id: str, path: str, offset: int = 0,
                  wait: float = 2.0) -> dict:
        """One long-poll step of a file follow; returns
        {"data": bytes, "offset": next_offset, "size": file_size}."""
        out = self._fs_get("stream", alloc_id, path, offset=offset,
                           wait=wait)
        out["data"] = base64.b64decode(out.get("data", ""))
        return out

    def stats(self, alloc_id: str) -> dict:
        """Per-task resource usage (routed to the owning agent)."""
        return self.c.get(
            f"/v1/client/allocation/{alloc_id}/stats")[0]

    def exec_stream(self, alloc_id: str, command, task: str = "",
                    tty: bool = True, stdin_fd=None, stdout_fd=1,
                    tty_size=None, timeout: float = 3600.0) -> int:
        """Interactive exec (reference: api/allocations.go Exec —
        websocket to the agent, bridged to the driver's streaming
        exec).  Pumps local file descriptors: stdin_fd -> task stdin
        (None = output-only), task output -> stdout_fd.  Returns the
        remote exit code."""
        import json as _json
        import select
        import threading
        from urllib.parse import quote

        from .websocket import WebSocketClosed, client_connect

        qs = (f"command={quote(_json.dumps([str(c) for c in command]))}"
              f"&tty={'true' if tty else 'false'}")
        if task:
            qs += f"&task={quote(task)}"
        url = (f"{self.c.address}/v1/client/allocation/{alloc_id}"
               f"/exec?{qs}")
        ws = client_connect(url, token=self.c.token, timeout=timeout)
        if tty_size:
            ws.send_json({"tty_size": {"width": tty_size[0],
                                       "height": tty_size[1]}})
        done = threading.Event()

        def pump_stdin():
            if stdin_fd is None:
                return
            try:
                while not done.is_set():
                    r, _, _ = select.select([stdin_fd], [], [], 0.2)
                    if not r:
                        continue
                    data = os.read(stdin_fd, 65536)
                    if not data:
                        ws.send_json({"stdin": {"close": True}})
                        return
                    ws.send_json({"stdin": {
                        "data": base64.b64encode(data).decode()}})
            except (OSError, WebSocketClosed):
                pass

        in_t = threading.Thread(target=pump_stdin, daemon=True)
        in_t.start()
        code = -1
        try:
            while True:
                msg = ws.recv_json()
                if msg is None:
                    break
                if "stdout" in msg and msg["stdout"].get("data"):
                    os.write(stdout_fd,
                             base64.b64decode(msg["stdout"]["data"]))
                elif "exit" in msg:
                    code = int(msg["exit"].get("code", -1))
                    break
        finally:
            done.set()
            ws.close()
            in_t.join(timeout=1.0)
        return code


class Evaluations(_Sub):
    def list(self) -> List[dict]:
        return self.c.get("/v1/evaluations")[0]

    def info(self, eval_id: str) -> dict:
        return self.c.get(f"/v1/evaluation/{eval_id}")[0]

    def allocations(self, eval_id: str) -> List[dict]:
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations")[0]


class Deployments(_Sub):
    def list(self, index: int = 0, wait: str = ""):
        return self.c.get("/v1/deployments", index=index or None, wait=wait)

    def info(self, dep_id: str) -> dict:
        return self.c.get(f"/v1/deployment/{dep_id}")[0]

    def promote(self, dep_id: str) -> dict:
        return self.c.post(f"/v1/deployment/promote/{dep_id}")[0]

    def fail(self, dep_id: str) -> dict:
        return self.c.post(f"/v1/deployment/fail/{dep_id}")[0]

    def allocations(self, dep_id: str) -> List[dict]:
        return self.c.get(f"/v1/deployment/allocations/{dep_id}")[0]


class System(_Sub):
    def gc(self) -> None:
        self.c.post("/v1/system/gc")


class Agent(_Sub):
    def self_(self) -> dict:
        return self.c.get("/v1/agent/self")[0]

    def members(self) -> dict:
        return self.c.get("/v1/agent/members")[0]

    def metrics(self) -> dict:
        return self.c.get("/v1/metrics")[0]


class Operator(_Sub):
    def scheduler_config(self) -> dict:
        return self.c.get("/v1/operator/scheduler/configuration")[0]
