"""CLI (reference: command/ — the mitchellh/cli command tree wired in
command/commands.go; verbs: job run/status/plan/stop, node status/drain/
eligibility, alloc status, eval status, deployment *, system gc, agent).

All data flows through the HTTP API via the SDK (ApiClient) — the CLI
never imports server internals, mirroring the reference's CLI->api->HTTP
layering. `agent -dev` is the one exception: it BOOTS the in-process
server+client+HTTP agent (reference: nomad agent -dev).

The counterpart of `nomad_tpu.cli.main`, run as `python -m
nomad_tpu_torch.cli`.  The CLI, not the library's `ApiClient`, reads
Nomad's client variables (`NOMAD_ADDR`, `NOMAD_TOKEN`, `NOMAD_CACERT` /
`NOMAD_CLIENT_CERT` / `NOMAD_CLIENT_KEY`) and hands them to `ApiClient`,
so a command behaves as the reference's.  `agent -dev` builds the port's
`Server`, whose workers solve on `cuda`.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

from ..api.client import ApiClient, APIError


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    all_rows = [header] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in all_rows)
              for i in range(len(header))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in all_rows]
    return "\n".join(lines)


def _short(id_: str) -> str:
    return id_[:8] if len(id_) > 8 else id_


def _client(args) -> ApiClient:
    """The API client of a command: `-address`, else the client's own
    reading of Nomad's `NOMAD_ADDR`, `NOMAD_TOKEN` and TLS variables."""
    return ApiClient(address=args.address)


# ---------------------------------------------------------------- agent
def cmd_agent(args) -> int:
    from ..api.http_server import HTTPAgentServer
    from ..client.agent import Client
    from ..server.server import Server
    from .config import AgentConfig, load_agent_config

    if not args.dev:
        print("only -dev mode is supported", file=sys.stderr)
        return 1
    # config file first, explicit CLI flags override
    # (command/agent/config.go merge order)
    try:
        cfg = (load_agent_config(args.config) if args.config
               else AgentConfig())
    except (OSError, ValueError) as e:
        print(f"error loading config: {e}", file=sys.stderr)
        return 1
    if not cfg.server_enabled:
        print("server.enabled = false is not supported by the dev "
              "agent (it always embeds a server)", file=sys.stderr)
        return 1
    bind = args.bind if args.bind is not None else cfg.bind_addr
    port = args.port if args.port is not None else cfg.http_port
    data_dir = (args.data_dir if args.data_dir is not None
                else cfg.data_dir)
    workers = (args.workers if args.workers is not None
               else cfg.num_schedulers)
    acl_enabled = args.acl_enabled or cfg.acl_enabled
    # the agent's own logging level (the monitor endpoint streams what
    # this emits); operators embedding the library configure logging
    # themselves
    from ..utils.monitor import parse_level
    logging.getLogger("nomad_tpu_torch").setLevel(
        parse_level(cfg.log_level))
    if cfg.tls_rpc:
        print("WARNING: tls { rpc = true } has no effect in -dev mode "
              "(single process, no RPC sockets); serve_cluster wires "
              "RPC TLS for multi-server deployments", file=sys.stderr)
    server = Server(num_workers=workers,
                    serving_config=cfg.serving or None)
    server.start()
    client = None
    if not args.server_only and cfg.client_enabled:
        client = Client(server, data_dir=data_dir,
                        datacenter=cfg.datacenter,
                        meta=cfg.meta or None)
        client.start()
    http = HTTPAgentServer(server, client, host=bind, port=port,
                           acl_enabled=acl_enabled,
                           tls=(cfg.tls_config() if cfg.tls_http
                                else None))
    http.start()
    print(f"==> nomad-tpu agent started (dev mode)")
    print(f"    HTTP: {http.address}")
    if client is not None:
        print(f"    Node: {client.node.id} ({client.node.name})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("==> shutting down")
        http.stop()
        if client is not None:
            client.shutdown(halt_tasks=True)
        server.stop()
    return 0


# -------------------------------------------------------------- monitor
def cmd_monitor(args) -> int:
    """`monitor` — stream agent logs (reference: command/monitor.go)."""
    import urllib.request
    api = _client(args)
    params = [f"log_level={args.log_level}"]
    if args.node_id:
        params.append(f"node_id={args.node_id}")
    if args.duration:
        params.append(f"duration_s={args.duration}")
    url = f"{api.address}/v1/agent/monitor?" + "&".join(params)
    req = urllib.request.Request(url)
    if api.token:
        req.add_header("X-Nomad-Token", api.token)
    try:
        with urllib.request.urlopen(req, timeout=330.0,
                                    context=api.ssl_context) as resp:
            for raw in resp:
                sys.stdout.write(raw.decode(errors="replace"))
                sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    except urllib.error.HTTPError as e:
        # clean CLI error, matching every other command's ACL/4xx path
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except Exception:
            msg = str(e)
        raise APIError(e.code, msg)
    except (urllib.error.URLError, OSError) as e:
        raise APIError(0, f"cannot reach agent at {api.address}: {e}")
    return 0


# ------------------------------------------------------------------ tls
def cmd_tls_ca(args) -> int:
    """`tls ca create` (reference: command/tls_ca_create.go)."""
    from ..utils import tlsutil
    ca_pem, key_pem = tlsutil.generate_ca()
    ca = os.path.join(args.dir, "nomad-agent-ca.pem")
    key = os.path.join(args.dir, "nomad-agent-ca-key.pem")
    with open(ca, "wb") as f:
        f.write(ca_pem)
    tlsutil.write_private(key, key_pem)
    print(f"==> CA certificate saved to {ca}")
    print(f"==> CA key saved to {key} (keep this private)")
    return 0


def cmd_tls_cert(args) -> int:
    """`tls cert create` (reference: command/tls_cert_create.go)."""
    from ..utils import tlsutil
    ca = os.path.join(args.dir, "nomad-agent-ca.pem")
    key = os.path.join(args.dir, "nomad-agent-ca-key.pem")
    try:
        with open(ca, "rb") as f:
            ca_pem = f.read()
        with open(key, "rb") as f:
            ca_key = f.read()
    except OSError as e:
        print(f"cannot read CA material in {args.dir}: {e} "
              "(run `tls ca create` first)", file=sys.stderr)
        return 1
    sans = ["localhost"] + list(args.additional_dns)
    ips = ["127.0.0.1"] + list(args.additional_ip)
    cert_pem, key_pem = tlsutil.generate_cert(
        ca_pem, ca_key, args.role, sans=sans, ips=ips)
    cpath = os.path.join(args.dir, f"{args.role}.pem")
    kpath = os.path.join(args.dir, f"{args.role}-key.pem")
    with open(cpath, "wb") as f:
        f.write(cert_pem)
    tlsutil.write_private(kpath, key_pem)
    print(f"==> certificate saved to {cpath}")
    print(f"==> key saved to {kpath}")
    return 0


# ------------------------------------------------------------------ job
def cmd_job_run(args) -> int:
    api = _client(args)
    with open(args.file) as f:
        hcl = f.read()
    job = api.jobs.parse(hcl)
    if args.check_index is not None:
        job["job_modify_index"] = args.check_index
        resp = api.jobs.register_with_check(job, args.check_index)
    else:
        resp = api.jobs.register(job)
    print(f"==> Job {job['id']!r} registered")
    if resp.get("eval_id"):
        print(f"    Evaluation ID: {resp['eval_id']}")
        return _monitor_eval(api, resp["eval_id"], args.detach)
    return 0


def _monitor_eval(api: ApiClient, eval_id: str, detach: bool) -> int:
    if detach:
        return 0
    for _ in range(100):
        ev = api.evaluations.info(eval_id)
        if ev["status"] == "complete":
            print("    Evaluation complete")
            return 0
        if ev["status"] in ("failed", "cancelled", "canceled"):
            print(f"    Evaluation {ev['status']}")
            if ev.get("blocked_eval"):
                print(f"    Blocked eval: {ev['blocked_eval']}")
            return 2
        time.sleep(0.2)
    print("    (still in progress; detaching)")
    return 0


def cmd_job_status(args) -> int:
    api = _client(args)
    if not args.job_id:
        jobs, _ = api.jobs.list()
        if not jobs:
            print("No running jobs")
            return 0
        print(_fmt_table(
            [[j["id"], j["type"], j["priority"], j["status"]]
             for j in jobs],
            ["ID", "Type", "Priority", "Status"]))
        return 0
    job, _ = api.jobs.info(args.job_id)
    print(f"ID            = {job['id']}")
    print(f"Name          = {job['name']}")
    print(f"Type          = {job['type']}")
    print(f"Priority      = {job['priority']}")
    print(f"Status        = {job['status']}")
    print(f"Version       = {job['version']}")
    allocs = api.jobs.allocations(args.job_id)
    if allocs:
        print("\nAllocations")
        print(_fmt_table(
            [[_short(a["ID"]), _short(a["EvalID"]), a["TaskGroup"],
              a["DesiredStatus"], a["ClientStatus"]] for a in allocs],
            ["ID", "Eval ID", "Task Group", "Desired", "Status"]))
    return 0


def cmd_job_stop(args) -> int:
    api = _client(args)
    resp = api.jobs.deregister(args.job_id, purge=args.purge)
    print(f"==> Job {args.job_id!r} stopped")
    if resp.get("eval_id"):
        return _monitor_eval(api, resp["eval_id"], args.detach)
    return 0


def cmd_job_plan(args) -> int:
    api = _client(args)
    with open(args.file) as f:
        job = api.jobs.parse(f.read())
    resp = api.jobs.plan(job["id"], job)
    ann = resp.get("annotations") or {}
    if ann.get("desired_tg_updates"):
        for tg, upd in ann["desired_tg_updates"].items():
            parts = [f"{k}: {v}" for k, v in sorted(upd.items()) if v]
            print(f"Task Group {tg!r}: " + (", ".join(parts) or "no change"))
    else:
        print("(no annotations)")
    if resp.get("error"):
        print(f"Error: {resp['error']}")
        return 1
    return 0


def cmd_job_dispatch(args) -> int:
    """`job dispatch` (reference: command/job_dispatch.go)."""
    api = _client(args)
    payload = b""
    if args.payload_file:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    meta = {}
    for kv in args.meta or []:
        if "=" not in kv:
            print(f"invalid -meta {kv!r} (want key=value)",
                  file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        meta[k] = v
    out = api.jobs.dispatch(args.job_id, payload=payload, meta=meta)
    print(f"Dispatched Job ID = {out['dispatched_job_id']}")
    if out.get("eval_id"):
        print(f"Evaluation ID     = {_short(out['eval_id'])}")
    return 0


def cmd_job_revert(args) -> int:
    """`job revert` (reference: command/job_revert.go)."""
    api = _client(args)
    out = api.jobs.revert(args.job_id, args.version)
    print(f"Job reverted; now at version {out['job_version']}")
    if out.get("eval_id"):
        print(f"Evaluation ID = {_short(out['eval_id'])}")
    return 0


def cmd_job_history(args) -> int:
    """`job history` (reference: command/job_history.go)."""
    api = _client(args)
    for v in api.jobs.versions(args.job_id):
        stable = "stable" if v.get("stable") else ""
        print(f"Version {v['version']:>3}  modify_index="
              f"{v['job_modify_index']:<8} {stable}")
    return 0


def cmd_job_periodic_force(args) -> int:
    api = _client(args)
    resp = api.jobs.periodic_force(args.job_id)
    print(f"==> Forced launch: {resp['child_job_id']}")
    return 0


# ----------------------------------------------------------------- node
def cmd_node_status(args) -> int:
    api = _client(args)
    if not args.node_id:
        nodes, _ = api.nodes.list()
        print(_fmt_table(
            [[_short(n["id"]), n["name"], n["datacenter"],
              "true" if n["drain"] else "false",
              n["scheduling_eligibility"], n["status"]] for n in nodes],
            ["ID", "Name", "DC", "Drain", "Eligibility", "Status"]))
        return 0
    n = api.nodes.info(args.node_id)
    print(f"ID          = {n['id']}")
    print(f"Name        = {n['name']}")
    print(f"Datacenter  = {n['datacenter']}")
    print(f"Class       = {n['node_class'] or '<none>'}")
    print(f"Status      = {n['status']}")
    print(f"Eligibility = {n['scheduling_eligibility']}")
    allocs = api.nodes.allocations(n["id"])
    if allocs:
        print("\nAllocations")
        print(_fmt_table(
            [[_short(a["ID"]), a["JobID"], a["TaskGroup"],
              a["DesiredStatus"], a["ClientStatus"]] for a in allocs],
            ["ID", "Job ID", "Task Group", "Desired", "Status"]))
    return 0


def cmd_node_drain(args) -> int:
    api = _client(args)
    from ..jobspec import parse_duration_s
    if args.enable:
        api.nodes.drain(args.node_id,
                        deadline_s=parse_duration_s(args.deadline),
                        ignore_system_jobs=args.ignore_system)
        print(f"==> Node {_short(args.node_id)} drain enabled")
    else:
        api.nodes.drain(args.node_id, disable=True)
        print(f"==> Node {_short(args.node_id)} drain disabled")
    return 0


def cmd_node_eligibility(args) -> int:
    api = _client(args)
    api.nodes.eligibility(args.node_id, args.enable)
    state = "eligible" if args.enable else "ineligible"
    print(f"==> Node {_short(args.node_id)} marked {state}")
    return 0


# ---------------------------------------------------------------- alloc
def cmd_alloc_status(args) -> int:
    api = _client(args)
    a = api.allocations.info(args.alloc_id)
    print(f"ID           = {a['id']}")
    print(f"Name         = {a['name']}")
    print(f"Node ID      = {_short(a['node_id'])}")
    print(f"Job ID       = {a['job_id']}")
    print(f"Client Status= {a['client_status']}")
    print(f"Desired      = {a['desired_status']}")
    for task, ts in (a.get("task_states") or {}).items():
        print(f"\nTask {task!r} is {ts['state']}"
              + (" (failed)" if ts["failed"] else ""))
        for ev in ts.get("events", []):
            stamp = time.strftime("%H:%M:%S", time.localtime(ev["time"]))
            print(f"  {stamp}  {ev['type']:<16} {ev.get('message', '')}")
    m = a.get("metrics") or {}
    if m.get("nodes_evaluated"):
        print(f"\nPlacement Metrics")
        print(f"  Nodes evaluated: {m['nodes_evaluated']}; "
              f"filtered: {m['nodes_filtered']}; "
              f"exhausted: {m['nodes_exhausted']}")
        for sm in m.get("score_meta", [])[:5]:
            print(f"  {sm}")
    return 0


def cmd_alloc_logs(args) -> int:
    api = _client(args)
    params = {"type": "stderr" if args.stderr else "stdout"}
    if args.task:
        params["task"] = args.task
    if args.tail:
        params["tail_lines"] = str(args.tail)
    out, _ix = api.get(f"/v1/client/fs/logs/{args.alloc_id}", **params)
    sys.stdout.write(out["data"])
    if out["data"] and not out["data"].endswith("\n"):
        sys.stdout.write("\n")
    return 0


def cmd_alloc_fs(args) -> int:
    """`alloc fs` (reference: command/alloc_fs.go — ls by default,
    -stat for metadata, file paths print contents, -tail/-f follow)."""
    api = _client(args)
    path = args.path or "/"
    if args.stat:
        f = api.allocations.fs_stat(args.alloc_id, path)
        print(f"{f['file_mode']}  {f['size']:>10}  {f['mod_time']}  "
              f"{f['name']}")
        return 0
    if args.follow:
        res = api.allocations.fs_stat(args.alloc_id, path)
        offset = max(0, res["size"] - 2048)
        try:
            while True:
                step = api.allocations.fs_stream(args.alloc_id, path,
                                                 offset=offset, wait=2.0)
                if step["data"]:
                    sys.stdout.buffer.write(step["data"])
                    sys.stdout.flush()
                offset = step["offset"]
        except KeyboardInterrupt:
            return 0
    f = api.allocations.fs_stat(args.alloc_id, path)
    if f["is_dir"]:
        for e in api.allocations.fs_ls(args.alloc_id, path):
            print(f"{e['file_mode']}  {e['size']:>10}  {e['mod_time']}"
                  f"  {e['name']}")
    else:
        sys.stdout.buffer.write(
            api.allocations.fs_cat(args.alloc_id, path))
    return 0


def cmd_alloc_stats(args) -> int:
    api = _client(args)
    st = api.allocations.stats(args.alloc_id)
    print(f"Alloc {_short(st['alloc_id'])}")
    for task, ts in (st.get("tasks") or {}).items():
        if ts is None:
            print(f"  {task:<16} (not running)")
            continue
        rss_mb = ts["rss_bytes"] / (1 << 20)
        print(f"  {task:<16} procs={ts['num_procs']} "
              f"rss={rss_mb:.1f}MiB cpu_ticks={ts['cpu_ticks']}")
    return 0


def cmd_node_stats(args) -> int:
    api = _client(args)
    st = api.nodes.stats(args.node_id or "")
    mem = st.get("memory") or {}
    disk = st.get("disk") or {}
    print(f"Uptime      = {st.get('uptime_s', 0):.0f}s")
    if mem:
        print(f"Memory used = {mem.get('used', 0) / (1 << 30):.2f}"
              f"/{mem.get('total', 0) / (1 << 30):.2f} GiB")
    if disk:
        print(f"Disk used   = {disk.get('used', 0) / (1 << 30):.2f}"
              f"/{disk.get('total', 0) / (1 << 30):.2f} GiB "
              f"({disk.get('path', '')})")
    return 0


def cmd_alloc_exec(args) -> int:
    api = _client(args)
    if args.interactive or args.tty:
        return _alloc_exec_interactive(api, args)
    body = {"cmd": args.cmd}
    if args.task:
        body["task"] = args.task
    out, _ix = api.post(
        f"/v1/client/allocation/{args.alloc_id}/exec", body)
    sys.stdout.write(out["output"])
    return out["exit_code"]


def _alloc_exec_interactive(api, args) -> int:
    """`alloc exec -i -t` (reference: command/alloc_exec.go — raw
    local terminal bridged over the agent websocket)."""
    import shutil

    stdin_fd = sys.stdin.fileno() if args.interactive else None
    # raw mode only when we are BOTH allocating a remote pty and
    # streaming local stdin (-t alone is a valid output-only session)
    use_tty = args.tty and stdin_fd is not None and sys.stdin.isatty()
    size = shutil.get_terminal_size((80, 24))
    raw_state = None
    if use_tty:
        import termios
        import tty as _ttymod
        raw_state = termios.tcgetattr(stdin_fd)
        _ttymod.setraw(stdin_fd)
    try:
        return api.allocations.exec_stream(
            args.alloc_id, args.cmd, task=args.task or "",
            tty=args.tty, stdin_fd=stdin_fd,
            stdout_fd=sys.stdout.fileno(),
            tty_size=(size.columns, size.lines) if args.tty else None)
    finally:
        if raw_state is not None:
            import termios
            termios.tcsetattr(stdin_fd, termios.TCSADRAIN, raw_state)


def cmd_job_scale(args) -> int:
    api = _client(args)
    out = api.jobs.scale(args.job_id, args.group, args.count)
    print(f"==> Scaled {args.job_id}/{args.group} to {args.count} "
          f"(eval {_short(out['eval_id'])})")
    return 0


def cmd_alloc_stop(args) -> int:
    api = _client(args)
    resp = api.allocations.stop(args.alloc_id)
    print(f"==> Alloc {_short(args.alloc_id)} stop requested "
          f"(eval {_short(resp['eval_id'])})")
    return 0


# ----------------------------------------------------------------- misc
def cmd_eval_status(args) -> int:
    api = _client(args)
    ev = api.evaluations.info(args.eval_id)
    for k in ("id", "type", "job_id", "status", "triggered_by",
              "priority", "status_description"):
        print(f"{k:<20}= {ev.get(k, '')}")
    return 0


def cmd_volume_status(args) -> int:
    api = _client(args)
    if args.vol_id:
        v, _ = api.get(f"/v1/volume/csi/{args.vol_id}")
        for k in ("id", "name", "plugin_id", "access_mode",
                  "attachment_mode", "schedulable"):
            print(f"{k:<18}= {v.get(k, '')}")
        print(f"{'write_claims':<18}= {len(v.get('write_claims') or {})}")
        print(f"{'read_claims':<18}= {len(v.get('read_claims') or {})}")
        return 0
    vols, _ = api.get("/v1/volumes")
    print(f"{'ID':<20} {'Plugin':<12} {'Mode':<22} Claims")
    for v in vols:
        claims = (len(v.get("write_claims") or {})
                  + len(v.get("read_claims") or {}))
        print(f"{v['id']:<20} {v.get('plugin_id', ''):<12} "
              f"{v.get('access_mode', ''):<22} {claims}")
    return 0


def cmd_volume_register(args) -> int:
    import json as _json
    api = _client(args)
    with open(args.file) as f:
        spec = _json.load(f)
    vol_id = spec.get("id") or ""
    if not vol_id:
        print("volume spec must carry 'id'", file=sys.stderr)
        return 1
    api.request("PUT", f"/v1/volume/csi/{vol_id}", body={"volume": spec})
    print(f"==> Volume '{vol_id}' registered")
    return 0


def cmd_volume_deregister(args) -> int:
    api = _client(args)
    api.delete(f"/v1/volume/csi/{args.vol_id}")
    print(f"==> Volume '{args.vol_id}' deregistered")
    return 0


def cmd_volume_plugin_register(args) -> int:
    api = _client(args)
    host, _, port = args.addr.rpartition(":")
    api.request("PUT", f"/v1/client/csi/plugin/{args.name}",
                body={"addr": [host or "127.0.0.1", int(port)]})
    print(f"==> CSI plugin '{args.name}' registered at {args.addr}")
    return 0


def cmd_deployment(args) -> int:
    api = _client(args)
    if args.dep_cmd == "list":
        deps, _ = api.deployments.list()
        print(_fmt_table(
            [[_short(d["id"]), d["job_id"], d["status"]] for d in deps],
            ["ID", "Job ID", "Status"]))
    elif args.dep_cmd == "status":
        d = api.deployments.info(args.dep_id)
        print(json.dumps(d, indent=2))
    elif args.dep_cmd == "promote":
        resp = api.deployments.promote(args.dep_id)
        print(f"==> Deployment promoted (eval {_short(resp['eval_id'])})")
    elif args.dep_cmd == "fail":
        resp = api.deployments.fail(args.dep_id)
        print(f"==> Deployment failed (eval {_short(resp['eval_id'])})")
    return 0


def cmd_system_gc(args) -> int:
    _client(args).system.gc()
    print("==> GC forced")
    return 0


def cmd_status(args) -> int:
    api = _client(args)
    self_ = api.agent.self_()
    print(f"Agent: server workers={self_['server']['workers']}"
          + (f", client node={_short(self_['client']['node_id'])}"
             if self_.get("client") else ""))
    jobs, _ = api.jobs.list()
    nodes, _ = api.nodes.list()
    print(f"Jobs: {len(jobs)}  Nodes: {len(nodes)}")
    return 0


def cmd_metrics(args) -> int:
    print(json.dumps(_client(args).agent.metrics(), indent=2))
    return 0


# ----------------------------------------------------------------- main
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu",
                                description="cluster scheduler (PyTorch/CUDA)")
    p.add_argument("-address", default=None,
                   help="agent HTTP address (or NOMAD_ADDR)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent", help="run an agent")
    ag.add_argument("-dev", action="store_true")
    ag.add_argument("-config", default=None,
                    help="agent config file (HCL or JSON)")
    ag.add_argument("-bind", default=None)
    ag.add_argument("-port", type=int, default=None)
    ag.add_argument("-data-dir", dest="data_dir", default=None)
    ag.add_argument("-workers", type=int, default=None)
    ag.add_argument("-server-only", dest="server_only",
                    action="store_true")
    ag.add_argument("-acl-enabled", dest="acl_enabled",
                    action="store_true",
                    help="enforce ACLs on the HTTP API")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="job_cmd", required=True)
    jr = job.add_parser("run")
    jr.add_argument("file")
    jr.add_argument("-detach", action="store_true")
    jr.add_argument("-check-index", dest="check_index", type=int,
                    default=None)
    jr.set_defaults(fn=cmd_job_run)
    js = job.add_parser("status")
    js.add_argument("job_id", nargs="?")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.add_argument("-detach", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    jp = job.add_parser("plan")
    jp.add_argument("file")
    jp.set_defaults(fn=cmd_job_plan)
    jd = job.add_parser("dispatch", help="instantiate a parameterized "
                                         "job")
    jd.add_argument("job_id")
    jd.add_argument("-meta", action="append", default=[],
                    help="key=value dispatch meta (repeatable)")
    jd.add_argument("-payload-file", dest="payload_file", default=None,
                    help="file whose contents become the payload")
    jd.set_defaults(fn=cmd_job_dispatch)
    jrv = job.add_parser("revert", help="revert to a prior version")
    jrv.add_argument("job_id")
    jrv.add_argument("version", type=int)
    jrv.set_defaults(fn=cmd_job_revert)
    jh = job.add_parser("history", help="list retained versions")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    jpf = job.add_parser("periodic-force")
    jpf.add_argument("job_id")
    jpf.set_defaults(fn=cmd_job_periodic_force)

    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="node_cmd", required=True)
    ns = node.add_parser("status")
    ns.add_argument("node_id", nargs="?")
    ns.set_defaults(fn=cmd_node_status)
    nd = node.add_parser("drain")
    nd.add_argument("node_id")
    grp = nd.add_mutually_exclusive_group(required=True)
    grp.add_argument("-enable", action="store_true")
    grp.add_argument("-disable", dest="enable", action="store_false")
    nd.add_argument("-deadline", default="1h")
    nd.add_argument("-ignore-system", dest="ignore_system",
                    action="store_true")
    nd.set_defaults(fn=cmd_node_drain)
    nst = node.add_parser("stats", help="host resource gauges")
    nst.add_argument("node_id", nargs="?", default=None)
    nst.set_defaults(fn=cmd_node_stats)
    ne = node.add_parser("eligibility")
    ne.add_argument("node_id")
    grp = ne.add_mutually_exclusive_group(required=True)
    grp.add_argument("-enable", action="store_true")
    grp.add_argument("-disable", dest="enable", action="store_false")
    ne.set_defaults(fn=cmd_node_eligibility)

    jsc = job.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.set_defaults(fn=cmd_job_scale)

    alloc = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="alloc_cmd", required=True)
    as_ = alloc.add_parser("status")
    as_.add_argument("alloc_id")
    as_.set_defaults(fn=cmd_alloc_status)
    ast = alloc.add_parser("stop")
    ast.add_argument("alloc_id")
    ast.set_defaults(fn=cmd_alloc_stop)
    ax = alloc.add_parser("exec")
    ax.add_argument("alloc_id")
    ax.add_argument("-task", default=None)
    ax.add_argument("-i", dest="interactive", action="store_true",
                    help="stream local stdin to the task")
    ax.add_argument("-t", dest="tty", action="store_true",
                    help="allocate a pseudo-terminal")
    # REMAINDER: everything after the alloc id (incl. dash flags like
    # `/bin/sh -c ...`) belongs to the command
    ax.add_argument("cmd", nargs=argparse.REMAINDER)
    ax.set_defaults(fn=cmd_alloc_exec)
    al = alloc.add_parser("logs")
    al.add_argument("alloc_id")
    al.add_argument("-task", default=None)
    al.add_argument("-stderr", action="store_true")
    al.add_argument("-tail", type=int, default=None)
    al.set_defaults(fn=cmd_alloc_logs)
    af = alloc.add_parser("fs", help="inspect the allocation directory")
    af.add_argument("alloc_id")
    af.add_argument("path", nargs="?", default="/")
    af.add_argument("-stat", action="store_true",
                    help="print metadata instead of contents")
    af.add_argument("-f", dest="follow", action="store_true",
                    help="follow a growing file")
    af.set_defaults(fn=cmd_alloc_fs)
    asx = alloc.add_parser("stats", help="task resource usage")
    asx.add_argument("alloc_id")
    asx.set_defaults(fn=cmd_alloc_stats)

    ev = sub.add_parser("eval", help="eval commands").add_subparsers(
        dest="eval_cmd", required=True)
    es = ev.add_parser("status")
    es.add_argument("eval_id")
    es.set_defaults(fn=cmd_eval_status)

    vol = sub.add_parser("volume", help="volume commands").add_subparsers(
        dest="volume_cmd", required=True)
    vs = vol.add_parser("status")
    vs.add_argument("vol_id", nargs="?", default=None)
    vs.set_defaults(fn=cmd_volume_status)
    vr = vol.add_parser("register")
    vr.add_argument("file", help="JSON volume spec "
                                 "(id, plugin_id, access_mode, ...)")
    vr.set_defaults(fn=cmd_volume_register)
    vd = vol.add_parser("deregister")
    vd.add_argument("vol_id")
    vd.set_defaults(fn=cmd_volume_deregister)
    vp = vol.add_parser("plugin-register",
                        help="register a CSI plugin endpoint with the "
                             "local agent")
    vp.add_argument("name")
    vp.add_argument("addr", help="host:port of the plugin's RPC listener")
    vp.set_defaults(fn=cmd_volume_plugin_register)

    dep = sub.add_parser("deployment", help="deployment commands")
    dep.add_argument("dep_cmd",
                     choices=["list", "status", "promote", "fail"])
    dep.add_argument("dep_id", nargs="?")
    dep.set_defaults(fn=cmd_deployment)

    sysgc = sub.add_parser("system")
    sysgc.add_argument("system_cmd", choices=["gc"])
    sysgc.set_defaults(fn=cmd_system_gc)

    st = sub.add_parser("status", help="cluster overview")
    st.set_defaults(fn=cmd_status)

    mt = sub.add_parser("metrics", help="dump agent metrics")
    mt.set_defaults(fn=cmd_metrics)

    mon = sub.add_parser("monitor", help="stream agent logs")
    mon.add_argument("-log-level", dest="log_level", default="info")
    mon.add_argument("-node-id", dest="node_id", default="")
    mon.add_argument("-duration", dest="duration", default="",
                     help="stop after N seconds (default: follow)")
    mon.set_defaults(fn=cmd_monitor)

    tls = sub.add_parser("tls", help="mint cluster TLS material"
                         ).add_subparsers(dest="tls_cmd", required=True)
    tca = tls.add_parser("ca", help="create a cluster CA")
    tca.add_argument("create", choices=["create"])
    tca.add_argument("-d", dest="dir", default=".")
    tca.set_defaults(fn=cmd_tls_ca)
    tcr = tls.add_parser("cert", help="create a CA-signed role cert")
    tcr.add_argument("create", choices=["create"])
    tcr.add_argument("-role", default="server.global.nomad",
                     help="server.<region>.nomad / client.<region>."
                          "nomad / cli.<region>.nomad")
    tcr.add_argument("-d", dest="dir", default=".")
    tcr.add_argument("-additional-dns", action="append", default=[])
    tcr.add_argument("-additional-ip", action="append", default=[])
    tcr.set_defaults(fn=cmd_tls_cert)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except APIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # stdout closed early (e.g. `| head`); exit quietly like the
        # reference CLI
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
