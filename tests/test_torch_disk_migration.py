"""The port's ephemeral-disk migration (`Client.migrate_prev_alloc_dir`,
the migrate-token check of the fs routes) against the JAX package's, on
the CPU.

The four cases of `tests/test_disk_migration.py` run on both packages
(`pkg` = "ref" / "port"), each with its own `Server` (the port's on
`device="cpu"`), agents and HTTP agents: a drain that moves a
`migrate = true` group to another node with its data, a same-node copy,
the token's HMAC, and the token's reach under ACLs.  Two more cases hold
the migration's checks on a remote agent's answers, against a fake agent
that answers the two fs routes the migration reads: a listing entry
named `../x` is refused and nothing is written outside the destination,
and reads shorter than asked (partial chunks) do not end the file early.
The port's outcome must equal the reference's.  Every agent is shut down
with `halt_tasks=True` and every server stopped in `finally`.
"""
import base64
import copy
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

from tests.test_torch_drivers import PKG_NAMES, Agents, Outcomes

BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)


def migrate_job(P, job_id="diskjob"):
    job = P.mock.job()
    job.id = job_id
    job.name = job_id
    tg = job.task_groups[0]
    tg.count = 1
    tg.ephemeral_disk.migrate = True
    tg.ephemeral_disk.sticky = True
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": [
        "-c", "if [ ! -f $NOMAD_ALLOC_DIR/data/state.txt ]; then "
              "echo precious-$$ > $NOMAD_ALLOC_DIR/data/state.txt; fi; "
              "sleep 300"]}
    task.resources.networks = []
    return job


def running_alloc(P, server, job_id):
    for a in server.store.allocs_by_job("default", job_id):
        if a.client_status == P.structs.ALLOC_CLIENT_RUNNING \
                and not a.server_terminal_status():
            return a
    return None


def case_drain_migrates_ephemeral_disk_across_nodes(P, tmp):
    with Agents(P, tmp, 2, http=True) as ag:
        server, (c1, c2) = ag.server, ag.clients
        job = migrate_job(P)
        # pin the first placement to node 1
        job.constraints = [P.structs.Constraint("${node.unique.id}",
                                                c2.node.id, "!=")]
        server.register_job(job)
        assert P.wait_until(lambda: running_alloc(P, server, job.id)
                            is not None, timeout=60)
        first = running_alloc(P, server, job.id)
        state_path = os.path.join(c1.get_alloc_runner(first.id)
                                  .alloc_dir.shared, "data", "state.txt")
        assert P.wait_until(lambda: os.path.exists(state_path), timeout=30)
        content = open(state_path).read()
        # retarget to node 2 (the constraint flip forces a migration off
        # node 1) and drain node 1
        job2 = migrate_job(P)
        job2.constraints = [P.structs.Constraint("${node.unique.id}",
                                                 c1.node.id, "!=")]
        server.register_job(job2)
        server.update_node_drain(c1.node.id,
                                 P.structs.DrainStrategy(deadline_s=60),
                                 mark_eligible=False)

        def replacement():
            a = running_alloc(P, server, job.id)
            return a if a is not None and a.node_id == c2.node.id else None
        assert P.wait_until(lambda: replacement() is not None, timeout=60)
        repl = replacement()
        new_state = os.path.join(c2.get_alloc_runner(repl.id)
                                 .alloc_dir.shared, "data", "state.txt")
        arrived = P.wait_until(lambda: os.path.exists(new_state),
                               timeout=30)
        # the MIGRATED content, not a freshly written one: the task only
        # writes the file when absent, and the pids differ anyway
        return {"first_on_node1": first.node_id == c1.node.id,
                "precious": content.startswith("precious-"),
                "linked": repl.previous_allocation == first.id,
                "arrived": arrived,
                "same_content": open(new_state).read() == content}


def case_local_migration_copies_data(P, tmp):
    """Same-node replacement: the data dir is copied locally."""
    with Agents(P, tmp, 1, num_workers=1) as ag:
        server, c = ag.server, ag.clients[0]
        job = migrate_job(P, "localdisk")
        server.register_job(job)
        assert P.wait_until(lambda: running_alloc(P, server, job.id)
                            is not None, timeout=60)
        first = running_alloc(P, server, job.id)
        src = os.path.join(c.get_alloc_runner(first.id).alloc_dir.shared,
                           "data", "state.txt")
        assert P.wait_until(lambda: os.path.exists(src), timeout=30)
        content = open(src).read()
        # the watcher path directly: a replacement alloc on the same node
        # pulling from the (stopped) predecessor
        repl = copy.deepcopy(first)
        repl.id = "replacement-alloc"
        repl.previous_allocation = first.id
        dest = P.AllocDir(c.data_dir, repl.id)
        dest.build()
        # wait-for-terminal is part of the contract: mark prev stopped
        first_upd = copy.copy(first)
        first_upd.desired_status = P.structs.ALLOC_DESIRED_STOP
        first_upd.client_status = P.structs.ALLOC_CLIENT_COMPLETE
        server.update_allocs_from_client([first_upd])
        c.migrate_prev_alloc_dir(repl, dest, timeout_s=10)
        migrated = os.path.join(dest.shared, "data", "state.txt")
        return [os.path.exists(migrated),
                open(migrated).read() == content]


def case_migrate_token_roundtrip(P, tmp):
    gen, cmp = (P.funcs.generate_migrate_token,
                P.funcs.compare_migrate_token)
    tok = gen("alloc-1", "node-secret")
    return [tok, cmp("alloc-1", "node-secret", tok),
            cmp("alloc-2", "node-secret", tok),
            cmp("alloc-1", "other-secret", tok),
            cmp("alloc-1", "node-secret", "")]


def case_migrate_token_grants_fs_read_only_for_that_alloc(P, tmp):
    """With ACLs on, a migrate token reads exactly its alloc's fs — no
    other alloc, no other route."""
    with Agents(P, tmp, 1, http=True, acl_enabled=True) as ag:
        server, http = ag.server, ag.https[0]
        job = migrate_job(P, "acldisk")
        server.register_job(job)
        assert P.wait_until(lambda: running_alloc(P, server, job.id)
                            is not None, timeout=60)
        alloc = running_alloc(P, server, job.id)
        src = server.alloc_migrate_source(alloc.id)
        api = P.ApiClient(address=http.address, token=src["migrate_token"])
        listing, _ = api.request("GET", f"/v1/client/fs/ls/{alloc.id}",
                                 params={"path": "alloc"})
        out = {"keys": sorted(src), "terminal": src["terminal"],
               "addr": src["addr"] == http.address.split("//")[1],
               "listing": sorted(e["name"] for e in listing["files"])}
        # the token is not a general ACL token
        with pytest.raises(P.APIError) as ei:
            api.get("/v1/jobs")
        out["jobs"] = (ei.value.code, ei.value.msg)
        # and it does not open other allocs (the other id fails the hmac
        # compare and falls through to token resolution)
        with pytest.raises(P.APIError) as ei2:
            api.request("GET", "/v1/client/fs/ls/ffffffff",
                        params={"path": "alloc"})
        out["other"] = (ei2.value.code, ei2.value.msg)
        return out


# --------------------------------------- a remote agent's fs answers
class FakeAgent:
    """Answers `/v1/client/fs/ls/:id` and `/v1/client/fs/readat/:id` for a
    migration's walk from a table: `listing` maps a path to its entries,
    `files` a path to its bytes; a read returns at most `chunk` bytes
    whatever the limit asked (a partial chunk, as a loaded agent may)."""

    def __init__(self, listing, files, chunk):
        outer = self
        self.reads = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if "/fs/ls/" in url.path:
                    body = {"files": listing.get(q["path"], [])}
                else:
                    outer.reads += 1
                    data = files[q["path"]]
                    off = int(q["offset"])
                    n = min(int(q["limit"]), chunk)
                    body = {"data": base64.b64encode(
                        data[off:off + n]).decode()}
                raw = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = "%s:%d" % self.httpd.server_address[:2]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def entry(name, is_dir=False):
    return {"name": name, "is_dir": is_dir}


def remote_fetch(P, tmp, listing, files, chunk):
    """Run the migration's remote walk against a fake agent; returns
    (the error it raised or None, the fake agent)."""
    fake = FakeAgent(listing, files, chunk)
    client = P.Client(P.agent.ServerEndpoints(), data_dir=str(tmp / "node"),
                      dev_mode=True)
    dest = tmp / "dest" / "data"
    os.makedirs(dest)
    try:
        client._fetch_remote_alloc_data(fake.addr, "prev-alloc", "tok",
                                        str(dest))
        err = None
    except RuntimeError as e:
        err = str(e).replace(fake.addr, "<addr>")
    finally:
        fake.close()
        client.state_db.close()
    return err, fake


def case_remote_listing_unsafe_name_refused(P, tmp):
    listing = {"alloc/data": [entry("ok.txt"), entry("../x")]}
    files = {"alloc/data/ok.txt": b"fine", "alloc/data/../x": b"escaped"}
    err, _ = remote_fetch(P, tmp, listing, files, chunk=1 << 20)
    return [err, os.path.exists(tmp / "dest" / "x"),
            sorted(os.listdir(tmp / "dest"))]


def case_remote_short_reads_do_not_truncate(P, tmp):
    body = bytes(range(256)) * 40 + b"tail"       # 10,244 bytes
    listing = {"alloc/data": [entry("blob"), entry("sub", is_dir=True)],
               "alloc/data/sub": [entry("small")]}
    files = {"alloc/data/blob": body, "alloc/data/sub/small": b"abc"}
    err, fake = remote_fetch(P, tmp, listing, files, chunk=1000)
    dest = tmp / "dest" / "data"
    return {"err": err, "blob": (dest / "blob").read_bytes() == body,
            "small": (dest / "sub" / "small").read_bytes(),
            # 11 chunks and the empty read for the blob, 1 + 1 for small
            "reads": fake.reads}


OUTCOMES = Outcomes({
    "drain_migrates_ephemeral_disk_across_nodes":
        case_drain_migrates_ephemeral_disk_across_nodes,
    "local_migration_copies_data": case_local_migration_copies_data,
    "migrate_token_roundtrip": case_migrate_token_roundtrip,
    "migrate_token_grants_fs_read_only_for_that_alloc":
        case_migrate_token_grants_fs_read_only_for_that_alloc,
    "remote_listing_unsafe_name_refused":
        case_remote_listing_unsafe_name_refused,
    "remote_short_reads_do_not_truncate":
        case_remote_short_reads_do_not_truncate,
})


@BOTH
def test_drain_migrates_ephemeral_disk_across_nodes(pkg, tmp_path_factory):
    out = OUTCOMES.check("drain_migrates_ephemeral_disk_across_nodes", pkg,
                         tmp_path_factory)
    assert all(out.values()), out


@BOTH
def test_local_migration_copies_data(pkg, tmp_path_factory):
    assert OUTCOMES.check("local_migration_copies_data", pkg,
                          tmp_path_factory) == [True, True]


@BOTH
def test_migrate_token_roundtrip(pkg, tmp_path_factory):
    tok, *checks = OUTCOMES.check("migrate_token_roundtrip", pkg,
                                  tmp_path_factory)
    assert tok and checks == [True, False, False, False]


@BOTH
def test_migrate_token_grants_fs_read_only_for_that_alloc(pkg,
                                                          tmp_path_factory):
    out = OUTCOMES.check("migrate_token_grants_fs_read_only_for_that_alloc",
                         pkg, tmp_path_factory)
    assert "data" in out["listing"] and out["addr"]
    assert out["jobs"][0] == 403
    assert out["other"][0] in (403, 404)


@BOTH
def test_remote_listing_unsafe_name_refused(pkg, tmp_path_factory):
    err, escaped, dest = OUTCOMES.check("remote_listing_unsafe_name_refused",
                                        pkg, tmp_path_factory)
    assert err == ("ephemeral disk migration from <addr> failed: remote fs "
                   "listing returned unsafe entry name '../x'")
    assert not escaped and dest == ["data"]


@BOTH
def test_remote_short_reads_do_not_truncate(pkg, tmp_path_factory):
    out = OUTCOMES.check("remote_short_reads_do_not_truncate", pkg,
                         tmp_path_factory)
    assert out == {"err": None, "blob": True, "small": b"abc", "reads": 14}
