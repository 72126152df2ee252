"""The port's wire RPC (`nomad_tpu_torch.rpc`) against the JAX package's.

Frames are byte for byte the reference's, and either package's client
talks to the other's server with equal results and typed errors.  The
port's three-server TCP cluster elects, forwards a job registered at a
follower to the leader, fails over when the leader dies and keeps every
live store equal; the wire blocking query wakes on a placement; a
one-server cluster of each package places the same jobs on the same
nodes.  The frame fault: a follower that falls behind by more than a
frame's worth of entries never catches up on the reference's
replication and catches up on the port's, which cuts each AppendEntries
to the frame.  Ports are ephemeral, every wait is bounded (20-30 s, no
assertion on elapsed time), raft runs at `serve_cluster`'s default
timeouts, and every server, RPC server and client is stopped in
`finally`."""
import socket
import threading
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.rpc import endpoints as ref_endpoints
from nomad_tpu.rpc import wire as ref_wire
from nomad_tpu.rpc.client import RpcClient as RefRpcClient
from nomad_tpu.rpc.client import RpcError as RefRpcError
from nomad_tpu.rpc.server import RpcHandlerError as RefHandlerError
from nomad_tpu.rpc.server import RpcServer as RefRpcServer
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.rpc import endpoints as port_endpoints
from nomad_tpu_torch.rpc import wire as port_wire
from nomad_tpu_torch.rpc.client import RpcClient, RpcError
from nomad_tpu_torch.rpc.server import RpcHandlerError, RpcServer

WAIT_S = 30.0

PKGS = {
    "ref": {"mock": ref_mock, "endpoints": ref_endpoints,
            "wire": ref_wire, "server_kwargs": {}},
    "port": {"mock": port_mock, "endpoints": port_endpoints,
             "wire": port_wire, "server_kwargs": {"device": "cpu"}},
}


def wait_until(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def stop_cluster(servers, rpcs):
    for s, r in zip(servers, rpcs):
        try:
            s.stop()
        finally:
            r.rpc.stop()


def leader_of(servers):
    return next((s for s in servers if s.is_leader()), None)


# ------------------------------------------------------------- wire
FRAMES = [
    {"id": 1, "method": "X.Y", "params": [1, "two", {"k": [3]}]},
    {"id": 7, "result": None},
    {"id": 2, "error": {"kind": "not_leader", "message": "no known leader",
                        "data": {"leader": "s2"}}},
    {"id": 3, "method": "Job.Register",
     "params": [{"unicode": "région ✓", "f": 0.1, "big": 2 ** 40,
                 "nested": [[], {}, [True, False, None]]}]},
]


def frame_bytes(wire, msg):
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("msg", FRAMES, ids=["request", "result", "error",
                                             "unicode"])
def test_frames_byte_identical(msg):
    """The same message frames to the same bytes in both packages, and
    each package reads the other's frame back."""
    ref, port = frame_bytes(ref_wire, msg), frame_bytes(port_wire, msg)
    assert port == ref
    assert port_wire.MAX_FRAME == ref_wire.MAX_FRAME
    for writer, reader in ((ref_wire, port_wire), (port_wire, ref_wire)):
        a, b = socket.socketpair()
        try:
            writer.send_frame(a, msg)
            assert reader.recv_frame(b) == msg
        finally:
            a.close()
            b.close()


# ------------------------------------------------------ client/server
def echo_server(Server, HandlerError):
    srv = Server()
    srv.register("Echo.Upper", lambda p: p[0].upper())

    def boom(_p):
        raise HandlerError("teapot", "short and stout", {"n": 1})
    srv.register("Echo.Boom", boom)
    srv.register("Echo.Crash", lambda p: 1 / 0)
    srv.start()
    return srv


def call_all(client, Error):
    out = [client.call("Echo.Upper", ["hi"])]
    for method in ("Echo.Boom", "Echo.Crash", "No.Such"):
        with pytest.raises(Error) as ei:
            client.call(method, [])
        out.append((ei.value.kind, ei.value.message, ei.value.data))
    out.append(client.call("Echo.Upper", ["again"]))   # a pooled socket
    return out


@pytest.mark.parametrize("direction", ["port_client_ref_server",
                                       "ref_client_port_server"])
def test_cross_package_calls_and_typed_errors(direction):
    """A port client against a reference server and the reverse give the
    results and typed errors (kind, message, data) that each package's
    own client gets from its own server."""
    ref_srv = echo_server(RefRpcServer, RefHandlerError)
    port_srv = echo_server(RpcServer, RpcHandlerError)
    clients = []
    try:
        def client(Cls, srv):
            c = Cls(srv.addr)
            clients.append(c)
            return c
        want = call_all(client(RefRpcClient, ref_srv), RefRpcError)
        assert call_all(client(RpcClient, port_srv), RpcError) == want
        if direction == "port_client_ref_server":
            got = call_all(client(RpcClient, ref_srv), RpcError)
        else:
            got = call_all(client(RefRpcClient, port_srv), RefRpcError)
        assert got == want
        assert want[0] == "HI" and want[1][0] == "teapot"
        assert [k for k, _m, _d in want[1:4]] == ["teapot", "internal",
                                                  "unknown_method"]
    finally:
        for c in clients:
            c.close()
        ref_srv.stop()
        port_srv.stop()


def test_oversized_request_is_the_callers_error():
    """A request over the frame limit is refused before a byte is sent,
    as a ValueError that is not retried (a transport fault would be)."""
    srv = echo_server(RpcServer, RpcHandlerError)
    c = RpcClient(srv.addr)
    try:
        with pytest.raises(ValueError, match="frame too large"):
            c.call("Echo.Upper", ["x" * (port_wire.MAX_FRAME + 1)])
        assert c.call("Echo.Upper", ["ok"]) == "OK"
    finally:
        c.close()
        srv.stop()


# ------------------------------------------------- TCP raft cluster
def cluster_job(mock, job_id, count):
    j = mock.job(id=job_id)
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources.networks = []
    return j


def cluster_nodes(mock, n):
    nodes = []
    for i in range(n):
        node = mock.node(id=f"node-{i:03d}", name=f"node-{i}")
        node.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        node.compute_class()
        nodes.append(node)
    return nodes


def live_state(s):
    """What a replica holds: jobs, and allocs by id, node and status."""
    return (sorted(j.id for j in s.store.jobs()),
            sorted((a.id, a.node_id, a.client_status)
                   for a in s.store.allocs()))


def eval_complete(s, eval_id):
    ev = s.store.eval_by_id(eval_id)
    return ev is not None and ev.status == port_structs.EVAL_STATUS_COMPLETE


def test_tcp_cluster_election_forwarding_failover():
    """Three port servers over TCP: a leader is elected; nodes and a job
    registered through a follower's RPC are forwarded to it and placed;
    every replica's store equals the leader's; the leader dies, one of
    the two others takes over, a job sent through the server list (dead
    server first) fails over and is placed, and the two live stores
    agree."""
    servers, rpcs, _addrs = port_endpoints.serve_cluster(
        3, server_kwargs={"device": "cpu",
                          # the nodes here have no agent to heartbeat
                          "min_heartbeat_ttl_s": 300.0})
    endpoints = []
    try:
        assert wait_until(lambda: leader_of(servers) is not None)
        leader = leader_of(servers)
        li = servers.index(leader)
        follower = (li + 1) % 3
        ep_f = port_endpoints.RpcServerEndpoints([rpcs[follower].rpc.addr])
        endpoints.append(ep_f)
        for n in cluster_nodes(port_mock, 4):
            ep_f.register_node(n)
        ev = ep_f.register_job(cluster_job(port_mock, "job-a", 2))
        assert ev is not None and ev["job_id"] == "job-a"
        assert wait_until(lambda: eval_complete(leader, ev["id"]))
        assert len(leader.store.allocs_by_job("default", "job-a")) == 2
        assert wait_until(lambda: all(live_state(s) == live_state(leader)
                                      for s in servers))

        servers[li].stop()
        rpcs[li].rpc.stop()
        rest = [s for i, s in enumerate(servers) if i != li]
        assert wait_until(lambda: leader_of(rest) is not None)
        # the dead server heads the list: the endpoints fail over
        order = [li] + [i for i in range(3) if i != li]
        ep = port_endpoints.RpcServerEndpoints(
            [rpcs[i].rpc.addr for i in order])
        endpoints.append(ep)
        ev2 = ep.register_job(cluster_job(port_mock, "job-b", 2))
        assert wait_until(lambda: any(eval_complete(s, ev2["id"])
                                      for s in rest))
        assert wait_until(lambda: all(
            len(s.store.allocs_by_job("default", "job-b")) == 2
            for s in rest))
        assert wait_until(lambda: live_state(rest[0]) == live_state(rest[1]))
    finally:
        for e in endpoints:
            e.close()
        stop_cluster(servers, rpcs)


def test_wire_blocking_query_fires_on_new_alloc():
    """`Node.GetClientAllocs` long-polls over the wire and wakes on the
    node's first placement."""
    servers, rpcs, _addrs = port_endpoints.serve_cluster(
        1, server_kwargs={"device": "cpu"})
    endpoints = []
    try:
        srv = servers[0]
        assert wait_until(srv.is_leader)
        ep = port_endpoints.RpcServerEndpoints([rpcs[0].rpc.addr])
        endpoints.append(ep)
        node = cluster_nodes(port_mock, 1)[0]
        ep.register_node(node)
        ttl = ep.node_heartbeat(node.id)
        assert ttl and ttl > 0
        got = {}

        def poll():
            got["out"] = ep.get_client_allocs(node.id, 0, 45.0)
        t = threading.Thread(target=poll)
        t.start()
        job = cluster_job(port_mock, "job-poll", 1)
        ep.register_job(job)
        t.join(timeout=60)
        assert not t.is_alive()
        allocs, index = got["out"]
        assert index > 0
        assert [a.job_id for a in allocs] == [job.id]
        assert all(isinstance(a, port_structs.Allocation) for a in allocs)
    finally:
        for e in endpoints:
            e.close()
        stop_cluster(servers, rpcs)


def test_one_server_clusters_place_alike():
    """The same nodes and jobs, entered over the wire into a one-server
    cluster of each package (one job after the previous eval completed):
    the same placements, by alloc name and node index."""
    out, endpoints = {}, []
    for pkg, p in PKGS.items():
        mock = p["mock"]
        servers, rpcs, _addrs = p["endpoints"].serve_cluster(
            1, num_workers=1, server_kwargs=p["server_kwargs"])
        try:
            srv = servers[0]
            assert wait_until(srv.is_leader), pkg
            ep = p["endpoints"].RpcServerEndpoints([rpcs[0].rpc.addr])
            endpoints.append(ep)
            nodes = cluster_nodes(mock, 6)
            for n in nodes:
                ep.register_node(n)
            ids = [n.id for n in nodes]
            placed = {}
            for k, count in enumerate((3, 2, 4)):
                job = cluster_job(mock, f"job-{k}", count)
                ev = ep.register_job(job)
                assert wait_until(lambda: srv.store.eval_by_id(ev["id"])
                                  .status == "complete"), pkg
                placed[job.id] = sorted(
                    (a.name, ids.index(a.node_id))
                    for a in srv.store.allocs_by_job("default", job.id))
            out[pkg] = placed
        finally:
            for e in endpoints:
                # the reference's RpcServerEndpoints has no close()
                for c in e._clients:
                    c.close()
            stop_cluster(servers, rpcs)
    assert out["port"] == out["ref"]
    assert [len(v) for v in out["port"].values()] == [3, 2, 4]


def test_serve_cluster_defaults_to_cuda(monkeypatch):
    """A `serve_cluster` server solves on `cuda` unless the caller names
    a device; without a GPU its solver raises instead of falling back."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    servers, rpcs, _addrs = port_endpoints.serve_cluster(1)
    try:
        assert servers[0].device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            servers[0].workers[0].fleet_solver()
    finally:
        stop_cluster(servers, rpcs)


# ------------------------------------------------------- frame fault
#: a frame limit small enough for a test: each entry stays well under
#: it, eight of them do not
TEST_FRAME = 256 * 1024
BLOB_BYTES = 60_000
N_BLOBS = 8


def follower_catches_up(pkg, monkeypatch, wait_s):
    """A three-server TCP cluster of `pkg` with the frame limit patched
    down: one follower paused (the leader cannot reach it and its
    election timer is held), N_BLOBS entries of BLOB_BYTES committed by
    the other two, then the follower resumed.  Returns whether it holds
    the last entry within `wait_s`."""
    p = PKGS[pkg]
    monkeypatch.setattr(p["wire"], "MAX_FRAME", TEST_FRAME)
    servers, rpcs, _addrs = p["endpoints"].serve_cluster(
        3, num_workers=0, server_kwargs=p["server_kwargs"])
    try:
        assert wait_until(lambda: leader_of(servers) is not None), pkg
        leader = leader_of(servers)
        victim = next(s for s in servers if s is not leader)
        vid = victim.raft.id
        timeouts = victim.raft.cfg.election_timeout_s
        paused = threading.Event()
        paused.set()
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = (3600.0, 3600.0)
            victim.raft._reset_election_deadline_locked()
        transport = leader.raft.transport
        real_call = transport.call

        def call(target, method, *args):
            if target == vid and paused.is_set():
                raise ConnectionError(f"peer {target} paused")
            return real_call(target, method, *args)
        transport.call = call
        for i in range(N_BLOBS):
            leader.upsert_secret("default", f"blob/{i}",
                                 {"v": f"{i}" * BLOB_BYTES})
        # every entry alone fits a frame; together they do not
        entries = leader.raft.log.slice_from(1)
        blobs = [e for e in entries if e.etype == "secret_upsert"]
        assert len(blobs) == N_BLOBS
        import json
        sizes = [len(json.dumps([e.index, e.term, e.etype, e.payload],
                                separators=(",", ":")))
                 for e in blobs]
        assert max(sizes) < TEST_FRAME // 2 and sum(sizes) > TEST_FRAME
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = timeouts
            victim.raft._deadline = time.monotonic() + 2.0
        transport._backoff.pop(vid, None)
        paused.clear()
        last = f"blob/{N_BLOBS - 1}"
        return wait_until(lambda: victim.store.secret_by_path(
            "default", last) is not None, timeout=wait_s)
    finally:
        stop_cluster(servers, rpcs)


def test_frame_fault_port_follower_catches_up(monkeypatch):
    """The port cuts each AppendEntries to the frame: the follower
    catches up."""
    assert follower_catches_up("port", monkeypatch, WAIT_S)


def test_frame_fault_reference_follower_never_catches_up(monkeypatch):
    """The reference ships up to 512 entries in one frame whatever their
    size: the frame is refused, replication retries without end, and
    the follower stays behind (the fault the port repairs; the JAX
    package stays as it is)."""
    assert not follower_catches_up("ref", monkeypatch, 6.0)


# ---------------------------------------------------- snapshot fault
def follower_catches_up_by_snapshot(pkg, monkeypatch, wait_s):
    """`follower_catches_up` behind a compaction: once the blobs are
    applied everywhere, the leader and the other follower compact their
    logs at the same index (so no member but the paused one is behind
    the snapshot point), and the resumed follower can catch up only by
    an InstallSnapshot of a snapshot larger than the (patched) frame.
    Returns whether it catches up within `wait_s`, and the encoded bytes
    of each InstallSnapshot request the leader sent it."""
    import json
    p = PKGS[pkg]
    monkeypatch.setattr(p["wire"], "MAX_FRAME", TEST_FRAME)
    servers, rpcs, _addrs = p["endpoints"].serve_cluster(
        3, num_workers=0, server_kwargs=p["server_kwargs"])
    try:
        assert wait_until(lambda: leader_of(servers) is not None), pkg
        leader = leader_of(servers)
        victim = next(s for s in servers if s is not leader)
        other = next(s for s in servers if s not in (leader, victim))
        vid = victim.raft.id
        timeouts = victim.raft.cfg.election_timeout_s
        paused = threading.Event()
        paused.set()
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = (3600.0, 3600.0)
            victim.raft._reset_election_deadline_locked()
        transport = leader.raft.transport
        real_call = transport.call
        frames = []

        def call(target, method, *args):
            if target == vid and paused.is_set():
                raise ConnectionError(f"peer {target} paused")
            if target == vid and method == "rpc_install_snapshot":
                params = [{"__b64__": "x" * (4 * ((len(a) + 2) // 3))}
                          if isinstance(a, bytes) else a for a in args]
                frames.append(len(json.dumps(params,
                                             separators=(",", ":"))))
            return real_call(target, method, *args)
        transport.call = call
        for i in range(N_BLOBS):
            leader.upsert_secret("default", f"blob/{i}",
                                 {"v": f"{i}" * BLOB_BYTES})
        applied = leader.raft.last_applied
        assert wait_until(lambda: other.raft.last_applied == applied), pkg
        for s in (leader, other):
            with s.raft._lock:
                s.raft._compact_locked()
        assert leader.raft.snapshot_index == applied > \
            victim.raft.last_applied
        assert len(leader.fsm.snapshot()) > TEST_FRAME
        leader.upsert_secret("default", "after", {"v": "x"})
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = timeouts
            victim.raft._deadline = time.monotonic() + 2.0
        transport._backoff.pop(vid, None)
        paused.clear()
        ok = wait_until(lambda: victim.store.secret_by_path(
            "default", "after") is not None
            and victim.store.secret_by_path(
                "default", f"blob/{N_BLOBS - 1}") is not None,
            timeout=wait_s)
        return ok, frames
    finally:
        stop_cluster(servers, rpcs)


def test_snapshot_fault_port_follower_catches_up(monkeypatch):
    """The port ships the snapshot in chunks, each within the frame: the
    follower behind the compaction point catches up."""
    ok, frames = follower_catches_up_by_snapshot("port", monkeypatch,
                                                 WAIT_S)
    assert ok
    assert len(frames) > 1 and max(frames) <= TEST_FRAME, frames


def test_snapshot_fault_reference_follower_never_catches_up(monkeypatch):
    """The reference sends the whole snapshot in one InstallSnapshot:
    the frame is refused, every retry fails the same way, and the
    follower stays behind (the fault the port repairs; the JAX package
    stays as it is)."""
    ok, frames = follower_catches_up_by_snapshot("ref", monkeypatch, 6.0)
    assert not ok
    assert frames and min(frames) > TEST_FRAME, frames
