"""The server's wire verbs + the agent's wire-side ServerEndpoints.

Reference: the endpoint tables registered in nomad/server.go:1127-1150
and the client's server manager (client/servers/). Every verb wraps:
decode -> (forward to leader if this server is a follower —
nomad/rpc.go forward()) -> invoke -> encode.

The counterpart of `nomad_tpu.rpc.endpoints`.  `serve_cluster` builds
the port's `Server`s on `cuda` unless `server_kwargs` names another
`device` (the tests pass "cpu"), and `RpcServerEndpoints.close()`
closes its pooled connections.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..client.agent import ServerEndpoints
from ..raft.node import NotLeaderError
from ..structs import Allocation, Job, Node
from ..utils.codec import from_wire, to_wire
from .client import ClientPool, RpcClient, RpcError
from .server import RpcHandlerError, RpcServer


class ServerRpc:
    """Serves one Server's RPC verbs on an RpcServer.

    Followers forward leader-only writes to the current leader over
    their own client pool; if no leader is known the caller gets a
    typed `not_leader` error and may retry elsewhere.
    """

    def __init__(self, server, rpc_server: RpcServer,
                 peer_addrs: Optional[Dict[str, Tuple[str, int]]] = None,
                 tls=None, verify_hostname: str = ""):
        self.server = server
        self.rpc = rpc_server
        self.peer_addrs = dict(peer_addrs or {})
        # follower->leader forwarding is server-to-server: pin the
        # dialed peer's SAN role when verify_hostname is set
        self._pool = ClientPool(tls=tls, verify_hostname=verify_hostname)
        # leader_only verbs forward to the leader up front (heartbeats
        # must reset the LEADER's failure detector, not a follower's
        # disabled one — nomad/rpc.go forward() runs before the handler);
        # GetClientAllocs reads replicated state from any member (the
        # stale-read path) and Status.* is local by definition
        for method, fn, leader_only in (
            ("Node.Register", self._node_register, True),
            ("Node.Heartbeat", self._node_heartbeat, True),
            ("Node.GetClientAllocs", self._get_client_allocs, False),
            ("Node.UpdateAlloc", self._update_alloc, True),
            ("Secret.Get", self._secret_get, False),
            ("Alloc.MigrateSource", self._alloc_migrate_source, False),
            ("Job.Register", self._job_register, True),
            ("Job.Deregister", self._job_deregister, True),
            ("Status.Leader", self._status_leader, False),
            ("Status.Peers", self._status_peers, False),
        ):
            self.rpc.register(method,
                              self._forwarding(method, fn, leader_only))

    # ----------------------------------------------------------- verbs
    def _node_register(self, params):
        node = from_wire(Node, params[0])
        return self.server.register_node(node)

    def _node_heartbeat(self, params):
        return self.server.node_heartbeat(params[0])

    def _get_client_allocs(self, params):
        node_id, min_index, timeout = params
        allocs, index = self.server.get_client_allocs(
            node_id, int(min_index), float(timeout))
        return [[to_wire(a) for a in allocs], index]

    def _update_alloc(self, params):
        updates = [from_wire(Allocation, u) for u in params[0]]
        return self.server.update_allocs_from_client(updates)

    def _secret_get(self, params):
        namespace, path = params
        return self.server.store.secret_by_path(namespace, path)

    def _alloc_migrate_source(self, params):
        return self.server.alloc_migrate_source(params[0])

    def _job_register(self, params):
        job = from_wire(Job, params[0])
        ev = self.server.register_job(job)
        return to_wire(ev) if ev is not None else None

    def _job_deregister(self, params):
        namespace, job_id, purge = params
        ev = self.server.deregister_job(namespace, job_id, purge)
        return to_wire(ev) if ev is not None else None

    def _status_leader(self, params):
        if self.server.is_leader():
            return self.server.raft.id
        return self.server.raft.leader_id

    def _status_peers(self, params):
        return {pid: list(addr) for pid, addr in self.peer_addrs.items()}

    # ------------------------------------------------------ forwarding
    def _forwarding(self, method: str, fn, leader_only: bool):
        def wrapped(params):
            if leader_only and not self.server.is_leader():
                return self._forward(method, params,
                                     self.server.raft.leader_id)
            try:
                return fn(params)
            except NotLeaderError as e:
                # lost leadership mid-call: hand off
                return self._forward(method, params, e.leader_id
                                     or self.server.raft.leader_id)
        return wrapped

    def _forward(self, method: str, params, leader: Optional[str]):
        addr = self.peer_addrs.get(leader) if leader else None
        if addr is None or leader == self.server.raft.id:
            raise RpcHandlerError("not_leader", "no known leader",
                                  {"leader": leader})
        try:
            return self._pool.get(leader, addr).call(method, params)
        except (ConnectionError, RpcError) as fe:
            raise RpcHandlerError("forward_failed", str(fe),
                                  {"leader": leader}) from fe


class RpcServerEndpoints(ServerEndpoints):
    """The node agent's server surface over the wire, with server-list
    failover (reference: client/servers/ rebalancing — on a transport
    error the next server in the list is tried)."""

    def __init__(self, addrs: Sequence[Tuple[str, int]], tls=None):
        assert addrs, "need at least one server address"
        self.addrs = [(h, int(p)) for h, p in addrs]
        self._clients = [RpcClient(a, tls=tls) for a in self.addrs]
        self._current = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        """Close every pooled connection to the servers."""
        for c in self._clients:
            c.close()

    def _call(self, method: str, params: List[Any],
              timeout: float = 30.0):
        last: Optional[Exception] = None
        n = len(self._clients)
        for attempt in range(n):
            with self._lock:
                ix = self._current
            client = self._clients[ix]
            try:
                return client.call(method, params, timeout=timeout)
            except (ConnectionError, RpcError) as e:
                if isinstance(e, RpcError) and e.kind not in (
                        "not_leader", "forward_failed"):
                    raise
                last = e
                with self._lock:
                    self._current = (ix + 1) % n
        raise last if last is not None else ConnectionError("no servers")

    # -------------------------------------------------- ServerEndpoints
    def register_node(self, node: Node) -> int:
        return self._call("Node.Register", [to_wire(node)])

    def node_heartbeat(self, node_id: str) -> Optional[float]:
        return self._call("Node.Heartbeat", [node_id])

    def get_client_allocs(self, node_id: str, min_index: int,
                          timeout: float):
        allocs_wire, index = self._call(
            "Node.GetClientAllocs", [node_id, min_index, timeout],
            timeout=timeout + 10.0)
        return ([from_wire(Allocation, a) for a in allocs_wire], index)

    def update_allocs(self, updates: List[Allocation]) -> None:
        self._call("Node.UpdateAlloc",
                   [[to_wire(u) for u in updates]])

    def get_secret(self, namespace: str, path: str):
        return self._call("Secret.Get", [namespace, path])

    def get_alloc_migrate_source(self, alloc_id: str):
        return self._call("Alloc.MigrateSource", [alloc_id])

    # convenience for tests / CLI parity over the wire
    def register_job(self, job: Job):
        return self._call("Job.Register", [to_wire(job)])


def serve_cluster(n: int = 3, host: str = "127.0.0.1", num_workers: int = 1,
                  server_kwargs: Optional[dict] = None,
                  raft_kwargs: Optional[dict] = None,
                  tls_server=None, tls_client=None,
                  verify_hostname: str = ""):
    """Boot an n-server cluster wired over TCP: one RpcServer per member
    carrying both the raft verbs and the server endpoints. Returns
    (servers, server_rpcs, addrs). The reference's in-process test
    cluster (nomad/testing.go TestJoin) with real sockets.  Every
    server's workers solve on `server_kwargs["device"]`, `cuda` when it
    is not given.  `raft_kwargs` are `RaftConfig` fields for every
    member (timeouts: the defaults are the reference's test cluster's;
    hashicorp/raft's own are an election timeout of 1-2 s and a
    heartbeat of 0.1 s)."""
    from ..raft import RaftConfig
    from ..server.server import Server
    from .transport import TcpRaftTransport

    ids = [f"s{i + 1}" for i in range(n)]
    rpcs = [RpcServer(host, 0, tls=tls_server) for _ in ids]
    addrs = {pid: rpc.addr for pid, rpc in zip(ids, rpcs)}
    servers, server_rpcs = [], []
    kwargs = {"device": "cuda", **(server_kwargs or {})}
    for pid, rpc in zip(ids, rpcs):
        transport = TcpRaftTransport(rpc, addrs, tls=tls_client,
                                     verify_hostname=verify_hostname)
        srv = Server(num_workers=num_workers,
                     raft_config=RaftConfig(node_id=pid, peers=list(ids),
                                            **(raft_kwargs or {})),
                     raft_transport=transport, **kwargs)
        server_rpcs.append(ServerRpc(srv, rpc, addrs, tls=tls_client,
                                     verify_hostname=verify_hostname))
        servers.append(srv)
        rpc.start()
    for srv in servers:
        srv.start()
    return servers, server_rpcs, addrs
