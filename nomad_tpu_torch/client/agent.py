"""The node agent (reference: client/client.go — Client :158,
registerAndHeartbeat :1484, watchAllocations :1924, runAllocs :2147,
batched allocSync :1858, restoreState :1032).

Register -> heartbeat on the server-granted TTL -> long-poll desired
allocations (a blocking query against the server's alloc index) -> diff
into alloc runners -> batch client-status updates back. On start the
agent restores runners from the state DB and re-attaches to live
workloads through each driver's RecoverTask.

The agent talks to servers through the narrow `ServerEndpoints`
interface; `InProcServer` adapts the in-process Server, and the RPC
transport (`rpc.endpoints.RpcServerEndpoints`) drops in behind the same
surface.

The counterpart of `nomad_tpu.client.agent`.  Until CSI is ported
(ROADMAP.md Queue 1 item 16b) a `Client` has no CSI manager
(`csi_manager` is None, and there is no `register_csi_plugin`): an alloc
that asks for a CSI volume fails in its alloc runner.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..plugins.drivers import default_registry
from ..structs import NODE_STATUS_READY, Allocation, Node
from .allocrunner import AllocRunner
from .fingerprint import fingerprint_node
from .state import MemDB, StateDB

_log = logging.getLogger(__name__)

ALLOC_SYNC_INTERVAL_S = 0.2     # reference: client.go:93 allocSyncIntv
WATCH_TIMEOUT_S = 5.0
MAX_TERMINAL_RUNNERS = 50       # client-side GC bound (client/gc.go)


class ServerEndpoints:
    """The client<->server RPC surface (reference: Node.Register,
    Node.UpdateStatus, Node.GetClientAllocs, Node.UpdateAlloc)."""

    def register_node(self, node: Node) -> int:
        raise NotImplementedError

    def node_heartbeat(self, node_id: str) -> Optional[float]:
        raise NotImplementedError

    def get_client_allocs(self, node_id: str, min_index: int,
                          timeout: float) -> Tuple[List[Allocation], int]:
        raise NotImplementedError

    def update_allocs(self, updates: List[Allocation]) -> None:
        raise NotImplementedError

    def get_secret(self, namespace: str, path: str):
        """Fetch one secret's data dict (None if missing) — the task
        runner resolves ${secret...} references through this at task
        start (the Vault-token fetch analog)."""
        raise NotImplementedError

    def get_csi_volume(self, namespace: str, vol_id: str):
        """Resolve a registered CSI volume's details (None if missing)
        — consulted before staging (reference:
        client/pluginmanager/csimanager/volume.go)."""
        raise NotImplementedError

    def get_alloc_migrate_source(self, alloc_id: str):
        """For a replacement alloc's previous_allocation: the previous
        alloc's terminal-ness, owning node, advertised agent address,
        and a migrate token scoped to reading ITS alloc dir (reference:
        Node.GetClientAllocs returns MigrateTokens, client.go:925).
        None when the alloc is unknown (already GC'd)."""
        raise NotImplementedError


class InProcServer(ServerEndpoints):
    """Direct adapter over the port's `server.server.Server`."""

    def __init__(self, server):
        self.server = server

    def register_node(self, node: Node) -> int:
        return self.server.register_node(node)

    def node_heartbeat(self, node_id: str) -> Optional[float]:
        return self.server.node_heartbeat(node_id)

    def get_client_allocs(self, node_id, min_index, timeout):
        return self.server.get_client_allocs(node_id, min_index, timeout)

    def update_allocs(self, updates: List[Allocation]) -> None:
        self.server.update_allocs_from_client(updates)

    def get_secret(self, namespace: str, path: str):
        return self.server.store.secret_by_path(namespace, path)

    def get_csi_volume(self, namespace: str, vol_id: str):
        return self.server.store.csi_volume_by_id(namespace, vol_id)

    def get_alloc_migrate_source(self, alloc_id: str):
        return self.server.alloc_migrate_source(alloc_id)


class Client:
    def __init__(self, servers: ServerEndpoints, data_dir: str,
                 node: Optional[Node] = None, registry=None,
                 datacenter: str = "dc1",
                 meta: Optional[Dict[str, str]] = None,
                 state_db=None, dev_mode: bool = False,
                 device_registry=None, tls=None):
        self.servers = (InProcServer(servers)
                        if not isinstance(servers, ServerEndpoints)
                        else servers)
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.registry = registry or default_registry()
        if device_registry is None:
            from ..plugins.device import default_device_registry
            device_registry = default_device_registry()
        self.device_registry = device_registry
        self.state_db = state_db if state_db is not None else (
            MemDB() if dev_mode
            else StateDB(os.path.join(data_dir, "client", "state.db")))
        #: no CSI manager until CSI is ported (see the module docstring)
        self.csi_manager = None
        self.node = node or self._fingerprint_with_identity(datacenter, meta)
        if self.node.status != NODE_STATUS_READY:
            self.node.status = NODE_STATUS_READY
        self.runners: Dict[str, AllocRunner] = {}
        self._runners_lock = threading.Lock()
        self._updates: Dict[str, Allocation] = {}
        self._updates_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        #: utils.tlsutil.TLSConfig for dials to OTHER agents (disk
        #: migration streams); must match the cluster's HTTP plane
        self.tls = tls

    def _fingerprint_with_identity(self, datacenter, meta) -> Node:
        """Fingerprint the host, keeping a stable node identity across
        agent restarts (reference: the client persists NodeID/SecretID
        under <data_dir>/client)."""
        import json
        node = fingerprint_node(self.data_dir, self.registry,
                                datacenter=datacenter, meta=meta,
                                device_registry=self.device_registry)
        ident_path = os.path.join(self.data_dir, "client", "node.json")
        try:
            with open(ident_path) as f:
                ident = json.load(f)
            node.id = ident["id"]
            node.secret_id = ident["secret_id"]
        except (OSError, KeyError, ValueError):
            os.makedirs(os.path.dirname(ident_path), exist_ok=True)
            with open(ident_path, "w") as f:
                json.dump({"id": node.id, "secret_id": node.secret_id}, f)
        return node

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        self.restore_state()
        self.servers.register_node(self.node)
        for fn in (self._heartbeat_loop, self._watch_allocations,
                   self._alloc_sync_loop):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"client-{fn.__name__}")
            t.start()
            self._threads.append(t)

    def shutdown(self, halt_tasks: bool = False, leave: bool = False
                 ) -> None:
        """Stop the agent. With halt_tasks=False, workloads keep running
        under their executors — the restart/re-attach path
        (reference: agent restarts don't kill tasks)."""
        self._shutdown.set()
        if halt_tasks:
            with self._runners_lock:
                runners = list(self.runners.values())
            for r in runners:
                r.kill("agent shutting down")
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
        self.state_db.close()

    # ------------------------------------------------------------- restore
    def restore_state(self) -> None:
        """reference: client.go:1032 restoreState — rebuild runners from
        the state DB; each task runner re-attaches via RecoverTask."""
        for alloc in self.state_db.get_all_allocations():
            if alloc.server_terminal_status():
                continue
            try:
                runner = self._new_runner(alloc)
            except ValueError as e:
                _log.warning("restore %s: %s", alloc.id, e)
                continue
            runner.restore()
            with self._runners_lock:
                self.runners[alloc.id] = runner
            runner.run()

    # ------------------------------------------------------------- threads
    def _heartbeat_loop(self) -> None:
        """reference: client.go:1484 registerAndHeartbeat."""
        while not self._shutdown.is_set():
            try:
                ttl = self.servers.node_heartbeat(self.node.id)
            except Exception:
                _log.exception("heartbeat failed")
                ttl = None
            if ttl is None:
                # unknown node (server restarted / GC'd us): re-register
                try:
                    self.servers.register_node(self.node)
                except Exception:
                    _log.exception("re-register failed")
                ttl = 1.0
            self._shutdown.wait(max(ttl / 2.0, 0.05))

    def _watch_allocations(self) -> None:
        """reference: client.go:1924 watchAllocations — blocking query on
        the server's alloc-by-node index."""
        index = 0
        while not self._shutdown.is_set():
            try:
                allocs, index = self.servers.get_client_allocs(
                    self.node.id, index, WATCH_TIMEOUT_S)
            except Exception:
                _log.exception("watch_allocations failed")
                self._shutdown.wait(1.0)
                continue
            try:
                self._run_allocs(allocs)
            except Exception:
                _log.exception("run_allocs failed")

    def _run_allocs(self, desired: List[Allocation]) -> None:
        """Diff desired vs running (reference: client.go:2147 runAllocs)."""
        desired_by_id = {a.id: a for a in desired}
        with self._runners_lock:
            known = dict(self.runners)
        # removals: the server GC'd the alloc entirely
        for alloc_id, runner in known.items():
            if alloc_id not in desired_by_id:
                runner.destroy()
                with self._runners_lock:
                    self.runners.pop(alloc_id, None)
        for alloc in desired:
            runner = known.get(alloc.id)
            if runner is not None:
                if alloc.alloc_modify_index > \
                        runner.alloc.alloc_modify_index or \
                        alloc.modify_index > runner.alloc.modify_index:
                    runner.update(alloc)
                continue
            if alloc.server_terminal_status():
                continue               # never started here; nothing to do
            if alloc.client_terminal_status():
                continue               # finished in a previous life
            self.state_db.put_allocation(alloc)
            try:
                runner = self._new_runner(alloc)
            except ValueError as e:
                self._fail_alloc(alloc, str(e))
                continue
            with self._runners_lock:
                self.runners[alloc.id] = runner
            runner.run()
        self._gc_terminal_runners()

    def _new_runner(self, alloc: Allocation) -> AllocRunner:
        return AllocRunner(alloc, self.data_dir, self.registry, self.node,
                           self._queue_update, state_db=self.state_db,
                           device_registry=self.device_registry,
                           secrets_fetcher=self.servers.get_secret,
                           prev_migrator=self.migrate_prev_alloc_dir)

    # ------------------------------------------- ephemeral-disk migration
    def migrate_prev_alloc_dir(self, alloc: Allocation,
                               dest_alloc_dir,
                               timeout_s: float = 60.0) -> None:
        """Bring a migrate=true previous alloc's shared data to this
        node before the replacement's tasks start (reference:
        client/allocwatcher/ — wait for the previous alloc to stop,
        then move its dir locally or stream it from the owning agent
        with a migrate token, client.go:925)."""
        import shutil
        import time as _t
        prev_id = alloc.previous_allocation
        deadline = _t.monotonic() + timeout_s
        src = None
        while True:
            try:
                src = self.servers.get_alloc_migrate_source(prev_id)
            except NotImplementedError:
                return                    # endpoint unsupported: skip
            if src is None:
                return                    # previous alloc already GC'd
            if src.get("terminal"):
                break
            if _t.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out waiting for previous alloc "
                    f"{prev_id[:8]} to stop before disk migration")
            _t.sleep(0.2)
        dest_data = os.path.join(dest_alloc_dir.shared, "data")
        os.makedirs(dest_data, exist_ok=True)
        prev_runner = self.get_alloc_runner(prev_id)
        if prev_runner is not None:
            # local move (same node): reference allocwatcher's
            # local migration path
            src_data = os.path.join(prev_runner.alloc_dir.shared, "data")
            if os.path.isdir(src_data):
                shutil.copytree(src_data, dest_data, dirs_exist_ok=True)
            return
        addr = src.get("addr", "")
        if not addr:
            raise RuntimeError(
                "previous alloc's node has no advertised agent address "
                "to stream the ephemeral disk from")
        self._fetch_remote_alloc_data(addr, prev_id,
                                      src.get("migrate_token", ""),
                                      dest_data)

    def _fetch_remote_alloc_data(self, addr: str, prev_id: str,
                                 token: str, dest_data: str) -> None:
        """Recursively copy the previous alloc's alloc/data subtree
        through the owning agent's fs API."""
        import base64

        from ..api.client import ApiClient
        scheme = ("https" if self.tls is not None
                  and self.tls.enabled() else "http")
        api = ApiClient(address=f"{scheme}://{addr}", token=token,
                        timeout=60.0, tls=self.tls)

        def walk(rel: str, dest: str) -> None:
            listing, _ = api.request(
                "GET", f"/v1/client/fs/ls/{prev_id}",
                params={"path": rel})
            for ent in listing.get("files", []):
                name = ent["name"]
                # the listing comes from a REMOTE agent: a compromised
                # or confused peer must not be able to steer the join
                # below outside dest ("../x", "a/b", "/etc/passwd")
                if (not name or name in (".", "..")
                        or "/" in name or "\\" in name
                        or os.path.isabs(name)):
                    raise RuntimeError(
                        f"remote fs listing returned unsafe entry name "
                        f"{name!r}")
                sub_rel = f"{rel}/{name}"
                sub_dest = os.path.join(dest, name)
                if ent["is_dir"]:
                    os.makedirs(sub_dest, exist_ok=True)
                    walk(sub_rel, sub_dest)
                    continue
                with open(sub_dest, "wb") as f:
                    off = 0
                    while True:
                        chunk, _ = api.request(
                            "GET", f"/v1/client/fs/readat/{prev_id}",
                            params={"path": sub_rel, "offset": off,
                                    "limit": 1 << 20})
                        data = base64.b64decode(chunk.get("data", ""))
                        if not data:
                            break
                        f.write(data)
                        off += len(data)
                        # NOTE: a short (< limit) read is NOT EOF — the
                        # remote may return partial chunks under load;
                        # only an empty read ends the file, so a short
                        # read can never silently truncate a migration

        try:
            walk("alloc/data", dest_data)
        except Exception as e:
            raise RuntimeError(
                f"ephemeral disk migration from {addr} failed: {e}")

    def _fail_alloc(self, alloc: Allocation, reason: str) -> None:
        import copy
        from ..structs import ALLOC_CLIENT_FAILED
        upd = copy.copy(alloc)
        upd.client_status = ALLOC_CLIENT_FAILED
        upd.client_description = reason
        self._queue_update(upd)

    def _gc_terminal_runners(self) -> None:
        """Client-side GC (reference: client/gc.go AllocGarbageCollector,
        simplified to a count bound)."""
        with self._runners_lock:
            terminal = [(a_id, r) for a_id, r in self.runners.items()
                        if r.is_done()]
            excess = len(terminal) - MAX_TERMINAL_RUNNERS
            victims = terminal[:excess] if excess > 0 else []
            for a_id, _ in victims:
                self.runners.pop(a_id, None)
        for _, r in victims:
            r.destroy()

    # ---------------------------------------------------------- allocSync
    def _queue_update(self, alloc: Allocation) -> None:
        with self._updates_lock:
            self._updates[alloc.id] = alloc

    def _alloc_sync_loop(self) -> None:
        """Batched status push (reference: client.go:1858 allocSync)."""
        while not self._shutdown.is_set():
            self._shutdown.wait(ALLOC_SYNC_INTERVAL_S)
            self.flush_updates()

    def flush_updates(self) -> None:
        with self._updates_lock:
            if not self._updates:
                return
            batch = list(self._updates.values())
            self._updates.clear()
        try:
            self.servers.update_allocs(batch)
        except Exception:
            _log.exception("alloc sync failed; requeueing %d", len(batch))
            with self._updates_lock:
                for a in batch:
                    self._updates.setdefault(a.id, a)

    # ------------------------------------------------------------- queries
    def get_alloc_runner(self, alloc_id: str) -> Optional[AllocRunner]:
        with self._runners_lock:
            return self.runners.get(alloc_id)

    def num_allocs(self) -> int:
        with self._runners_lock:
            return len(self.runners)
