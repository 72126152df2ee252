"""The node agent's server surface (reference: client/client.go talks to
servers through Node.Register, Node.UpdateStatus, Node.GetClientAllocs
and Node.UpdateAlloc).

The agent talks to servers through the narrow `ServerEndpoints`
interface; `InProcServer` adapts the in-process Server, and the RPC
transport (`rpc.endpoints.RpcServerEndpoints`) drops in behind the same
surface.

The counterpart of `nomad_tpu.client.agent`, lines 36-101 only: the
interface and its in-process adapter.  The agent itself (`Client`:
register, heartbeat, the alloc watch, the alloc and task runners, the
state DB) and the rest of the reference's `client/` package, with
`drivers/` and `plugins/`, are ROADMAP.md Queue 1 item 16.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..structs import Allocation, Node


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


