"""CSI volume + plugin model.

Reference: nomad/structs/csi.go — CSIVolume (:160 area) with
access/attachment modes and read/write claim sets, claim admission
(`WriteFreeClaims`, `ClaimWrite`/`ClaimRead`/`ClaimRelease`), and
CSIPlugin health aggregated from node fingerprints. The subset here
covers scheduling + claim lifecycle; external CSI controller RPCs are
out of scope (no real CSI drivers in this environment).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

ACCESS_SINGLE_NODE_READER = "single-node-reader-only"
ACCESS_SINGLE_NODE_WRITER = "single-node-writer"
ACCESS_MULTI_NODE_READER = "multi-node-reader-only"
ACCESS_MULTI_NODE_SINGLE_WRITER = "multi-node-single-writer"
ACCESS_MULTI_NODE_MULTI_WRITER = "multi-node-multi-writer"

ATTACH_FILE_SYSTEM = "file-system"
ATTACH_BLOCK_DEVICE = "block-device"

CLAIM_READ = "read"
CLAIM_WRITE = "write"


@dataclass
class CSIVolume:
    id: str = ""
    namespace: str = "default"
    name: str = ""
    plugin_id: str = ""
    access_mode: str = ACCESS_SINGLE_NODE_WRITER
    attachment_mode: str = ATTACH_FILE_SYSTEM
    # alloc id -> node id
    read_claims: Dict[str, str] = field(default_factory=dict)
    write_claims: Dict[str, str] = field(default_factory=dict)
    # populated from plugin health at read time
    schedulable: bool = True
    controller_required: bool = False
    create_index: int = 0
    modify_index: int = 0

    # -- claim admission (reference: csi.go WriteFreeClaims/ReadSchedulable)
    def read_schedulable(self) -> bool:
        return self.schedulable

    def write_free(self) -> bool:
        if self.access_mode in (ACCESS_SINGLE_NODE_READER,
                                ACCESS_MULTI_NODE_READER):
            return False
        if self.access_mode == ACCESS_MULTI_NODE_MULTI_WRITER:
            return True
        return len(self.write_claims) == 0

    def claim(self, mode: str, alloc_id: str, node_id: str) -> None:
        """Admit one claim or raise ValueError (the FSM applies this
        deterministically on every replica)."""
        if mode == CLAIM_READ:
            if not self.read_schedulable():
                raise ValueError(f"volume {self.id} not schedulable")
            self.read_claims[alloc_id] = node_id
            return
        if mode == CLAIM_WRITE:
            if not self.write_free() \
                    and alloc_id not in self.write_claims:
                raise ValueError(
                    f"volume {self.id} has no free write claims")
            self.write_claims[alloc_id] = node_id
            return
        raise ValueError(f"unknown claim mode {mode!r}")

    def release(self, alloc_id: str) -> None:
        self.read_claims.pop(alloc_id, None)
        self.write_claims.pop(alloc_id, None)

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)


@dataclass
class CSIPluginNodeInfo:
    plugin_id: str = ""
    healthy: bool = True
    requires_controller: bool = False


@dataclass
class CSIPlugin:
    """Aggregated plugin health (reference: csi.go CSIPlugin — derived
    from node fingerprints, not raft-written directly)."""
    id: str = ""
    nodes_healthy: int = 0
    nodes_expected: int = 0
    controller_required: bool = False

    @property
    def healthy(self) -> bool:
        return self.nodes_healthy > 0


def aggregate_plugins(nodes) -> Dict[str, CSIPlugin]:
    out: Dict[str, CSIPlugin] = {}
    for n in nodes:
        for pid, info in getattr(n, "csi_node_plugins", {}).items():
            p = out.setdefault(pid, CSIPlugin(id=pid))
            p.nodes_expected += 1
            if info.healthy and not n.terminal_status():
                p.nodes_healthy += 1
            p.controller_required |= info.requires_controller
    return out
