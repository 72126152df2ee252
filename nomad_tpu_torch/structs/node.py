"""Node: a machine in the cluster.

Reference: nomad/structs/structs.go `Node` :1642 and
nomad/structs/node_class.go (ComputedClass hashing — the key that powers
feasibility memoization in the scheduler and, in this build, the host-side
cache for non-vectorizable constraint ops like regex/version).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .consts import (NODE_SCHED_ELIGIBLE, NODE_STATUS_DOWN, NODE_STATUS_READY)
from .csi import CSIPluginNodeInfo
from .resources import NodeReservedResources, NodeResources, ComparableResources

UNIQUE_NAMESPACE = "unique."


def is_unique_key(key: str) -> bool:
    return key.startswith(UNIQUE_NAMESPACE)


@dataclass
class DriverInfo:
    detected: bool = False
    healthy: bool = False
    health_description: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class HostVolumeConfig:
    name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class DrainStrategy:
    deadline_s: float = 0.0        # <=0: no deadline; -1: force
    ignore_system_jobs: bool = False
    force_deadline: float = 0.0    # absolute unix time when drain forces


@dataclass
class NodeEvent:
    message: str = ""
    subsystem: str = ""
    timestamp: float = 0.0
    details: Dict[str, str] = field(default_factory=dict)


@dataclass
class Node:
    id: str = ""
    secret_id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(default_factory=NodeReservedResources)
    links: Dict[str, str] = field(default_factory=dict)
    drivers: Dict[str, DriverInfo] = field(default_factory=dict)
    host_volumes: Dict[str, HostVolumeConfig] = field(default_factory=dict)
    # plugin id -> node-side CSI plugin info (reference:
    # structs.Node.CSINodePlugins, fingerprinted by the client)
    csi_node_plugins: Dict[str, CSIPluginNodeInfo] = field(
        default_factory=dict)
    status: str = NODE_STATUS_READY
    status_description: str = ""
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain: bool = False
    drain_strategy: Optional[DrainStrategy] = None
    events: List[NodeEvent] = field(default_factory=list)
    computed_class: str = ""
    status_updated_at: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    # -- scheduling predicates (reference: structs.go Node.Ready) --
    def ready(self) -> bool:
        return (self.status == NODE_STATUS_READY and not self.drain
                and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE)

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def comparable_resources(self) -> ComparableResources:
        r = self.node_resources
        return ComparableResources(cpu=r.cpu, memory_mb=r.memory_mb,
                                   disk_mb=r.disk_mb, networks=list(r.networks))

    def comparable_reserved_resources(self) -> ComparableResources:
        r = self.reserved_resources
        return ComparableResources(cpu=r.cpu, memory_mb=r.memory_mb,
                                   disk_mb=r.disk_mb)

    # -- computed class (reference: node_class.go ComputeClass) --
    def compute_class(self) -> str:
        """Hash the non-unique scheduling-relevant identity of the node.

        Included (matching the reference's HashInclude whitelist): datacenter,
        node_class, attributes/meta minus `unique.*` keys, and the device
        inventory identity (vendor/type/name/attributes minus unique).
        """
        devices = sorted(
            (d.vendor, d.type, d.name,
             tuple(sorted((k, str(v)) for k, v in d.attributes.items()
                          if not is_unique_key(k))))
            for d in self.node_resources.devices)
        ident = {
            "datacenter": self.datacenter,
            "node_class": self.node_class,
            "attributes": sorted((k, v) for k, v in self.attributes.items()
                                 if not is_unique_key(k)),
            "meta": sorted((k, v) for k, v in self.meta.items()
                           if not is_unique_key(k)),
            "devices": devices,
        }
        digest = hashlib.blake2b(
            json.dumps(ident, sort_keys=True, default=str).encode(),
            digest_size=8).hexdigest()
        self.computed_class = f"v1:{digest}"
        return self.computed_class

    def stub(self) -> dict:
        return {
            "ID": self.id, "Name": self.name, "Datacenter": self.datacenter,
            "NodeClass": self.node_class, "Status": self.status,
            "SchedulingEligibility": self.scheduling_eligibility,
            "Drain": self.drain,
        }


def resolve_node_target(node: Node, target: str):
    """Resolve a constraint LTarget like "${attr.cpu.arch}" against a node.

    Returns (value, found). Reference: scheduler/feasible.go resolveTarget.
    """
    if not target.startswith("${") or not target.endswith("}"):
        return None, False
    inner = target[2:-1]
    if inner == "node.unique.id":
        return node.id, True
    if inner == "node.datacenter":
        return node.datacenter, True
    if inner == "node.unique.name":
        return node.name, True
    if inner == "node.class":
        return node.node_class, True
    if inner.startswith("attr."):
        key = inner[len("attr."):]
        if key in node.attributes:
            return node.attributes[key], True
        return None, False
    if inner.startswith("meta."):
        key = inner[len("meta."):]
        if key in node.meta:
            return node.meta[key], True
        return None, False
    if inner.startswith("driver."):
        # ${driver.<name>} / ${driver.attr.*}: driver-provided attributes are
        # folded into node.attributes by the client under the same key.
        if inner in node.attributes:
            return node.attributes[inner], True
        return None, False
    return None, False
