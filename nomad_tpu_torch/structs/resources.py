"""Resource model: what a node has, what a task asks for, what an alloc holds.

Semantics follow the reference domain model (reference: nomad/structs/structs.go
`Resources` :1969, `NodeResources` :2508, AllocatedResources family) but the
shape is re-designed for tensorization: every request/usage can be flattened to
a fixed-width numeric vector (see nomad_tpu_torch/solver/tensorize.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass
class Port:
    label: str = ""
    value: int = 0
    to: int = 0
    host_network: str = ""


@dataclass
class NetworkResource:
    """One network ask/grant: bandwidth plus reserved/dynamic ports."""
    mode: str = "host"
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return NetworkResource(
            mode=self.mode, device=self.device, cidr=self.cidr, ip=self.ip,
            mbits=self.mbits,
            reserved_ports=[replace(p) for p in self.reserved_ports],
            dynamic_ports=[replace(p) for p in self.dynamic_ports],
        )

    def port_labels(self) -> Dict[str, int]:
        out = {}
        for p in self.reserved_ports:
            out[p.label] = p.value
        for p in self.dynamic_ports:
            out[p.label] = p.value
        return out


@dataclass
class RequestedDevice:
    """A task's device ask, e.g. name="nvidia/gpu" count=2.

    Name may be "<vendor>/<type>/<model>", "<vendor>/<type>" or "<type>"
    (reference: nomad/structs/structs.go RequestedDevice.ID semantics).
    """
    name: str = ""
    count: int = 1
    constraints: list = field(default_factory=list)   # List[Constraint]
    affinities: list = field(default_factory=list)    # List[Affinity]

    def id_tuple(self) -> Tuple[str, str, str]:
        """(vendor, type, model) with empty strings for unspecified parts."""
        parts = self.name.split("/")
        if len(parts) == 1:
            return ("", parts[0], "")
        if len(parts) == 2:
            return (parts[0], parts[1], "")
        return (parts[0], parts[1], "/".join(parts[2:]))

    def matches(self, vendor: str, typ: str, model: str) -> bool:
        return device_pattern_matches(self.id_tuple(), (vendor, typ, model))


def device_pattern_matches(pattern: Tuple[str, str, str],
                           ident: Tuple[str, str, str]) -> bool:
    """Wildcard device matching: empty pattern parts match anything
    (reference: structs.RequestedDevice ID semantics)."""
    return all(not p or p == d for p, d in zip(pattern, ident))


@dataclass
class Resources:
    """A task's resource request (reference: structs.Resources)."""
    cpu: int = 100            # MHz
    memory_mb: int = 300
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)

    def copy(self) -> "Resources":
        return Resources(
            cpu=self.cpu, memory_mb=self.memory_mb, disk_mb=self.disk_mb,
            networks=[n.copy() for n in self.networks],
            devices=[RequestedDevice(d.name, d.count, list(d.constraints),
                                     list(d.affinities)) for d in self.devices],
        )

    def add(self, other: "Resources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.networks.extend(n.copy() for n in other.networks)


@dataclass
class NodeDevice:
    id: str = ""
    healthy: bool = True
    health_description: str = ""
    locality: Optional[dict] = None  # e.g. {"pci_bus_id": "..."}


@dataclass
class NodeDeviceResource:
    """A device group on a node (reference: structs.NodeDeviceResource)."""
    vendor: str = ""
    type: str = ""
    name: str = ""            # model
    instances: List[NodeDevice] = field(default_factory=list)
    attributes: Dict[str, object] = field(default_factory=dict)

    def id_tuple(self) -> Tuple[str, str, str]:
        return (self.vendor, self.type, self.name)


@dataclass
class NodeResources:
    """Total resources a node fingerprinted (reference: structs.NodeResources)."""
    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDeviceResource] = field(default_factory=list)


@dataclass
class NodeReservedResources:
    """Resources the node operator carved out of the total."""
    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_host_ports: str = ""  # "80,443,8000-8100"

    def parsed_ports(self) -> List[int]:
        out: List[int] = []
        s = self.reserved_host_ports.strip()
        if not s:
            return out
        for part in s.split(","):
            part = part.strip()
            if "-" in part:
                lo, hi = part.split("-", 1)
                out.extend(range(int(lo), int(hi) + 1))
            elif part:
                out.append(int(part))
        return out


@dataclass
class AllocatedDeviceResource:
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: List[str] = field(default_factory=list)


@dataclass
class AllocatedTaskResources:
    cpu: int = 0
    memory_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[AllocatedDeviceResource] = field(default_factory=list)

    def add(self, other: "AllocatedTaskResources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.networks.extend(n.copy() for n in other.networks)
        self.devices.extend(
            AllocatedDeviceResource(d.vendor, d.type, d.name, list(d.device_ids))
            for d in other.devices)


@dataclass
class AllocatedSharedResources:
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)


@dataclass
class AllocatedResources:
    """What an allocation actually holds, per task plus shared."""
    tasks: Dict[str, AllocatedTaskResources] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def comparable(self) -> "ComparableResources":
        c = ComparableResources()
        for tr in self.tasks.values():
            c.cpu += tr.cpu
            c.memory_mb += tr.memory_mb
            c.networks.extend(tr.networks)
            c.devices.extend(tr.devices)
        c.disk_mb = self.shared.disk_mb
        c.networks.extend(self.shared.networks)
        return c

    def copy(self) -> "AllocatedResources":
        out = AllocatedResources()
        for name, tr in self.tasks.items():
            t = AllocatedTaskResources(cpu=tr.cpu, memory_mb=tr.memory_mb)
            t.networks = [n.copy() for n in tr.networks]
            t.devices = [AllocatedDeviceResource(d.vendor, d.type, d.name,
                                                 list(d.device_ids))
                         for d in tr.devices]
            out.tasks[name] = t
        out.shared = AllocatedSharedResources(
            disk_mb=self.shared.disk_mb,
            networks=[n.copy() for n in self.shared.networks])
        return out


@dataclass
class ComparableResources:
    """Flattened resource totals used by fit checks and scoring
    (reference: structs.ComparableResources + funcs.go algebra)."""
    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[AllocatedDeviceResource] = field(default_factory=list)

    def add(self, other: Optional["ComparableResources"]) -> None:
        if other is None:
            return
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.networks.extend(other.networks)
        self.devices.extend(other.devices)

    def superset(self, other: "ComparableResources") -> Tuple[bool, str]:
        """Is self >= other in every dimension? Returns (ok, exhausted_dim)."""
        if self.cpu < other.cpu:
            return False, "cpu"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        return True, ""
