"""Node fingerprinting pipeline (reference: client/fingerprint_manager.go
+ client/fingerprint/ — arch, cpu, host, memory, storage, nomad, plus the
driver manager's per-driver fingerprints).

Builds Node.attributes and NodeResources from the host, merges driver
fingerprints, and computes the node class hash that powers feasibility
memoization.

The counterpart of `nomad_tpu.client.fingerprint`.
"""
from __future__ import annotations

import os
import platform
import shutil
import socket
from typing import Dict, Optional

from ..structs import NetworkResource, Node, NodeReservedResources, \
    NodeResources
from ..utils.ids import generate_uuid

VERSION = "0.1.0"


def _cpu_total_mhz() -> int:
    cores = os.cpu_count() or 1
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except (OSError, ValueError):
        pass
    return int(cores * mhz)


def _memory_mb() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) // 1024
    except (OSError, ValueError):
        pass
    return 1024


def _disk_mb(path: str) -> int:
    try:
        return int(shutil.disk_usage(path).total // (1024 * 1024))
    except OSError:
        return 10 * 1024


def fingerprint_node(data_dir: str = "/tmp",
                     registry=None,
                     datacenter: str = "dc1",
                     node_class: str = "",
                     meta: Optional[Dict[str, str]] = None,
                     device_registry=None) -> Node:
    """Run all fingerprinters and assemble the Node
    (reference: fingerprint.go:31-51 registry + client.go:1295 setup)."""
    attrs: Dict[str, str] = {
        "arch": platform.machine() or "unknown",
        "kernel.name": platform.system().lower(),
        "kernel.version": platform.release(),
        "os.name": platform.system().lower(),
        "cpu.numcores": str(os.cpu_count() or 1),
        "cpu.totalcompute": str(_cpu_total_mhz()),
        "memory.totalbytes": str(_memory_mb() * 1024 * 1024),
        "nomad.version": VERSION,
        "unique.hostname": socket.gethostname(),
    }
    if registry is not None:
        for name, fp in registry.fingerprints().items():
            if fp.health == "healthy":
                attrs.update(fp.attributes)
    node = Node(
        id=generate_uuid(),
        secret_id=generate_uuid(),
        name=socket.gethostname(),
        datacenter=datacenter,
        node_class=node_class,
        attributes=attrs,
        meta=dict(meta or {}),
        node_resources=NodeResources(
            cpu=_cpu_total_mhz(),
            memory_mb=_memory_mb(),
            disk_mb=_disk_mb(data_dir),
            networks=[NetworkResource(device="lo", cidr="127.0.0.1/32",
                                      ip="127.0.0.1", mbits=1000)],
            devices=(device_registry.fingerprint_all()
                     if device_registry is not None else [])),
        reserved_resources=NodeReservedResources(),
        status="initializing",
    )
    node.compute_class()
    return node
