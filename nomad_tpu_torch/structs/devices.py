"""Device instance accounting (reference: nomad/structs/devices.go).

Tracks which device instances (GPU/TPU/FPGA ids) are claimed by allocs on a
node so the scheduler/applier can detect oversubscription and the device
allocator can hand out free instance IDs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class DeviceAccounterInstance:
    def __init__(self, instances: Dict[str, int]):
        # instance id -> use count (healthy instances start at 0)
        self.instances = instances

    def free_count(self) -> int:
        return sum(1 for c in self.instances.values() if c == 0)


class DeviceAccounter:
    def __init__(self, node) -> None:
        self.devices: Dict[Tuple[str, str, str], DeviceAccounterInstance] = {}
        for dev in node.node_resources.devices:
            insts = {inst.id: 0 for inst in dev.instances if inst.healthy}
            self.devices[dev.id_tuple()] = DeviceAccounterInstance(insts)

    def clone(self) -> "DeviceAccounter":
        c = object.__new__(DeviceAccounter)
        c.devices = {k: DeviceAccounterInstance(dict(v.instances))
                     for k, v in self.devices.items()}
        return c

    def add_allocs(self, allocs) -> bool:
        """Mark instances used by allocs; True if oversubscribed/collision."""
        collision = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for ad in tr.devices:
                    key = (ad.vendor, ad.type, ad.name)
                    acct = self.devices.get(key)
                    if acct is None:
                        continue
                    for inst_id in ad.device_ids:
                        if inst_id not in acct.instances:
                            continue
                        acct.instances[inst_id] += 1
                        if acct.instances[inst_id] > 1:
                            collision = True
        return collision

    def add_reserved(self, vendor: str, typ: str, name: str,
                     device_ids: List[str]) -> bool:
        """Mark instance ids used; True only on genuine double-claims.
        Unknown device groups / stale instance ids are skipped (reference
        devices.go AddReserved tolerates re-fingerprinted inventory)."""
        acct = self.devices.get((vendor, typ, name))
        if acct is None:
            return False
        collision = False
        for inst_id in device_ids:
            if inst_id not in acct.instances:
                continue
            acct.instances[inst_id] += 1
            if acct.instances[inst_id] > 1:
                collision = True
        return collision

    def free_instances(self, vendor: str, typ: str, name: str) -> List[str]:
        acct = self.devices.get((vendor, typ, name))
        if acct is None:
            return []
        return [i for i, c in acct.instances.items() if c == 0]
