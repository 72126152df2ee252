"""Per-node port and bandwidth accounting.

Reference: nomad/structs/network.go `NetworkIndex` :43 — used by the
bin-pack ranker to offer networks and by the plan applier to re-verify.
Port picking is inherently discrete/host-side (SURVEY §7.3); the TPU solve
models bandwidth only and the applier does port fixup with this class.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from .resources import NetworkResource, Port

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 32000
MAX_RANDOM_ATTEMPTS = 20


class NetworkIndex:
    """Tracks used ports per IP and bandwidth per device on one node."""

    def __init__(self) -> None:
        self.avail_networks: List[NetworkResource] = []   # node's networks
        self.avail_bandwidth: Dict[str, int] = {}          # device -> mbits
        self.used_ports: Dict[str, Set[int]] = {}          # ip -> ports
        self.used_bandwidth: Dict[str, int] = {}           # device -> mbits

    def release(self) -> None:
        self.__init__()

    def clone(self) -> "NetworkIndex":
        c = NetworkIndex()
        c.avail_networks = list(self.avail_networks)
        c.avail_bandwidth = dict(self.avail_bandwidth)
        c.used_ports = {ip: set(s) for ip, s in self.used_ports.items()}
        c.used_bandwidth = dict(self.used_bandwidth)
        return c

    # -- building the index --
    def set_node(self, node) -> bool:
        """Register node networks + reserved ports. True on collision."""
        collide = False
        for n in node.node_resources.networks:
            if n.device:
                self.avail_networks.append(n)
                self.avail_bandwidth[n.device] = max(
                    self.avail_bandwidth.get(n.device, 0), n.mbits)
        reserved = node.reserved_resources.parsed_ports()
        for ip in {n.ip for n in self.avail_networks}:
            for port in reserved:
                if not self._add_used_port(ip, port):
                    collide = True
        return collide

    def add_allocs(self, allocs) -> bool:
        collide = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for net in tr.networks:
                    if self.add_reserved(net):
                        collide = True
            for net in alloc.allocated_resources.shared.networks:
                if self.add_reserved(net):
                    collide = True
        return collide

    def add_reserved(self, net: NetworkResource) -> bool:
        collide = False
        for p in list(net.reserved_ports) + list(net.dynamic_ports):
            if p.value and not self._add_used_port(net.ip, p.value):
                collide = True
        if net.device:
            self.used_bandwidth[net.device] = (
                self.used_bandwidth.get(net.device, 0) + net.mbits)
        return collide

    def _add_used_port(self, ip: str, port: int) -> bool:
        s = self.used_ports.setdefault(ip, set())
        if port in s:
            return False
        s.add(port)
        return True

    # -- queries --
    def overcommitted(self) -> bool:
        for dev, used in self.used_bandwidth.items():
            if used > self.avail_bandwidth.get(dev, 0):
                return True
        return False

    def yield_ip(self):
        for n in self.avail_networks:
            yield n

    # -- assignment (reference network.go:256 AssignNetwork) --
    def assign_network(self, ask: NetworkResource, seed: Optional[int] = None
                       ) -> Tuple[Optional[NetworkResource], str]:
        """Find an IP satisfying the ask; pick dynamic ports.

        Deterministic when `seed` given (replay-test determinism policy,
        SURVEY §7.3 score-tie note).
        """
        if not self.avail_networks:
            return None, "no networks available"
        err = "no networks available"
        for n in self.avail_networks:
            # bandwidth check
            avail = self.avail_bandwidth.get(n.device, 0)
            used = self.used_bandwidth.get(n.device, 0)
            if used + ask.mbits > avail:
                err = "bandwidth exceeded"
                continue
            used_set = self.used_ports.get(n.ip, set())
            # reserved ports must be free
            collision = False
            for p in ask.reserved_ports:
                if p.value in used_set:
                    collision = True
                    break
            if collision:
                err = "reserved port collision"
                continue
            # dynamic ports
            rng = random.Random(seed if seed is not None
                                else hash((n.ip, len(used_set))))
            taken = set(used_set) | {p.value for p in ask.reserved_ports}
            dyn_ports: List[Port] = []
            ok = True
            for p in ask.dynamic_ports:
                port = self._pick_dynamic(rng, taken)
                if port < 0:
                    ok = False
                    err = "dynamic port selection failed"
                    break
                taken.add(port)
                dyn_ports.append(Port(label=p.label, value=port, to=p.to,
                                      host_network=p.host_network))
            if not ok:
                continue
            offer = NetworkResource(
                mode=ask.mode, device=n.device, ip=n.ip, cidr=n.cidr,
                mbits=ask.mbits,
                reserved_ports=[Port(p.label, p.value, p.to, p.host_network)
                                for p in ask.reserved_ports],
                dynamic_ports=dyn_ports)
            return offer, ""
        return None, err

    @staticmethod
    def _pick_dynamic(rng: random.Random, taken: Set[int]) -> int:
        for _ in range(MAX_RANDOM_ATTEMPTS):
            port = rng.randint(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)
            if port not in taken:
                return port
        # linear fallback scan
        for port in range(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT + 1):
            if port not in taken:
                return port
        return -1
