"""Seeded plain data for one run: nodes, resident usage and job asks.

Frozen copies of the scenario formulas the repository's smoke script
(`chip_smoke.py` `make_nodes`, `make_job`, `resident_allocs`, at commit
e7763fa, themselves `bench.py`'s config-3 and config-2 formulas),
rewritten to read a configuration file and to return plain Python and
NumPy data.  Nothing here imports the port: `port.py` turns this data
into the port's structs, and the reference reads the same data.

The seed never changes the sizes: it shuffles which node position holds
which formula row, names the nodes and jobs, and draws the solver's
tie-break seeds.  Every seed so gives the same multiset of nodes and
asks, in another order.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: resource dimensions, in the port's order (cpu MHz, memory MB, disk MB,
#: network Mbit/s)
R_DIMS = ("cpu", "memory_mb", "disk_mb", "mbits")


@dataclass
class Node:
    id: str
    name: str
    datacenter: str
    rack: str
    zone: str
    cap: np.ndarray          # [R] float64: capacity, nothing reserved


@dataclass
class Group:
    name: str
    count: int
    ask: np.ndarray          # [R] per instance


@dataclass
class JobSpec:
    """One job's plain spec; `id` is set per job from the seed."""
    id: str
    datacenters: List[str]
    groups: List[Group]
    constraints: List[list] = field(default_factory=list)   # [l, op, r]
    affinities: List[list] = field(default_factory=list)    # [l, op, r, w]
    spreads: List[list] = field(default_factory=list)       # [attr, w]


@dataclass
class Cluster:
    nodes: List[Node]
    resident_per_node: np.ndarray    # [n] int: resident allocs on node i
    resident_ask: np.ndarray         # [R]

    def resident_usage(self) -> np.ndarray:
        """[n, R] float64 usage of the resident allocs."""
        return self.resident_per_node[:, None] * self.resident_ask[None, :]

    def capacity(self) -> np.ndarray:
        return np.stack([n.cap for n in self.nodes])


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, all from the run's seed."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0),
                                  sum(map(ord, stream))])


def node_row(cfg: Dict, i: int) -> Dict:
    """Formula row i of the node generator (bench.py make_nodes)."""
    n = cfg["nodes"]
    cpu0, cpu_step, cpu_period = n["cpu_mhz"]
    mem0, mem_step, mem_period = n["memory_mb"]
    return {"datacenter": f"dc{i % n['datacenters']}",
            "rack": f"r{i % n['racks']}",
            "zone": f"z{i % n['zones']}",
            "cap": np.array([cpu0 + (i % cpu_period) * cpu_step,
                             mem0 + (i % mem_period) * mem_step,
                             n["disk_mb"], n["mbits"]], np.float64)}


def cluster(cfg: Dict, seed: int) -> Cluster:
    """The configuration's nodes, shuffled by the seed, and its
    residents round-robin over the node positions."""
    n_nodes = cfg["nodes"]["count"]
    r = rng(seed, "nodes")
    perm = r.permutation(n_nodes)
    raw = r.bytes(16 * n_nodes)
    ids = [str(uuid.UUID(bytes=raw[16 * k:16 * k + 16], version=4))
           for k in range(n_nodes)]
    nodes = []
    for pos, i in enumerate(perm):
        row = node_row(cfg, int(i))
        nodes.append(Node(id=ids[pos], name=f"node-{pos}", **row))
    res = cfg["resident"]
    per_node = np.bincount(np.arange(res["allocs"]) % n_nodes,
                           minlength=n_nodes)
    ask = np.array(res["ask"] + [0], np.float64)
    return Cluster(nodes=nodes, resident_per_node=per_node, resident_ask=ask)


def job(cfg: Dict, job_id: str) -> JobSpec:
    """The configuration's job under `job_id` (bench.py make_job)."""
    j = cfg["job"]
    groups = [Group(name=g["name"], count=g["count"],
                    ask=np.array([g["cpu"], g["memory_mb"], g["disk_mb"], 0],
                                 np.float64))
              for g in j["groups"]]
    return JobSpec(id=job_id, datacenters=list(j["datacenters"]),
                   groups=groups,
                   constraints=[list(c) for c in j["constraints"]],
                   affinities=[list(a) for a in j["affinities"]],
                   spreads=[list(s) for s in j["spreads"]])


def tie_seeds(seed: int, stream: str, n: int) -> List[int]:
    """n nonzero solver tie-break seeds (31 bits) for one purpose."""
    return [int(x) for x in rng(seed, stream).integers(1, 2**31 - 1,
                                                       size=n)]
