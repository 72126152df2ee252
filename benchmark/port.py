"""The seeded plain data as the port's structs.

The one place where the benchmark builds `nomad_tpu_torch` objects
from `gen.py`'s data (the program under test gets only these); the
reference never sees them.  Frozen from `chip_smoke.py` (`make_nodes`,
`make_job`, `bench_group`, `resident_allocs`, `server_cluster`, at
commit e7763fa).
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np

from .gen import Cluster, JobSpec

#: resident allocs per raft entry while a server's cluster is entered
RESIDENT_CHUNK = 10_000


def nodes(cl: Cluster) -> list:
    """Port `Node`s in the cluster's order, nothing reserved."""
    from nomad_tpu_torch import mock
    out = []
    for pn in cl.nodes:
        n = mock.node(datacenter=pn.datacenter)
        n.id = pn.id
        n.name = pn.name
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.reserved_resources.disk_mb = 0
        n.attributes["kernel.name"] = "linux"
        n.attributes["rack"] = pn.rack
        n.attributes["zone"] = pn.zone
        n.node_resources.cpu = int(pn.cap[0])
        n.node_resources.memory_mb = int(pn.cap[1])
        n.node_resources.disk_mb = int(pn.cap[2])
        for net in n.node_resources.networks:
            net.mbits = int(pn.cap[3])
        n.compute_class()
        out.append(n)
    return out


class JobMaker:
    """Port `Job`s from a plain spec: the first is built in full, the
    rest are shallow copies under new ids (their groups are shared and
    never edited), so a stream of new jobs costs microseconds a job."""

    def __init__(self, spec: JobSpec):
        from nomad_tpu_torch import mock, structs
        job = mock.job()
        job.datacenters = list(spec.datacenters)
        job.constraints = [structs.Constraint(l, r, op)
                           for l, op, r in spec.constraints]
        job.affinities = [structs.Affinity(ltarget=l, rtarget=r, operand=op,
                                           weight=w)
                          for l, op, r, w in spec.affinities]
        job.spreads = [structs.Spread(attribute=a, weight=w)
                       for a, w in spec.spreads]
        base = job.task_groups[0]
        groups = []
        for g in spec.groups:
            tg = copy.deepcopy(base)
            tg.name = g.name
            tg.count = g.count
            tg.constraints = []
            tg.networks = []
            t = tg.tasks[0]
            t.resources.networks = []
            t.resources.cpu = int(g.ask[0])
            t.resources.memory_mb = int(g.ask[1])
            t.resources.devices = []
            tg.ephemeral_disk.size_mb = int(g.ask[2])
            groups.append(tg)
        job.task_groups = groups
        self._base = job

    def make(self, job_id: str):
        job = copy.copy(self._base)
        job.id = job_id
        job.name = job_id
        return job

    def full(self, job_id: str):
        """A job that shares nothing with the others (for the server,
        which stamps indexes on what it is handed)."""
        job = copy.deepcopy(self._base)
        job.id = job_id
        job.name = job_id
        return job


def asks(job) -> list:
    from nomad_tpu_torch.solver.tensorize import PlacementAsk
    return [PlacementAsk(job=job, tg=tg, count=tg.count)
            for tg in job.task_groups]


def used0(template, node_index: Dict[str, int], cl: Cluster) -> np.ndarray:
    """The resident usage in a ResidentSolver template's layout."""
    out = np.zeros_like(template.used0)
    usage = cl.resident_usage()
    for k, pn in enumerate(cl.nodes):
        out[node_index[pn.id], :usage.shape[1]] = usage[k]
    return out


def enter_cluster(srv, cl: Cluster, port_nodes: List) -> Dict[str, float]:
    """Register every node with a Server that has not started, then
    enter the resident job and its running allocs through raft entries
    (RESIDENT_CHUNK allocs a plan result), as the server path does.
    Returns the seconds each part took."""
    import time
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.structs import (AllocatedResources,
                                         AllocatedSharedResources,
                                         AllocatedTaskResources)
    from nomad_tpu_torch.utils.codec import to_wire
    from nomad_tpu_torch.utils.ids import generate_uuid
    t0 = time.perf_counter()
    for n in port_nodes:
        srv.register_node(n)
    t1 = time.perf_counter()
    cpu, mem, disk = (int(x) for x in cl.resident_ask[:3])
    total = int(cl.resident_per_node.sum())
    job = mock.job()
    job.id = "resident"
    tg = job.task_groups[0]
    tg.count = total
    tg.networks = []
    tg.ephemeral_disk.size_mb = disk
    for t in tg.tasks:
        t.resources.cpu, t.resources.memory_mb = cpu, mem
        t.resources.networks = []
    srv._propose("job_upsert", {"job": to_wire(job)})
    n_nodes = len(port_nodes)
    base = mock.alloc(job=job, node_id=port_nodes[0].id)
    base.allocated_resources = AllocatedResources(
        tasks={"web": AllocatedTaskResources(cpu=cpu, memory_mb=mem)},
        shared=AllocatedSharedResources(disk_mb=disk))
    base.client_status = structs.ALLOC_CLIENT_RUNNING
    base.job = None                   # the entry carries the job once
    allocs = []
    for k in range(total):
        a = copy.copy(base)           # nothing of `base` is edited in place
        a.id = generate_uuid()
        a.node_id = port_nodes[k % n_nodes].id
        a.name = f"{job.id}.{tg.name}[{k}]"
        allocs.append(a)
    for c in range(0, total, RESIDENT_CHUNK):
        result = structs.PlanResult()
        for a in allocs[c:c + RESIDENT_CHUNK]:
            result.node_allocation.setdefault(a.node_id, []).append(a)
        srv._propose("plan_result", {"result": to_wire(result),
                                     "job": to_wire(job)})
    return {"nodes_s": t1 - t0,
            "resident_allocs_s": time.perf_counter() - t1}
