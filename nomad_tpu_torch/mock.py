"""Canonical fixtures (reference: nomad/mock/mock.go): the node, GPU
node, job, system job, batch job, eval and alloc factories of
`nomad_tpu.mock`, for the port's tests and chip_smoke.py."""
from __future__ import annotations

import itertools
import time

from . import structs
from .structs import (AllocatedResources, AllocatedSharedResources,
                      AllocatedTaskResources, Allocation, Constraint,
                      Evaluation, Job, NetworkResource, Node, NodeDevice,
                      NodeDeviceResource, NodeReservedResources,
                      NodeResources, Port, ReschedulePolicy, Resources,
                      RestartPolicy, Task, TaskGroup)
from .utils.ids import generate_uuid

_counter = itertools.count()


def node(**kw) -> Node:
    i = next(_counter)
    n = Node(
        id=generate_uuid(),
        secret_id=generate_uuid(),
        name=f"foobar-{i}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.5.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "cpu.numcores": "4",
        },
        node_resources=NodeResources(
            cpu=4000, memory_mb=8192, disk_mb=100 * 1024,
            networks=[NetworkResource(device="eth0", cidr="192.168.0.100/32",
                                      ip=f"192.168.0.{100 + (i % 100)}",
                                      mbits=1000)]),
        reserved_resources=NodeReservedResources(
            cpu=100, memory_mb=256, disk_mb=4 * 1024,
            reserved_host_ports="22"),
        status=structs.NODE_STATUS_READY,
    )
    for k, v in kw.items():
        setattr(n, k, v)
    n.compute_class()
    return n


def gpu_node(n_gpus: int = 4, **kw) -> Node:
    n = node(**kw)
    n.node_resources.devices = [NodeDeviceResource(
        vendor="nvidia", type="gpu", name="1080ti",
        instances=[NodeDevice(id=generate_uuid(), healthy=True)
                   for _ in range(n_gpus)],
        attributes={"memory_mib": 11264, "cuda_cores": 3584})]
    n.compute_class()
    return n


def job(**kw) -> Job:
    j = Job(
        id=f"mock-service-{generate_uuid()}",
        name="my-job",
        type=structs.JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}",
                                rtarget="linux", operand="=")],
        task_groups=[TaskGroup(
            name="web",
            count=10,
            restart_policy=RestartPolicy(attempts=3, interval_s=600,
                                         delay_s=60, mode="delay"),
            reschedule_policy=ReschedulePolicy(
                attempts=2, interval_s=600, delay_s=5,
                delay_function="constant", unlimited=False),
            tasks=[Task(
                name="web", driver="exec",
                config={"command": "/bin/date"},
                env={"FOO": "bar"},
                resources=Resources(
                    cpu=500, memory_mb=256,
                    networks=[NetworkResource(
                        mbits=50,
                        dynamic_ports=[Port(label="http"),
                                       Port(label="admin")])]),
            )],
            meta={"elb_check_type": "http"},
        )],
        meta={"owner": "armon"},
        status=structs.JOB_STATUS_PENDING,
        version=0,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    for k, v in kw.items():
        setattr(j, k, v)
    j.canonicalize()
    return j


def system_job(**kw) -> Job:
    j = Job(
        id=f"mock-system-{generate_uuid()}",
        name="my-job",
        type=structs.JOB_TYPE_SYSTEM,
        priority=100,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}",
                                rtarget="linux", operand="=")],
        task_groups=[TaskGroup(
            name="web", count=1,
            restart_policy=RestartPolicy(attempts=3, interval_s=600,
                                         delay_s=60, mode="delay"),
            ephemeral_disk=structs.EphemeralDisk(size_mb=150),
            tasks=[Task(name="web", driver="exec",
                        config={"command": "/bin/date"},
                        resources=Resources(cpu=500, memory_mb=256))],
        )],
        meta={"owner": "armon"},
        status=structs.JOB_STATUS_PENDING,
        create_index=42, modify_index=99, job_modify_index=99,
    )
    for k, v in kw.items():
        setattr(j, k, v)
    j.canonicalize()
    return j


def batch_job(**kw) -> Job:
    j = job(**kw)
    j.type = structs.JOB_TYPE_BATCH
    j.id = f"mock-batch-{generate_uuid()}"
    for tg in j.task_groups:
        tg.reschedule_policy = ReschedulePolicy.default_batch()
    for k, v in kw.items():
        setattr(j, k, v)
    return j


def eval_(**kw) -> Evaluation:
    e = Evaluation(
        namespace=structs.DEFAULT_NAMESPACE,
        type=structs.JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        priority=50,
        triggered_by=structs.EVAL_TRIGGER_JOB_REGISTER,
        status=structs.EVAL_STATUS_PENDING,
    )
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def alloc(**kw) -> Allocation:
    j = kw.pop("job", None) or job()
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        node_id="12345678-abcd-efab-cdef-123456789abc",
        namespace=structs.DEFAULT_NAMESPACE,
        task_group="web",
        job_id=j.id,
        job=j,
        name=f"{j.id}.web[0]",
        allocated_resources=AllocatedResources(
            tasks={"web": AllocatedTaskResources(
                cpu=500, memory_mb=256,
                networks=[NetworkResource(
                    device="eth0", ip="192.168.0.100", mbits=50,
                    reserved_ports=[Port(label="admin", value=5000)],
                    dynamic_ports=[Port(label="http", value=9876)])])},
            shared=AllocatedSharedResources(disk_mb=150)),
        desired_status=structs.ALLOC_DESIRED_RUN,
        client_status=structs.ALLOC_CLIENT_PENDING,
        create_time=time.time(),
        modify_time=time.time(),
    )
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def rich_solve_batch(n_nodes: int, count: int, seed_ix: int = 0):
    """One packed placement problem that exercises every dimension of
    the solve: a constraint, an affinity, a spread and a device ask over
    a quarter of the nodes (the reference's multichip workload and the
    mesh tests' shared problem)."""
    from .solver.tensorize import PlacementAsk, Tensorizer
    from .structs import Affinity, RequestedDevice, Spread
    nodes = []
    for i in range(n_nodes):
        n = node()
        n.attributes["rack"] = f"r{(i + seed_ix) % 8}"
        n.node_resources.cpu = 4000 + (i % 4) * 1000
        if i % 4 == 0:
            n.node_resources.devices = [NodeDeviceResource(
                vendor="google", type="tpu", name="v4",
                instances=[NodeDevice(id=f"tpu-{i}-{k}", healthy=True)
                           for k in range(2)])]
        n.compute_class()
        nodes.append(n)
    j = job()
    j.constraints = [Constraint("${attr.rack}", "r7", "!=")]
    j.affinities = [Affinity(ltarget="${attr.rack}", rtarget="r3",
                             operand="=", weight=40)]
    j.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    tg = j.task_groups[0]
    tg.count = count
    for t in tg.tasks:
        t.resources.networks = []
    tg.tasks[0].resources.devices = [
        RequestedDevice(name="google/tpu/v4", count=1)]
    return Tensorizer().pack(nodes, [PlacementAsk(job=j, tg=tg,
                                                  count=count)], None)
