"""Canonical fixtures (reference: nomad/mock/mock.go): the node, job and
alloc builders of `nomad_tpu.mock`, for the port's tests and
chip_smoke.py."""
from __future__ import annotations

import itertools
import time

from . import structs
from .structs import (AllocatedResources, AllocatedSharedResources,
                      AllocatedTaskResources, Allocation, Constraint, Job,
                      NetworkResource, Node, NodeReservedResources,
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
