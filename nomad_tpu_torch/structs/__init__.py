"""Domain model for the placement solve (the counterpart of
`nomad_tpu.structs`, reduced to the types the solver slice uses)."""
from .consts import *  # noqa: F401,F403
from .resources import (AllocatedDeviceResource, AllocatedResources,
                        AllocatedSharedResources, AllocatedTaskResources,
                        ComparableResources, NetworkResource, NodeDevice,
                        NodeDeviceResource, NodeReservedResources,
                        NodeResources, Port, RequestedDevice, Resources)
from .node import Node, resolve_node_target
from .job import (Affinity, Constraint, EphemeralDisk, Job,
                  ReschedulePolicy, RestartPolicy, Spread, SpreadTarget,
                  Task, TaskGroup)
from .alloc import AllocMetric, Allocation
from .network import NetworkIndex
from .devices import DeviceAccounter
