"""Domain model (the counterpart of `nomad_tpu.structs`, with the same
exports): what the placement solve, the state store and the schedulers
pass around.  `diff.py` holds the job diffs of the plan endpoint."""
from .consts import *  # noqa: F401,F403
from .resources import (AllocatedDeviceResource, AllocatedResources,
                        AllocatedSharedResources, AllocatedTaskResources,
                        ComparableResources, NetworkResource, NodeDevice,
                        NodeDeviceResource, NodeReservedResources,
                        NodeResources, Port, RequestedDevice, Resources)
from .node import (DrainStrategy, DriverInfo, HostVolumeConfig, Node,
                   NodeEvent, resolve_node_target, is_unique_key)
from .job import (Affinity, Artifact, Constraint, DispatchPayloadConfig,
                  EphemeralDisk, Job, LogConfig, MigrateStrategy,
                  ParameterizedJobConfig, PeriodicConfig, ReschedulePolicy,
                  RestartPolicy, Service, ServiceCheck, Spread, SpreadTarget,
                  Task, TaskGroup, Template, UpdateStrategy, VolumeMount,
                  VolumeRequest)
from .alloc import (AllocDeploymentStatus, AllocMetric, Allocation,
                    DesiredTransition, RescheduleEvent, RescheduleTracker,
                    TaskEvent, TaskState, alloc_name)
from .eval_plan import (Deployment, DeploymentState, DeploymentStatusUpdate,
                        Evaluation, Plan, PlanResult)
from .funcs import (BINPACK_MAX_FIT_SCORE, allocs_fit, filter_terminal_allocs,
                    score_fit)
from .network import NetworkIndex
from .devices import DeviceAccounter

from .csi import (ACCESS_MULTI_NODE_MULTI_WRITER, ACCESS_MULTI_NODE_READER,
                  ACCESS_MULTI_NODE_SINGLE_WRITER, ACCESS_SINGLE_NODE_READER,
                  ACCESS_SINGLE_NODE_WRITER, ATTACH_BLOCK_DEVICE,
                  ATTACH_FILE_SYSTEM, CLAIM_READ, CLAIM_WRITE, CSIPlugin,
                  CSIPluginNodeInfo, CSIVolume, aggregate_plugins)
