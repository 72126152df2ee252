"""Task environment builder (reference: client/taskenv/env.go NewBuilder).

Builds the NOMAD_* env a task sees and interpolates ${...} references
(${attr.*}, ${meta.*}, ${node.*}, ${env.*}, ${NOMAD_*}) in task env
values and driver config strings — the same variable space constraints
use (scheduler/feasible.go:634-667).

The counterpart of `nomad_tpu.client.taskenv`.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from ..structs import Allocation, Node, Task

_VAR_RE = re.compile(r"\$\{([^}]+)\}")


def node_vars(node: Optional[Node]) -> Dict[str, str]:
    if node is None:
        return {}
    out = {
        "node.unique.id": node.id,
        "node.unique.name": node.name,
        "node.datacenter": node.datacenter,
        "node.class": node.node_class,
        "node.region": getattr(node, "region", "") or "global",
    }
    for k, v in (node.attributes or {}).items():
        out[f"attr.{k}"] = str(v)
    for k, v in (getattr(node, "meta", None) or {}).items():
        out[f"meta.{k}"] = str(v)
    return out


def interpolate(value: str, vars_: Dict[str, str]) -> str:
    def sub(m):
        return vars_.get(m.group(1), m.group(0))
    return _VAR_RE.sub(sub, value)


def build_task_env(alloc: Allocation, task: Task, node: Optional[Node],
                   task_dir: str = "", alloc_dir: str = "",
                   secrets_dir: str = "") -> Dict[str, str]:
    job = alloc.job
    tg = job.lookup_task_group(alloc.task_group) if job else None
    env: Dict[str, str] = {
        "NOMAD_ALLOC_ID": alloc.id,
        "NOMAD_SHORT_ALLOC_ID": alloc.id[:8],
        "NOMAD_ALLOC_NAME": alloc.name,
        "NOMAD_ALLOC_INDEX": str(max(alloc.index(), 0)),
        "NOMAD_GROUP_NAME": alloc.task_group,
        "NOMAD_TASK_NAME": task.name,
        "NOMAD_JOB_ID": alloc.job_id,
        "NOMAD_JOB_NAME": job.name if job else alloc.job_id,
        "NOMAD_NAMESPACE": alloc.namespace,
        "NOMAD_DC": node.datacenter if node else "",
        "NOMAD_REGION": (getattr(node, "region", "") or "global"
                         if node else "global"),
    }
    if task_dir:
        env["NOMAD_TASK_DIR"] = f"{task_dir}/local"
    if alloc_dir:
        env["NOMAD_ALLOC_DIR"] = alloc_dir
    if secrets_dir:
        env["NOMAD_SECRETS_DIR"] = secrets_dir
    if task.resources:
        env["NOMAD_CPU_LIMIT"] = str(task.resources.cpu)
        env["NOMAD_MEMORY_LIMIT"] = str(task.resources.memory_mb)
    # meta: job < group < task precedence, exported upper-cased
    meta: Dict[str, str] = {}
    for layer in ((job.meta if job else {}), (tg.meta if tg else {}),
                  task.meta or {}):
        meta.update(layer or {})
    for k, v in meta.items():
        env[f"NOMAD_META_{k.upper().replace('-', '_')}"] = str(v)
        env[f"NOMAD_META_{k}"] = str(v)
    # ports from the allocated resources
    tr = (alloc.allocated_resources.tasks or {}).get(task.name)
    if tr:
        for net in tr.networks or []:
            for port in list(net.reserved_ports) + list(net.dynamic_ports):
                if not port.label:
                    continue
                label = port.label.upper().replace("-", "_")
                env[f"NOMAD_PORT_{label}"] = str(port.value)
                env[f"NOMAD_IP_{label}"] = net.ip
                env[f"NOMAD_ADDR_{label}"] = f"{net.ip}:{port.value}"
                env[f"NOMAD_HOST_PORT_{label}"] = str(port.value)
    # user-declared env wins, with interpolation over node vars + NOMAD_*
    vars_ = dict(node_vars(node))
    vars_.update({f"env.{k}": v for k, v in env.items()})
    vars_.update(env)
    for k, v in (task.env or {}).items():
        env[k] = interpolate(str(v), vars_)
    return env


def interpolate_config(config, vars_: Dict[str, str]):
    """Recursively interpolate strings in a driver config block."""
    if isinstance(config, str):
        return interpolate(config, vars_)
    if isinstance(config, dict):
        return {k: interpolate_config(v, vars_) for k, v in config.items()}
    if isinstance(config, list):
        return [interpolate_config(v, vars_) for v in config]
    return config
