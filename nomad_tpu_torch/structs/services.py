"""Native service discovery registrations.

Reference: Nomad registers task services either into Consul
(command/agent/consul/) or — in later versions — into its own state as
native service discovery (the /v1/services surface). This package
implements the NATIVE form: registrations are derived server-side from
alloc/task state transitions (deterministic in the FSM, so every
replica holds the same catalog) and served from /v1/services with
blocking-query indexes. Health mirrors task liveness; script/http
check execution stays a client-side concern (checks are parsed and
carried, not yet executed)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ServiceRegistration:
    id: str = ""                  # "<alloc_id>-<task>-<service>"
    service_name: str = ""
    namespace: str = "default"
    job_id: str = ""
    alloc_id: str = ""
    node_id: str = ""
    task: str = ""
    address: str = ""
    port: int = 0
    tags: List[str] = field(default_factory=list)
    healthy: bool = True
    create_index: int = 0
    modify_index: int = 0
