"""Scheduler-shared utilities.

Reference semantics: scheduler/util.go — taintedNodes :312,
updateNonTerminalAllocsToLost :817, tasksUpdated :351,
adjustQueuedAllocations :788, retryMax :277.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import (ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING,
                       ALLOC_CLIENT_LOST, ALLOC_DESIRED_EVICT,
                       ALLOC_DESIRED_STOP, ALLOC_LOST, NODE_STATUS_DOWN,
                       Allocation, Job, Node,
                       Plan, PlanResult, TaskGroup)


def tainted_nodes(snapshot, allocs: List[Allocation]
                  ) -> Dict[str, Optional[Node]]:
    """Map of node id -> node for nodes hosting these allocs that are
    down, draining, or deregistered (None)."""
    out: Dict[str, Optional[Node]] = {}
    seen = set()
    for a in allocs:
        if a.node_id in seen:
            continue
        seen.add(a.node_id)
        node = snapshot.node_by_id(a.node_id)
        if node is None:
            out[a.node_id] = None
        elif node.terminal_status() or node.drain:
            out[a.node_id] = node
    return out


def update_non_terminal_allocs_to_lost(plan: Plan,
                                       tainted: Dict[str, Optional[Node]],
                                       allocs: List[Allocation]) -> None:
    """Allocs already marked stop/evict whose client never acked, sitting
    on a dead node, are marked lost in the plan."""
    for a in allocs:
        if a.node_id not in tainted:
            continue
        node = tainted[a.node_id]
        if node is not None and node.status != NODE_STATUS_DOWN:
            continue
        if (a.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)
                and a.client_status in (ALLOC_CLIENT_RUNNING,
                                        ALLOC_CLIENT_PENDING)):
            plan.append_stopped_alloc(a, ALLOC_LOST, ALLOC_CLIENT_LOST)


def tasks_updated(job_a: Job, job_b: Job, group: str) -> bool:
    """Whether the group changed in a way that needs a destructive update
    (reference: util.go:351)."""
    a = job_a.lookup_task_group(group)
    b = job_b.lookup_task_group(group)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if _nets_updated(a.networks, b.networks):
        return True
    if {k: v.__dict__ for k, v in a.volumes.items()} != \
            {k: v.__dict__ for k, v in b.volumes.items()}:
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config or at.env != bt.env:
            return True
        if ([x.__dict__ for x in at.artifacts]
                != [x.__dict__ for x in bt.artifacts]):
            return True
        if at.meta != bt.meta:
            return True
        if ([t.__dict__ for t in at.templates]
                != [t.__dict__ for t in bt.templates]):
            return True
        ar, br = at.resources, bt.resources
        if ar.cpu != br.cpu or ar.memory_mb != br.memory_mb:
            return True
        if _nets_updated(ar.networks, br.networks):
            return True
        if ([d.__dict__ for d in ar.devices]
                != [d.__dict__ for d in br.devices]):
            return True
    return False


def _nets_updated(a, b) -> bool:
    if len(a) != len(b):
        return True
    for an, bn in zip(a, b):
        if an.mbits != bn.mbits:
            return True
        if len(an.dynamic_ports) != len(bn.dynamic_ports):
            return True
        if ({(p.label, p.value, p.to) for p in an.reserved_ports}
                != {(p.label, p.value, p.to) for p in bn.reserved_ports}):
            return True
    return False


def adjust_queued_allocations(result: Optional[PlanResult],
                              queued: Dict[str, int]) -> None:
    """Decrement queued counts by what the plan actually placed."""
    if result is None:
        return
    for allocs in result.node_allocation.values():
        for a in allocs:
            # only count allocations created by this plan
            if result.alloc_index and a.create_index != result.alloc_index:
                continue
            if a.task_group in queued:
                queued[a.task_group] = max(0, queued[a.task_group] - 1)


def retry_max(limit: int, fn: Callable[[], Tuple[bool, object]],
              reset_fn: Optional[Callable[[], bool]] = None):
    """Run fn up to `limit` times, resetting the attempt budget whenever
    reset_fn reports progress (reference: util.go:277)."""
    attempts = 0
    while attempts < limit:
        done, err = fn()
        if err is not None:
            return err
        if done:
            return None
        if reset_fn is not None and reset_fn():
            attempts = 0
        else:
            attempts += 1
    return "max-retries"


def in_place_fits(snapshot, existing: Allocation, job: Job, tg: TaskGroup,
                  plan: Plan) -> Optional[Allocation]:
    """Can `existing` be updated in place on its node? Returns the updated
    allocation (new job/resources) or None (reference: util.go:552
    inplaceUpdate — re-checks feasibility and fit against proposed state
    minus the alloc itself)."""
    from . import feasible as hostfeas
    from ..solver.solve import Solver
    from ..solver.tensorize import PlacementAsk

    node = snapshot.node_by_id(existing.node_id)
    if node is None:
        return None
    ok, _reason = hostfeas.group_feasible(node, job, tg)
    if not ok:
        return None

    # proposed allocs on the node: live state minus plan stops minus self
    stopped = {a.id for allocs in plan.node_update.values() for a in allocs}
    proposed = [a for a in snapshot.allocs_by_node(node.id)
                if not a.terminal_status()
                and a.id not in stopped and a.id != existing.id]
    proposed.extend(plan.node_allocation.get(node.id, []))

    out = Solver._host_commit(node, 0, PlacementAsk(job=job, tg=tg, count=1),
                              {}, {}, {node.id: proposed})
    if out is None:
        return None

    # total cpu/mem/disk must still fit alongside the other allocs
    from ..structs.funcs import allocs_fit
    updated = copy.copy(existing)
    updated.job = job
    updated.allocated_resources = out
    fit, _dim, _used = allocs_fit(node, proposed + [updated])
    if not fit:
        return None
    return updated


def generic_alloc_update_fn(snapshot, plan: Plan):
    """Build the reconciler's alloc_update_fn closure
    (reference: util.go:846 genericAllocUpdateFn)."""
    def update_fn(existing: Allocation, new_job: Job, new_tg: TaskGroup
                  ) -> Tuple[bool, bool, Optional[Allocation]]:
        # same version: nothing to do (reference: util.go:846 "Same
        # index, so nothing to do" — the check belongs HERE, not in the
        # reconciler, so tests can drive update decisions directly)
        if existing.job is not None and \
                existing.job.version == new_job.version:
            return True, False, None
        if existing.job is not None and tasks_updated(
                existing.job, new_job, new_tg.name):
            return False, True, None
        updated = in_place_fits(snapshot, existing, new_job, new_tg, plan)
        if updated is None:
            return False, True, None
        return False, False, updated
    return update_fn
