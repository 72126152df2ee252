"""Set algebra over allocations + alloc-name index reuse.

Pure host code — the reconciler's primitives. Reference semantics:
scheduler/reconcile_util.go (allocSet ops :113-195, filterByTainted :197,
filterByRescheduleable :237, allocNameIndex :384, bitmapFrom :396).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..structs import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                       ALLOC_CLIENT_LOST, ALLOC_DESIRED_EVICT,
                       ALLOC_DESIRED_STOP, Allocation,
                       Deployment, Node, alloc_name)
from ..utils.bitmap import Bitmap

# An alloc within this window of its reschedule time is rescheduled now
# rather than via a delayed follow-up eval.
RESCHEDULE_WINDOW_S = 1.0

AllocSet = Dict[str, Allocation]


def alloc_set(allocs: Iterable[Allocation]) -> AllocSet:
    return {a.id: a for a in allocs}


def union(*sets: AllocSet) -> AllocSet:
    out: AllocSet = {}
    for s in sets:
        out.update(s)
    return out


def difference(base: AllocSet, *others: AllocSet) -> AllocSet:
    removed: Set[str] = set()
    for s in others:
        removed.update(s.keys())
    return {k: v for k, v in base.items() if k not in removed}


def from_keys(base: AllocSet, keys: Iterable[str]) -> AllocSet:
    return {k: base[k] for k in keys if k in base}


def name_order(s: AllocSet) -> List[Allocation]:
    """Deterministic iteration: by name then id."""
    return sorted(s.values(), key=lambda a: (a.name, a.id))


def name_set(s: AllocSet) -> Set[str]:
    return {a.name for a in s.values()}


def filter_by_deployment(s: AllocSet, deployment_id: str
                         ) -> Tuple[AllocSet, AllocSet]:
    """Returns (part_of, not_part_of)."""
    match, rest = {}, {}
    for k, a in s.items():
        (match if a.deployment_id == deployment_id else rest)[k] = a
    return match, rest


def filter_non_terminal(s: AllocSet) -> AllocSet:
    return {k: a for k, a in s.items() if not a.terminal_status()}


def filter_by_tainted(s: AllocSet, tainted: Dict[str, Optional[Node]]
                      ) -> Tuple[AllocSet, AllocSet, AllocSet]:
    """Split into (untainted, migrate, lost) given the tainted-node map
    (node_id -> Node or None for deregistered nodes)."""
    untainted: AllocSet = {}
    migrate: AllocSet = {}
    lost: AllocSet = {}
    for k, a in s.items():
        # terminal allocs never migrate
        if a.terminal_status():
            untainted[k] = a
            continue
        # drainer marks allocs for migration explicitly
        if a.desired_transition.should_migrate():
            migrate[k] = a
            continue
        if a.node_id not in tainted:
            untainted[k] = a
            continue
        n = tainted[a.node_id]
        if n is None or n.terminal_status():
            lost[k] = a
        else:
            untainted[k] = a
    return untainted, migrate, lost


def _should_filter(a: Allocation, is_batch: bool) -> Tuple[bool, bool]:
    """Returns (untainted, ignore): whether the alloc should be kept as-is
    or dropped from consideration, before reschedule classification."""
    if is_batch:
        # batch: a stopped alloc that finished its work stays accounted for;
        # one that was stopped mid-run is simply gone.
        if a.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            if a.ran_successfully():
                return True, False
            return False, True
        if a.client_status != ALLOC_CLIENT_FAILED:
            return True, False
        return False, False
    # service/system
    if a.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
        return False, True
    if a.client_status in (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_LOST):
        return False, True
    return False, False


def _update_by_reschedulable(a: Allocation, now: float, eval_id: str,
                             deployment: Optional[Deployment]
                             ) -> Tuple[bool, bool, float]:
    """Returns (reschedule_now, reschedule_later, reschedule_time)."""
    # during an active deployment only explicitly-marked allocs reschedule
    if (deployment is not None and a.deployment_id == deployment.id
            and deployment.active()
            and not (a.desired_transition.reschedule is True)):
        return False, False, 0.0
    if a.desired_transition.should_force_reschedule():
        return True, False, 0.0
    policy = None
    if a.job is not None:
        tg = a.job.lookup_task_group(a.task_group)
        if tg is not None:
            policy = tg.reschedule_policy
    resched_time, eligible = a.next_reschedule_time(policy)
    if eligible and (a.follow_up_eval_id == eval_id
                     or resched_time - now <= RESCHEDULE_WINDOW_S):
        return True, False, resched_time
    if eligible and not a.follow_up_eval_id:
        return False, True, resched_time
    return False, False, 0.0


def filter_by_rescheduleable(s: AllocSet, is_batch: bool, now: float,
                             eval_id: str,
                             deployment: Optional[Deployment]
                             ) -> Tuple[AllocSet, AllocSet,
                                        List[Tuple[Allocation, float]]]:
    """Split into (untainted, reschedule_now, reschedule_later) where
    reschedule_later entries carry their eligible reschedule time."""
    untainted: AllocSet = {}
    resched_now: AllocSet = {}
    resched_later: List[Tuple[Allocation, float]] = []
    for k, a in s.items():
        # already replaced by a newer allocation
        if a.next_allocation:
            continue
        if not is_batch and a.server_terminal_status():
            continue
        is_untainted, ignore = _should_filter(a, is_batch)
        if is_untainted:
            untainted[k] = a
        if is_untainted or ignore:
            continue
        now_ok, later_ok, when = _update_by_reschedulable(
            a, now, eval_id, deployment)
        if now_ok:
            resched_now[k] = a
        elif later_ok:
            # stays in place (still running its restart policy out) but a
            # follow-up eval is scheduled for it
            untainted[k] = a
            resched_later.append((a, when))
        else:
            untainted[k] = a
    return untainted, resched_now, resched_later


def bitmap_from(s: AllocSet, min_size: int) -> Bitmap:
    """Bitmap of name indexes in use (reference: bitmapFrom :396)."""
    size = min_size
    for a in s.values():
        idx = a.index()
        if idx + 1 > size:
            size = idx + 1
    if size == 0:
        size = 8
    b = Bitmap(size)
    for a in s.values():
        idx = a.index()
        if idx >= 0:
            b.set(idx)
    return b


class AllocNameIndex:
    """Tracks which `job.group[i]` names are in use so replacements reuse
    the lowest free indexes (reference: allocNameIndex :384)."""

    def __init__(self, job_id: str, task_group: str, count: int,
                 in_use: AllocSet):
        self.job_id = job_id
        self.task_group = task_group
        self.count = count
        self.b = bitmap_from(in_use, count)
        self._duplicates: Dict[int, int] = {}
        seen: Set[int] = set()
        for a in in_use.values():
            idx = a.index()
            if idx >= 0:
                if idx in seen:
                    self._duplicates[idx] = self._duplicates.get(idx, 0) + 1
                seen.add(idx)

    def _name(self, idx: int) -> str:
        return alloc_name(self.job_id, self.task_group, idx)

    def set_index(self, idx: int) -> None:
        if 0 <= idx < self.b.size:
            self.b.set(idx)

    def unset_index(self, idx: int) -> None:
        if 0 <= idx < self.b.size:
            if self._duplicates.get(idx):
                self._duplicates[idx] -= 1
                if self._duplicates[idx] == 0:
                    del self._duplicates[idx]
            else:
                self.b.unset(idx)

    def highest(self, n: int) -> Set[str]:
        """Names of the n highest set indexes (candidates for removal on
        scale-down)."""
        out: Set[str] = set()
        for idx in reversed(self.b.indexes_in_range(True, 0, self.b.size - 1)):
            out.add(self._name(idx))
            if len(out) == n:
                break
        return out

    def next(self, n: int) -> List[str]:
        """The next n unused names, lowest index first."""
        out: List[str] = []
        for idx in self.b.indexes_in_range(False, 0, self.count - 1):
            out.append(self._name(idx))
            self.b.set(idx)
            if len(out) == n:
                return out
        # overflow past count (e.g. canary overlap): continue upward
        idx = self.count
        while len(out) < n:
            if idx >= self.b.size or not self.b.check(idx):
                out.append(self._name(idx))
                if idx < self.b.size:
                    self.b.set(idx)
            idx += 1
        return out

    def next_canaries(self, n: int, existing: AllocSet,
                      destructive: AllocSet) -> List[str]:
        """Pick canary names: prefer indexes of allocs being destructively
        replaced (their names free up), then unset indexes, then overflow."""
        out: List[str] = []
        existing_names = name_set(existing)
        dmap = bitmap_from(destructive, self.count)
        for idx in dmap.indexes_in_range(True, 0, self.count - 1):
            name = self._name(idx)
            if name not in existing_names:
                out.append(name)
                self.set_index(idx)
                if len(out) == n:
                    return out
        for idx in self.b.indexes_in_range(False, 0, self.count - 1):
            name = self._name(idx)
            if name not in existing_names:
                out.append(name)
                self.set_index(idx)
                if len(out) == n:
                    return out
        idx = self.count
        while len(out) < n:
            name = self._name(idx)
            if name not in existing_names and (
                    idx >= self.b.size or not self.b.check(idx)):
                out.append(name)
                self.set_index(idx)
            idx += 1
        return out
