"""Leader-side node drainer (reference: nomad/drainer/ — NodeDrainer
drainer.go:130, deadline heap drain_heap.go, per-job pacing
watch_jobs.go, node watcher watch_nodes.go).

Draining never stops allocs directly: it marks them
DesiredTransition{migrate} in paced waves — at most the migrate stanza's
max_parallel in flight per task group — and lets the scheduler replace
them. System allocs drain only after every non-system alloc is gone
(unless ignore_system_jobs). At the drain deadline every remaining alloc
is force-migrated. When nothing drainable remains the node's drain is
cleared, leaving it ineligible.

The counterpart of `nomad_tpu.server.drainer`.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from ..structs import ALLOC_CLIENT_RUNNING, Allocation, Node

_log = logging.getLogger(__name__)

DEFAULT_MAX_PARALLEL = 1


class NodeDrainer:
    def __init__(self, server, poll_interval_s: float = 0.05):
        self.server = server
        self.poll_interval_s = poll_interval_s
        self._enabled = False
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool) -> None:
        thread = None
        with self._cv:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                # thread handle guarded by _cv
                self._thread = threading.Thread(target=self._watch,
                                                daemon=True)
                self._thread.start()
            else:
                thread, self._thread = self._thread, None
                self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=1.0)

    # --------------------------------------------------------------- loop
    def _watch(self) -> None:
        store = self.server.store
        while True:
            with self._cv:
                if not self._enabled:
                    return
            try:
                for node in list(store.nodes()):
                    if node.drain_strategy is not None:
                        self._drain_node(node)
            except Exception:
                _log.exception("drainer pass failed")
            store.wait_for_change(store.latest_index(),
                                  self.poll_interval_s * 4)

    # -------------------------------------------------------------- drain
    def _drain_node(self, node: Node) -> None:
        strategy = node.drain_strategy
        now = _time.time()
        allocs = [a for a in self.server.store.allocs_by_node(node.id)
                  if not a.terminal_status()]
        system, services = [], []
        for a in allocs:
            (system if a.job is not None and a.job.is_system()
             else services).append(a)

        force = (strategy.force_deadline > 0
                 and now >= strategy.force_deadline) \
            or strategy.deadline_s < 0          # -1: drain immediately

        if force:
            # deadline hit: everything remaining migrates NOW
            # (reference: drain_heap expiry -> watch_nodes force path)
            remaining = services + ([] if strategy.ignore_system_jobs
                                    else system)
            to_mark = [a for a in remaining
                       if not a.desired_transition.should_migrate()]
            if to_mark:
                self.server.drain_allocs([a.id for a in to_mark])
            if not remaining:
                self._finish(node)
            return

        if not services:
            # non-system work done: drain system allocs, then finish
            drainable_system = [] if strategy.ignore_system_jobs else system
            to_mark = [a for a in drainable_system
                       if not a.desired_transition.should_migrate()]
            if to_mark:
                self.server.drain_allocs([a.id for a in to_mark])
            if not drainable_system:
                self._finish(node)
            return

        # paced waves per (job, task group) honoring the migrate stanza;
        # batch allocs are never marked — they may run to the deadline
        # (reference: watch_jobs.go:333-335,401)
        by_tg: Dict[Tuple[str, str, str], List[Allocation]] = {}
        for a in services:
            if a.job is not None and a.job.is_batch():
                continue
            by_tg.setdefault((a.namespace, a.job_id, a.task_group),
                             []).append(a)
        mark: List[str] = []
        for (ns, job_id, tg_name), group_allocs in by_tg.items():
            job = group_allocs[0].job or \
                self.server.store.job_by_id(ns, job_id)
            tg = job.lookup_task_group(tg_name) if job else None
            max_parallel = (tg.migrate.max_parallel
                            if tg is not None and tg.migrate is not None
                            else DEFAULT_MAX_PARALLEL)
            count = tg.count if tg is not None else len(group_allocs)
            # reference pacing (watch_jobs.go:405-411):
            #   numToDrain = healthy - (count - max_parallel)
            healthy = self._healthy(ns, job_id, tg_name)
            allowed = min(
                healthy - (count - max_parallel),
                len([a for a in group_allocs
                     if not a.desired_transition.should_migrate()]))
            if allowed <= 0:
                continue
            candidates = [a for a in group_allocs
                          if not a.desired_transition.should_migrate()]
            mark.extend(a.id for a in candidates[:allowed])
        if mark:
            self.server.drain_allocs(mark)

    def _healthy(self, ns: str, job_id: str, tg_name: str) -> int:
        """Healthy-from-a-migration-standpoint count (reference:
        watch_jobs.go:371-375): non-terminal allocs whose health is
        reported, falling back to client_status running when no health
        tracking applies."""
        count = 0
        for a in self.server.store.allocs_by_job(ns, job_id):
            if a.task_group != tg_name or a.terminal_status():
                continue
            # an alloc already marked for migration is capacity in flight,
            # not stable capacity — counting it would let the next pass
            # mark a second wave before the first one even stops
            if a.desired_transition.should_migrate():
                continue
            if a.deployment_status is not None \
                    and a.deployment_status.healthy is not None:
                if a.deployment_status.is_healthy():
                    count += 1
            elif a.client_status == ALLOC_CLIENT_RUNNING:
                count += 1
        return count

    def _finish(self, node: Node) -> None:
        """Drain complete: clear the strategy, keep the node ineligible
        (reference: watch_nodes.go handleDoneNodes)."""
        self.server.update_node_drain(node.id, None, mark_eligible=False)
        _log.info("node %s drain complete", node.id[:8])
