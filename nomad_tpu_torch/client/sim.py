"""Simulated node agent for in-process end-to-end tests.

A thin stand-in for the full client (reference: client/client.go —
watchAllocations :1924, runAllocs :2147, allocSync :1858): polls the
server for allocs desired on its node, "runs" them through a scriptable
mock driver, and pushes client-status updates back. The real agent
(fingerprinting, task runner hooks, exec drivers) is SURVEY §7.2 step 9.

The counterpart of `nomad_tpu.client.sim`.
"""
from __future__ import annotations

import copy
import threading
import time as _time
from typing import Callable, Dict, Optional

from ..structs import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                       ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING,
                       ALLOC_DESIRED_RUN, Allocation, Node, TaskState)

# mock driver behavior: config key "mock_outcome" on the task drives it
#   run        -> runs until stopped (default)
#   complete   -> finishes successfully after mock_runtime_s
#   fail       -> fails after mock_runtime_s


class SimClient:
    def __init__(self, server, node: Node, poll_interval_s: float = 0.02):
        self.server = server
        self.node = node
        self.poll_interval_s = poll_interval_s
        self._known: Dict[str, str] = {}    # alloc id -> client status
        self._started_at: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.server.register_node(self.node)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    # ------------------------------------------------------------- loop
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._sync_once()
            except Exception:
                pass
            self._stop.wait(self.poll_interval_s)

    def _sync_once(self) -> None:
        updates = []
        for alloc in self.server.store.allocs_by_node(self.node.id):
            if alloc.desired_status != ALLOC_DESIRED_RUN:
                if (self._known.get(alloc.id) == ALLOC_CLIENT_RUNNING
                        and not alloc.client_terminal_status()):
                    updates.append(self._terminal(alloc,
                                                  ALLOC_CLIENT_COMPLETE))
                continue
            status = self._known.get(alloc.id)
            if status is None and not alloc.client_terminal_status():
                updates.append(self._transition(alloc, ALLOC_CLIENT_RUNNING))
                self._started_at[alloc.id] = _time.time()
            elif status == ALLOC_CLIENT_RUNNING:
                outcome, runtime = self._mock_config(alloc)
                elapsed = _time.time() - self._started_at.get(alloc.id, 0)
                if outcome == "complete" and elapsed >= runtime:
                    updates.append(self._terminal(alloc,
                                                  ALLOC_CLIENT_COMPLETE))
                elif outcome == "fail" and elapsed >= runtime:
                    updates.append(self._terminal(alloc,
                                                  ALLOC_CLIENT_FAILED))
        if updates:
            self.server.update_allocs_from_client(updates)

    def _mock_config(self, alloc: Allocation):
        job = alloc.job
        if job is None:
            return "run", 0.0
        tg = job.lookup_task_group(alloc.task_group)
        if tg is None or not tg.tasks:
            return "run", 0.0
        cfg = tg.tasks[0].config or {}
        return (cfg.get("mock_outcome", "run"),
                float(cfg.get("mock_runtime_s", 0.0)))

    def _transition(self, alloc: Allocation, status: str) -> Allocation:
        self._known[alloc.id] = status
        upd = copy.copy(alloc)
        upd.client_status = status
        upd.task_states = {
            t.name: TaskState(state="running", started_at=_time.time())
            for t in (alloc.job.lookup_task_group(alloc.task_group).tasks
                      if alloc.job else [])}
        # deployment allocs report health immediately on running (the real
        # client's health watcher waits min_healthy_time; the sim keeps
        # e2e deployment tests fast)
        if alloc.deployment_id and status == ALLOC_CLIENT_RUNNING:
            from ..structs import AllocDeploymentStatus
            upd.deployment_status = AllocDeploymentStatus(
                healthy=True, timestamp=_time.time())
        upd.modify_time = _time.time()
        return upd

    def _terminal(self, alloc: Allocation, status: str) -> Allocation:
        self._known[alloc.id] = status
        now = _time.time()
        failed = status == ALLOC_CLIENT_FAILED
        upd = copy.copy(alloc)
        upd.client_status = status
        upd.task_states = {
            t.name: TaskState(state="dead", failed=failed, finished_at=now)
            for t in (alloc.job.lookup_task_group(alloc.task_group).tasks
                      if alloc.job else [])}
        if alloc.deployment_id and failed:
            from ..structs import AllocDeploymentStatus
            upd.deployment_status = AllocDeploymentStatus(
                healthy=False, timestamp=now)
        upd.modify_time = now
        return upd


def wait_until(predicate: Callable[[], bool], timeout: float = 5.0,
               interval: float = 0.02) -> bool:
    """Poll-until-true helper (reference: testutil/wait.go WaitForResult)."""
    deadline = _time.time() + timeout
    while _time.time() < deadline:
        if predicate():
            return True
        _time.sleep(interval)
    return False
