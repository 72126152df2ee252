"""Per-allocation runner (reference: client/allocrunner/alloc_runner.go —
Run :276, Restore :380, task-state fan-in handleTaskStateUpdates :443
with leader-kill ordering, clientAlloc status rollup :600, destroy :803;
health watching from alloc_runner's health_hook + client/allochealth).

Owns one TaskRunner per task, rolls task states up into the alloc's
client status, watches deployment health, and reports every change
upward through `on_alloc_update` (the allocSync feed).

The counterpart of `nomad_tpu.client.allocrunner`.  Its CSI prerun hook
(stage and publish each volume, bind it into the task dirs, unmount at
postrun) comes with CSI (ROADMAP.md Queue 1 item 16b): until then a
client has no CSI manager, and an alloc that asks for a CSI volume fails
before any task starts, through the reference's own branch and message.
"""
from __future__ import annotations

import copy
import logging
import threading
import time as _time
from typing import Callable, Dict, List, Optional

from ..structs import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                       ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING,
                       TASK_STATE_DEAD, TASK_STATE_RUNNING, Allocation,
                       AllocDeploymentStatus, Node, TaskState)
from .allocdir import AllocDir
from .taskrunner import TaskRunner

_log = logging.getLogger(__name__)


def client_status_from_tasks(states: Dict[str, TaskState]) -> str:
    """reference: alloc_runner.go:600 clientAlloc / getClientStatus."""
    if not states:
        return ALLOC_CLIENT_PENDING
    vals = list(states.values())
    if any(ts.state == TASK_STATE_RUNNING for ts in vals):
        # a failed sibling makes the alloc failed even while others run
        if any(ts.failed for ts in vals):
            return ALLOC_CLIENT_FAILED
        return ALLOC_CLIENT_RUNNING
    if all(ts.state == TASK_STATE_DEAD for ts in vals):
        return (ALLOC_CLIENT_FAILED if any(ts.failed for ts in vals)
                else ALLOC_CLIENT_COMPLETE)
    if any(ts.failed for ts in vals):
        return ALLOC_CLIENT_FAILED
    return ALLOC_CLIENT_PENDING


class AllocRunner:
    def __init__(self, alloc: Allocation, data_dir: str, registry,
                 node: Optional[Node],
                 on_alloc_update: Callable[[Allocation], None],
                 state_db=None, device_registry=None,
                 secrets_fetcher=None, prev_migrator=None):
        self.alloc = alloc
        self.registry = registry
        self.device_registry = device_registry
        self.secrets_fetcher = secrets_fetcher
        #: callable(alloc, alloc_dir) bringing a migrate=true previous
        #: alloc's ephemeral disk here before tasks start (reference:
        #: client/allocwatcher prerun gate)
        self.prev_migrator = prev_migrator
        self.node = node
        self.on_alloc_update = on_alloc_update
        self.state_db = state_db
        self.alloc_dir = AllocDir(data_dir, alloc.id)
        self.task_runners: List[TaskRunner] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._destroyed = False
        self._killing = False
        self._waiter: Optional[threading.Thread] = None
        self._health: Optional[threading.Thread] = None
        self._health_stop = threading.Event()
        self._health_reported: Optional[bool] = None
        self._build_runners()

    def _build_runners(self) -> None:
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        if tg is None:
            return
        for task in tg.tasks:
            driver = self.registry.get(task.driver)
            if driver is None:
                raise ValueError(f"unknown driver {task.driver!r} "
                                 f"for task {task.name}")
            self.task_runners.append(TaskRunner(
                self.alloc, task, self.alloc_dir, driver, self.node,
                self._on_task_state_change, state_db=self.state_db,
                device_registry=self.device_registry,
                secrets_fetcher=self.secrets_fetcher))

    # ---------------------------------------------------------- lifecycle
    def _mount_csi_volumes(self) -> None:
        """Prerun CSI hook (reference: alloc_runner_hooks.go csi_hook).
        A mount failure fails the whole alloc before any task starts,
        like the reference's prerun hook failure path; this client has
        no CSI manager, so any CSI volume request fails here."""
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        if tg is None or not getattr(tg, "volumes", None):
            return
        if any(vr.type == "csi" for vr in tg.volumes.values()):
            raise RuntimeError("alloc requests CSI volumes but this "
                               "client has no CSI manager")

    def run(self) -> None:
        self.alloc_dir.build()
        try:
            self._migrate_prev_disk()
        except Exception as e:
            for tr in self.task_runners:
                tr.mark_failed(f"ephemeral disk migration failed: {e}")
            self._done.set()
            self._report()
            return
        try:
            self._mount_csi_volumes()
        except Exception as e:
            for tr in self.task_runners:
                tr.mark_failed(f"csi volume setup failed: {e}")
            self._done.set()
            self._report()
            return
        for tr in self.task_runners:
            if not tr.is_dead():
                tr.start()
        self._waiter = threading.Thread(target=self._wait_all, daemon=True)
        self._waiter.start()
        if self.alloc.deployment_id:
            self._health = threading.Thread(target=self._watch_health,
                                            daemon=True)
            self._health.start()
        # initial sync so the server sees pending promptly
        self._report()

    def _migrate_prev_disk(self) -> None:
        """Prerun gate: a replacement for a migrate=true group waits
        for its previous alloc to stop and pulls that alloc's shared
        data dir — locally or streamed from the owning agent
        (reference: client/allocwatcher/, migrate token client.go:925).
        Tasks must not start until the data is in place."""
        if self.prev_migrator is None:
            return
        if not self.alloc.previous_allocation:
            return
        if not self.alloc.migrate_disk():
            return
        self.prev_migrator(self.alloc, self.alloc_dir)

    def restore(self) -> None:
        """reference: alloc_runner.go:380 — restore every task runner
        from the state DB before run()."""
        for tr in self.task_runners:
            tr.restore()

    def _wait_all(self) -> None:
        for tr in self.task_runners:
            tr.wait()
        self._health_stop.set()
        self._done.set()
        self._report()

    # -------------------------------------------------------- task fan-in
    def _on_task_state_change(self, tr: TaskRunner) -> None:
        # leader-task kill ordering (alloc_runner.go:443): when the leader
        # dies, the followers are killed
        if tr.task.leader and tr.task_state().state == TASK_STATE_DEAD:
            with self._lock:
                killing = self._killing
                self._killing = True
            if not killing:
                for other in self.task_runners:
                    if other is not tr and not other.is_dead():
                        threading.Thread(
                            target=other.kill,
                            args=("leader task dead",), daemon=True).start()
        self._report()

    def task_states(self) -> Dict[str, TaskState]:
        return {tr.task.name: tr.task_state() for tr in self.task_runners}

    def client_status(self) -> str:
        return client_status_from_tasks(self.task_states())

    def _report(self) -> None:
        upd = copy.copy(self.alloc)
        upd.task_states = self.task_states()
        upd.client_status = client_status_from_tasks(upd.task_states)
        upd.modify_time = _time.time()
        if self._health_reported is not None:
            upd.deployment_status = AllocDeploymentStatus(
                healthy=self._health_reported, timestamp=_time.time())
        self.on_alloc_update(upd)

    # ------------------------------------------------------------- health
    def _update_strategy(self):
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        return tg.update if tg else None

    def _watch_health(self) -> None:
        """Deployment health tracker (reference: client/allochealth/
        tracker.go): healthy after min_healthy_time of everything running;
        unhealthy on any task failure or the healthy_deadline."""
        strategy = self._update_strategy()
        min_healthy = strategy.min_healthy_time_s if strategy else 10.0
        deadline = strategy.healthy_deadline_s if strategy else 300.0
        start = _time.time()
        healthy_since: Optional[float] = None
        seen_restarts = sum(ts.restarts
                            for ts in self.task_states().values())
        while not self._health_stop.wait(0.05):
            states = self.task_states()
            if any(ts.failed for ts in states.values()):
                self._set_health(False)
                return
            restarts = sum(ts.restarts for ts in states.values())
            if restarts > seen_restarts:
                seen_restarts = restarts
                healthy_since = None       # a restart resets the clock
            all_running = states and all(
                ts.state == TASK_STATE_RUNNING for ts in states.values())
            now = _time.time()
            if all_running:
                if healthy_since is None:
                    healthy_since = now
                if now - healthy_since >= min_healthy:
                    self._set_health(True)
                    return
            else:
                healthy_since = None
            if now - start > deadline:
                self._set_health(False)
                return

    def _set_health(self, healthy: bool) -> None:
        self._health_reported = healthy
        self._report()

    # -------------------------------------------------------------- verbs
    def update(self, alloc: Allocation) -> None:
        """Server pushed a new alloc version (reference: runAllocs update
        path). Stop/evict kills; otherwise adopt the new server-side
        fields (in-place update)."""
        with self._lock:
            self.alloc = alloc
            for tr in self.task_runners:
                tr.alloc = alloc
        if self.state_db is not None:
            self.state_db.put_allocation(alloc)
        if alloc.server_terminal_status():
            threading.Thread(target=self.kill,
                             args=("alloc stopped by server",),
                             daemon=True).start()

    def kill(self, reason: str = "") -> None:
        with self._lock:
            if self._killing:
                return
            self._killing = True
        for tr in self.task_runners:
            if not tr.is_dead():
                tr.kill(reason)
        self._done.wait(5.0)

    def destroy(self) -> None:
        """Full teardown incl. the alloc dir (client GC path)."""
        self.kill("alloc garbage collected")
        self._destroyed = True
        self.alloc_dir.destroy()
        if self.state_db is not None:
            self.state_db.delete_allocation(self.alloc.id)

    def is_done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)
