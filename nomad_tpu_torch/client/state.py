"""Durable client state DB (reference: client/state/ — StateDB iface
interface.go:12, BoltDB impl state_database.go, memdb.go for tests).

SQLite replaces BoltDB: allocs, per-task runner local state (including
the driver TaskHandle re-attach token), and per-task TaskState. An agent
restart restores from here and re-attaches to live workloads instead of
re-running them.

The counterpart of `nomad_tpu.client.state`.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

from ..plugins.drivers import TaskHandle
from ..structs import Allocation, TaskState
from ..utils.codec import from_wire, to_wire

SCHEMA_VERSION = 1


class StateDB:
    """SQLite-backed (reference BoltDB `state.db`)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._closed = False
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._lock, self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, "
                "value TEXT)")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS allocs (id TEXT PRIMARY KEY, "
                "data TEXT)")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS task_state ("
                "alloc_id TEXT, task TEXT, local TEXT, state TEXT, "
                "PRIMARY KEY (alloc_id, task))")
            self._conn.execute(
                "INSERT OR REPLACE INTO meta VALUES ('schema_version', ?)",
                (str(SCHEMA_VERSION),))

    # -------------------------------------------------------------- allocs
    def put_allocation(self, alloc: Allocation) -> None:
        blob = json.dumps(to_wire(alloc))
        with self._lock:
            if self._closed:
                return                 # racing writers during shutdown
            with self._conn:
                self._conn.execute(
                    "INSERT OR REPLACE INTO allocs VALUES (?, ?)",
                    (alloc.id, blob))

    def get_all_allocations(self) -> List[Allocation]:
        with self._lock:
            rows = self._conn.execute("SELECT data FROM allocs").fetchall()
        return [from_wire(Allocation, json.loads(r[0])) for r in rows]

    def delete_allocation(self, alloc_id: str) -> None:
        with self._lock:
            if self._closed:
                return
            with self._conn:
                self._conn.execute("DELETE FROM allocs WHERE id=?",
                                   (alloc_id,))
                self._conn.execute("DELETE FROM task_state WHERE alloc_id=?",
                                   (alloc_id,))

    # ---------------------------------------------------------- task state
    def put_task_runner_state(self, alloc_id: str, task: str,
                              handle: Optional[TaskHandle],
                              task_state: Optional[TaskState]) -> None:
        """Both columns are written unconditionally: a None handle MEANS
        'no live driver task' and must clear any stale re-attach token
        (otherwise a restarted agent would recover a task that already
        exited and double-count its exit)."""
        local = json.dumps(to_wire(handle)) if handle else None
        state = json.dumps(to_wire(task_state)) if task_state else None
        with self._lock:
            if self._closed:
                return
            with self._conn:
                self._conn.execute(
                    "INSERT OR REPLACE INTO task_state VALUES (?, ?, ?, ?)",
                    (alloc_id, task, local, state))

    def get_task_runner_state(
            self, alloc_id: str, task: str
    ) -> Tuple[Optional[TaskHandle], Optional[TaskState]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT local, state FROM task_state WHERE alloc_id=? "
                "AND task=?", (alloc_id, task)).fetchone()
        if row is None:
            return None, None
        handle = (from_wire(TaskHandle, json.loads(row[0]))
                  if row[0] else None)
        state = (from_wire(TaskState, json.loads(row[1]))
                 if row[1] else None)
        return handle, state

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._conn.close()


class MemDB:
    """In-memory StateDB for tests (reference: client/state/memdb.go)."""

    def __init__(self):
        self._allocs: Dict[str, Allocation] = {}
        self._task: Dict[Tuple[str, str], Tuple[Optional[TaskHandle],
                                                Optional[TaskState]]] = {}
        self._lock = threading.Lock()

    def put_allocation(self, alloc: Allocation) -> None:
        with self._lock:
            self._allocs[alloc.id] = alloc

    def get_all_allocations(self) -> List[Allocation]:
        with self._lock:
            return list(self._allocs.values())

    def delete_allocation(self, alloc_id: str) -> None:
        with self._lock:
            self._allocs.pop(alloc_id, None)
            for key in [k for k in self._task if k[0] == alloc_id]:
                self._task.pop(key, None)

    def put_task_runner_state(self, alloc_id, task, handle, task_state):
        with self._lock:
            self._task[(alloc_id, task)] = (handle, task_state)

    def get_task_runner_state(self, alloc_id, task):
        with self._lock:
            return self._task.get((alloc_id, task), (None, None))

    def close(self) -> None:
        pass
