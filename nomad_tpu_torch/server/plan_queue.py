"""PlanQueue: leader-side admission queue feeding the single plan applier.

Reference: nomad/plan_queue.go — priority heap of pending plans, each with
a future the submitting worker blocks on (:29, :58).

The counterpart of `nomad_tpu.server.plan_queue`; a future's `wait` has
no deadline unless the caller gives one (the reference's waits 30 s).
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional, Tuple

from ..structs import Plan, PlanResult


class PlanFuture:
    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Optional[PlanResult] = None
        self._err: Optional[str] = None

    def respond(self, result: Optional[PlanResult],
                err: Optional[str]) -> None:
        # first respond wins: the applier's error paths may race a
        # result already delivered (pipelined finalize), and a late
        # error must never overwrite what the worker already read
        if self._event.is_set():
            return
        self._result = result
        self._err = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Tuple[Optional[PlanResult], Optional[str]]:
        """The plan's result, once the applier answers (with no
        `timeout`, however long its apply takes: every path that stops
        the applier answers the plans it holds)."""
        if not self._event.wait(timeout):
            return None, "plan apply timeout"
        return self._result, self._err


class PendingPlan:
    def __init__(self, plan: Plan):
        self.plan = plan
        self.future = PlanFuture()


class PlanQueue:
    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._enabled = False
        self._heap: List[tuple] = []
        self._count = itertools.count()

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for _, _, pending in self._heap:
                    pending.future.respond(None, "plan queue disabled")
                self._heap.clear()
            self._lock.notify_all()

    @property
    def enabled(self) -> bool:
        with self._lock:    # guarded by _lock: see set_enabled
            return self._enabled

    def enqueue(self, plan: Plan) -> Optional[PendingPlan]:
        with self._lock:
            if not self._enabled:
                return None
            pending = PendingPlan(plan)
            heapq.heappush(self._heap,
                           (-plan.priority, next(self._count), pending))
            self._lock.notify_all()
            return pending

    def dequeue(self, timeout: float) -> Optional[PendingPlan]:
        import time
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if self._heap:
                    return heapq.heappop(self._heap)[2]
                remain = deadline - time.monotonic()
                if remain <= 0 or not self._enabled:
                    return None
                self._lock.wait(remain)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)
