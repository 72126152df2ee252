"""In-process scheduler test harness.

Runs any scheduler against a real StateStore with a fake Planner that
applies plans directly — no raft, no RPC, no goroutines (reference:
scheduler/testing.go:42 Harness, SubmitPlan :80, RejectPlan :17).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..state.store import StateStore
from ..structs import Evaluation, Plan, PlanResult
from .base import new_scheduler


class Harness:
    def __init__(self, store: Optional[StateStore] = None):
        self.store = store or StateStore()
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.reject_plan = False
        self.solver = None      # optional shared Solver (worker parity)
        self._lock = threading.Lock()
        self._index = self.store.latest_index() or 1000

    def next_index(self) -> int:
        with self._lock:
            self._index += 1
            return self._index

    # ---- Planner interface ----
    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], object]:
        self.plans.append(plan)
        if self.reject_plan:
            # refresh-and-retry path: hand back a fresh snapshot
            return PlanResult(), self.store.snapshot()
        index = self.next_index()
        result = PlanResult(
            node_update=plan.node_update,
            node_allocation=plan.node_allocation,
            node_preemptions=plan.node_preemptions,
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=index)
        self.store.upsert_plan_results(index, result, plan.job)
        if self.solver is not None:
            # mirror the worker's plan-apply feed into the resident world
            self.solver.note_plan_result(plan, result)
        return result, None

    def update_eval(self, evaluation: Evaluation) -> None:
        self.evals.append(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        self.create_evals.append(evaluation)

    def reblock_eval(self, evaluation: Evaluation) -> None:
        self.reblock_evals.append(evaluation)

    # ---- driving ----
    def process(self, sched_type: str, evaluation: Evaluation):
        sched = new_scheduler(sched_type, self.store, self,
                              solver=self.solver)
        return sched.process(evaluation)
