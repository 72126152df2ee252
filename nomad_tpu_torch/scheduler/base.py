"""Scheduler registry (reference: scheduler/scheduler.go:23
BuiltinSchedulers + NewScheduler factory)."""
from __future__ import annotations

from ..structs import JOB_TYPE_BATCH, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM


def new_scheduler(sched_type: str, state, planner, solver=None):
    """`solver`: the worker's long-lived Solver, shared across evals.
    None builds a default `Solver()`, which runs on `cuda` and raises
    where no GPU is present."""
    from .generic import GenericScheduler
    if sched_type == JOB_TYPE_SERVICE:
        return GenericScheduler(state, planner, batch=False,
                                solver=solver)
    if sched_type == JOB_TYPE_BATCH:
        return GenericScheduler(state, planner, batch=True,
                                solver=solver)
    if sched_type == JOB_TYPE_SYSTEM:
        raise NotImplementedError(
            "nomad_tpu_torch: the system scheduler is not ported yet; it "
            "needs the static feasibility kernel (ROADMAP.md Queue 1, "
            "'the system scheduler with _feas_kernel')")
    raise ValueError(f"unknown scheduler type {sched_type!r}")
