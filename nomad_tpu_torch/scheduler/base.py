"""Scheduler registry (reference: scheduler/scheduler.go:23
BuiltinSchedulers + NewScheduler factory)."""
from __future__ import annotations

from ..structs import JOB_TYPE_BATCH, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM


def new_scheduler(sched_type: str, state, planner, solver=None):
    """`solver`: the worker's long-lived Solver, shared across evals.
    None builds a default `Solver()`, which runs on `cuda` and raises
    where no GPU is present."""
    from .generic import GenericScheduler
    from .system import SystemScheduler
    if sched_type == JOB_TYPE_SERVICE:
        return GenericScheduler(state, planner, batch=False,
                                solver=solver)
    if sched_type == JOB_TYPE_BATCH:
        return GenericScheduler(state, planner, batch=True,
                                solver=solver)
    if sched_type == JOB_TYPE_SYSTEM:
        return SystemScheduler(state, planner, solver=solver)
    raise ValueError(f"unknown scheduler type {sched_type!r}")
