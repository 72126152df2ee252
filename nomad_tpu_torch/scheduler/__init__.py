"""Scheduling layer: reconciler, the generic (service and batch) and
system schedulers, the fused fleet path, harness.

Reference analog: scheduler/ package (SURVEY §2.1). The placement solve
itself lives in nomad_tpu_torch.solver (on the card); this package is
the host-side behavior around it.
"""
from .base import new_scheduler  # noqa: F401
