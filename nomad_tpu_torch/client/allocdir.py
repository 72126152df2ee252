"""Allocation directory layout (reference: client/allocdir/).

<data_dir>/allocs/<alloc_id>/
  alloc/            shared between tasks (data/, logs/, tmp/)
  <task>/           per-task working dir
  <task>/local/     task-private scratch
  <task>/secrets/   secrets dir (tmpfs in the reference; plain dir here)

Task stdout/stderr land in alloc/logs/<task>.{stdout,stderr}.0 following
the reference's logmon naming.

The counterpart of `nomad_tpu.client.allocdir`.
"""
from __future__ import annotations

import os
import shutil


class AllocDir:
    def __init__(self, data_dir: str, alloc_id: str):
        self.alloc_id = alloc_id
        self.root = os.path.join(data_dir, "allocs", alloc_id)
        self.shared = os.path.join(self.root, "alloc")
        self.logs = os.path.join(self.shared, "logs")

    def build(self) -> None:
        for sub in ("data", "logs", "tmp"):
            os.makedirs(os.path.join(self.shared, sub), exist_ok=True)

    def task_dir(self, task: str) -> str:
        return os.path.join(self.root, task)

    def secrets_dir(self, task: str) -> str:
        return os.path.join(self.task_dir(task), "secrets")

    def build_task_dir(self, task: str) -> str:
        d = self.task_dir(task)
        for sub in ("local", "secrets", "tmp"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        return d

    def stdout_path(self, task: str) -> str:
        return os.path.join(self.logs, f"{task}.stdout.0")

    def stderr_path(self, task: str) -> str:
        return os.path.join(self.logs, f"{task}.stderr.0")

    def exists(self) -> bool:
        return os.path.isdir(self.root)

    def destroy(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
