"""Builtin task drivers (reference: drivers/ — rawexec, exec, mock, …).

The compute path of this package is PyTorch/CUDA; drivers are the
host-side task runtime that the client's task runners drive through the
plugin boundary (nomad_tpu_torch/plugins/drivers.py). Builtins:

- rawexec: real subprocesses under a detached per-task executor
  (reference: drivers/rawexec + drivers/shared/executor)
- mock: scriptable lifecycle for tests (reference: drivers/mock)

The counterpart of `nomad_tpu.drivers`.  The reference's `exec` driver
(rawexec's supervision plus a jail: mount and pid namespaces, a chroot,
cgroup limits; `drivers/exec.py`, `drivers/isolation.py`) is not
registered yet: it comes in its own slice (ROADMAP.md Queue 1 item 16b),
and a task that asks for it fails as any unknown driver does.
"""
from .mock import MockDriver
from .rawexec import RawExecDriver


def register_builtins(registry) -> None:
    """reference: helper/pluginutils/catalog/register.go:15-19."""
    registry.register(RawExecDriver())
    registry.register(MockDriver())


__all__ = ["RawExecDriver", "MockDriver", "register_builtins"]
