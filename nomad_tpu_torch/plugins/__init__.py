"""Plugin system: the process/ABI boundary between the client core and
task drivers / device plugins.

Reference: plugins/base (PluginInfo/ConfigSchema/SetConfig),
plugins/drivers/driver.go:40-58 (DriverPlugin), plugins/device
(Fingerprint/Reserve/Stats). The reference runs external plugins as
go-plugin gRPC subprocesses and builtins in-process
(helper/pluginutils/catalog/register.go:15-19); here builtins are
in-process Python classes behind the same interface, and the
subprocess boundary lives one level lower — in the per-task executor
(nomad_tpu_torch/drivers/executor.py) that outlives the agent.

The counterpart of `nomad_tpu.plugins`, without the CSI plugin client
(`plugins/csi.py`) and the interactive exec stream (`ExecStream`),
which come with the `exec` driver and CSI (ROADMAP.md Queue 1 item 16b).
"""
from .base import PluginInfo
from .drivers import (DriverCapabilities, DriverFingerprint, DriverPlugin,
                      DriverRegistry, ExitResult, TaskConfig, TaskHandle,
                      TaskStatus, default_registry)

__all__ = [
    "PluginInfo", "DriverPlugin", "DriverCapabilities", "DriverFingerprint",
    "DriverRegistry", "ExitResult", "TaskConfig", "TaskHandle", "TaskStatus",
    "default_registry",
]
