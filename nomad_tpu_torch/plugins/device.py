"""Device plugin interface — the accelerator-facing plugin class.

Reference: plugins/device/ — the gRPC protocol every device plugin
speaks: `Fingerprint` streams the device inventory (groups of
instances with attributes), `Reserve` returns the container access
recipe (env vars, mounts) for specific instance ids, `Stats` reports
per-instance usage. devices/gpu/nvidia is the built-in blueprint; this
package's first-party plugin introspects `torch.cuda` instead of NVML.

In-process plugins here follow the same registry pattern as the task
drivers (plugins/drivers.py); the wire protocol for OUT-of-process
plugins is the rpc package's framed JSON, not gRPC.

The counterpart of `nomad_tpu.plugins.device`, with `CUDADevicePlugin`
in the place of the reference's `TPUDevicePlugin`.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..structs import NodeDevice, NodeDeviceResource

_log = logging.getLogger(__name__)


@dataclass
class ContainerReservation:
    """How a task gets access to reserved instances (reference:
    plugins/device/device.go ContainerReservation)."""
    envs: Dict[str, str] = field(default_factory=dict)
    mounts: List[Dict[str, str]] = field(default_factory=list)
    devices: List[str] = field(default_factory=list)


class DevicePlugin:
    """Base protocol (reference: plugins/device/device.go:31-44)."""

    name = "device"

    def fingerprint(self) -> List[NodeDeviceResource]:
        """The device inventory this node offers."""
        raise NotImplementedError

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        """Access recipe for specific instance ids at task start."""
        raise NotImplementedError

    def stats(self) -> Dict[str, Dict[str, float]]:
        """instance id -> stats gauges."""
        return {}


class CUDADevicePlugin(DevicePlugin):
    """First-party GPU inventory through `torch.cuda` (the nvidia/NVML
    plugin's counterpart, devices/gpu/nvidia/device.go; the reference's
    `TPUDevicePlugin` fingerprints TPUs through the JAX runtime).  One
    group per device name, instances `gpu-<ordinal>`.  A host where
    `torch.cuda.is_available()` is false, or where torch does not import,
    offers no devices: that is inventory, not a compute fallback."""

    name = "gpu"

    def fingerprint(self) -> List[NodeDeviceResource]:
        try:
            import torch
            if not torch.cuda.is_available():
                return []
            names = [torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
        except Exception:                   # noqa: BLE001
            return []
        by_name: Dict[str, List[int]] = {}
        for i, dev_name in enumerate(names):
            by_name.setdefault(dev_name or "gpu", []).append(i)
        out = []
        for dev_name, ordinals in sorted(by_name.items()):
            out.append(NodeDeviceResource(
                vendor="nvidia", type="gpu", name=dev_name,
                instances=[NodeDevice(id=f"gpu-{i}", healthy=True)
                           for i in ordinals],
                attributes={"device_kind": dev_name,
                            "count": len(ordinals)}))
        return out

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        ordinals = ",".join(i.rsplit("-", 1)[-1] for i in device_ids)
        return ContainerReservation(
            envs={"CUDA_VISIBLE_DEVICES": ordinals,
                  "NOMAD_DEVICE_GPU": ",".join(device_ids)},
            devices=list(device_ids))


class MockDevicePlugin(DevicePlugin):
    """Scriptable inventory for tests (the drivers/mock analog)."""

    name = "mock_device"

    def __init__(self, groups: Optional[List[NodeDeviceResource]] = None,
                 env_key: str = "MOCK_DEVICES"):
        self.groups = groups or []
        self.env_key = env_key
        self.reserved: List[List[str]] = []

    def fingerprint(self) -> List[NodeDeviceResource]:
        return list(self.groups)

    def reserve(self, device_ids: List[str]) -> ContainerReservation:
        self.reserved.append(list(device_ids))
        return ContainerReservation(
            envs={self.env_key: ",".join(device_ids)},
            devices=list(device_ids))


class DevicePluginRegistry:
    """vendor/type/name pattern -> owning plugin (reference:
    client/devicemanager routing by DeviceIdTuple)."""

    def __init__(self, plugins: Optional[List[DevicePlugin]] = None):
        self.plugins = list(plugins or [])
        self._owner: Dict[tuple, DevicePlugin] = {}

    def fingerprint_all(self) -> List[NodeDeviceResource]:
        out = []
        for plugin in self.plugins:
            try:
                groups = plugin.fingerprint()
            except Exception:               # noqa: BLE001
                _log.exception("device plugin %s fingerprint failed",
                               plugin.name)
                continue
            for g in groups:
                self._owner[g.id_tuple()] = plugin
                out.append(g)
        return out

    def reserve(self, vendor: str, typ: str, model: str,
                device_ids: List[str]) -> Optional[ContainerReservation]:
        plugin = self._owner.get((vendor, typ, model))
        if plugin is None:
            return None
        return plugin.reserve(device_ids)


def default_device_registry() -> DevicePluginRegistry:
    return DevicePluginRegistry([CUDADevicePlugin()])
