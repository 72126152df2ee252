"""Base plugin protocol (reference: plugins/base/base.go).

Every plugin — driver or device — reports identity/version via
PluginInfo and accepts a config dict validated against its declared
schema keys (the hclspec analog: a flat {key: (type, default)} table
rather than a full HCL schema compiler).

The counterpart of `nomad_tpu.plugins.base`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

PLUGIN_TYPE_DRIVER = "driver"
PLUGIN_TYPE_DEVICE = "device"

API_VERSION = "v0.1.0"


@dataclass
class PluginInfo:
    name: str = ""
    type: str = PLUGIN_TYPE_DRIVER
    plugin_api_versions: Tuple[str, ...] = (API_VERSION,)
    plugin_version: str = "0.1.0"


class BasePlugin:
    """In-process plugin contract (reference: base.BasePlugin)."""

    #: config schema: key -> (python type, default). Unknown keys are a
    #: validation error, mirroring the reference's strict hclspec decode.
    config_schema: Dict[str, Tuple[type, Any]] = {}

    def plugin_info(self) -> PluginInfo:
        raise NotImplementedError

    def set_config(self, config: Dict[str, Any]) -> None:
        self._config = self.validate_config(config)

    @classmethod
    def validate_config(cls, config: Dict[str, Any]) -> Dict[str, Any]:
        out = {k: default for k, (_, default) in cls.config_schema.items()}
        for key, value in (config or {}).items():
            if key not in cls.config_schema:
                raise ValueError(f"unknown plugin config key {key!r}")
            want, _ = cls.config_schema[key]
            if want is float and isinstance(value, int):
                value = float(value)
            if not isinstance(value, want):
                raise ValueError(
                    f"plugin config {key!r}: want {want.__name__}, "
                    f"got {type(value).__name__}")
            out[key] = value
        return out
