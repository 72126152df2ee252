"""CSI plugin fingerprint entry carried on a node.

Only `CSIPluginNodeInfo` is needed by the placement solve (`Node` holds
a map of them); volumes, claims and plugin aggregation belong to the
scheduler and state layers.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CSIPluginNodeInfo:
    plugin_id: str = ""
    healthy: bool = True
    requires_controller: bool = False
