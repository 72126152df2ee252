"""Fleet health counters and their numpy reduction (`health_host`).

The counterpart of the host half of `nomad_tpu.telemetry.health`:
`HealthCounters` (exact integer fleet counters for one sample: per-
resource utilization ge-counts, stranded-capacity fragmentation, busy /
per-DC counts for spread-violation accounting, evictable pressure and
device totals) and `health_host`, the reference's numpy twin of its
device health kernel, with the same clamps, multiply-threshold compares
and hi/lo split sums.  The server's telemetry beat samples it over the
worker solver's resident template (`Solver.health_counters`).  The
device kernel itself (`_health_kernel` as torch ops) is ROADMAP.md
Queue 1, item 9; the counter-wise `merge` of regions and the report's
per-tier byte totals come with the mesh tiers (item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

#: static DC-universe bound for the segment-sum planes; node_dc ids are
#: clamped into it (interned ids are small in practice).
MAX_DC = 64

#: utilization ge-thresholds: 0 and 1 - 2^-k for k = 1..6, then 1.0.
#: All exactly representable in f32, so `avail * edge` is a single
#: correctly-rounded multiply on every backend.
UTIL_EDGES: Tuple[float, ...] = (
    0.0, 0.5, 0.75, 0.875, 0.9375, 0.96875, 0.984375, 1.0)
N_EDGES = len(UTIL_EDGES)

#: a node is "busy" when any resource sits at >= 3/4 of its allocatable
#: capacity (the classic bin-packing pressure watermark).
BUSY_EDGE = 0.75

#: per-node integer ceiling: clamped to [0, 2^24) so every value is
#: f32-exact and the hi/lo split sums cannot overflow i32.
_CAP_I = (1 << 24) - 1
_CAP_F = np.float32(_CAP_I)
_SPLIT = 1 << 14

def _split_sum(v_i):
    """Order-independent i32 split sum over the node axis (axis 0)."""
    return ((v_i >> 14).sum(axis=0),
            (v_i & (_SPLIT - 1)).sum(axis=0))


def _recombine(hi, lo) -> Tuple[int, ...]:
    hi = np.atleast_1d(np.asarray(hi))
    lo = np.atleast_1d(np.asarray(lo))
    return tuple(int(h) * _SPLIT + int(l) for h, l in zip(hi, lo))


@dataclasses.dataclass(frozen=True)
class HealthCounters:
    """Exact integer fleet counters for one sampling wave.

    Tuple-typed fields (never arrays) so `==` between the device and
    host-twin products is structural — the property tests compare
    whole dataclasses.
    """
    n_resources: int
    nodes_valid: int
    nodes_busy: int
    nodes_stranded: int
    util_ge: Tuple[Tuple[int, ...], ...]   # [R][N_EDGES] ge-counts
    free: Tuple[int, ...]                  # per-resource exact sums
    used: Tuple[int, ...]
    avail: Tuple[int, ...]
    stranded_free: Tuple[int, ...]
    dc_nodes: Tuple[int, ...]              # [MAX_DC]
    dc_busy: Tuple[int, ...]
    dev_cap: int
    dev_used: int
    ev_slots: int = 0
    ev_pressure: Tuple[int, ...] = ()      # per-resource evictable sums

    @classmethod
    def from_raw(cls, raw: Dict) -> "HealthCounters":
        ge = np.asarray(raw["util_ge"])
        kw = {}
        if "ev_slots" in raw:
            kw = {"ev_slots": int(raw["ev_slots"]),
                  "ev_pressure": _recombine(raw["ev_hi"],
                                            raw["ev_lo"])}
        return cls(
            n_resources=int(ge.shape[0]),
            nodes_valid=int(raw["nodes_valid"]),
            nodes_busy=int(raw["nodes_busy"]),
            nodes_stranded=int(raw["nodes_stranded"]),
            util_ge=tuple(tuple(int(x) for x in row) for row in ge),
            free=_recombine(raw["free_hi"], raw["free_lo"]),
            used=_recombine(raw["used_hi"], raw["used_lo"]),
            avail=_recombine(raw["avail_hi"], raw["avail_lo"]),
            stranded_free=_recombine(raw["stranded_free_hi"],
                                     raw["stranded_free_lo"]),
            dc_nodes=tuple(int(x) for x in np.asarray(raw["dc_nodes"])),
            dc_busy=tuple(int(x) for x in np.asarray(raw["dc_busy"])),
            dev_cap=_recombine(raw["dev_cap_hi"],
                               raw["dev_cap_lo"])[0],
            dev_used=_recombine(raw["dev_used_hi"],
                                raw["dev_used_lo"])[0],
            **kw)

    # ------------------------------------------------- derived report
    def spread_violations(self) -> int:
        """DCs whose busy share exceeds 1.5x their node share —
        exact integer cross-multiply, no float ratios."""
        if self.nodes_busy <= 0 or self.nodes_valid <= 0:
            return 0
        out = 0
        for nodes_d, busy_d in zip(self.dc_nodes, self.dc_busy):
            if busy_d > 0 and \
                    2 * busy_d * self.nodes_valid > \
                    3 * nodes_d * self.nodes_busy:
                out += 1
        return out

    def util_hist(self) -> Tuple[Tuple[int, ...], ...]:
        """In-bucket counts per resource: bucket k = [edge_k,
        edge_{k+1}), last bucket = full/overcommitted (u >= 1)."""
        out = []
        for ge in self.util_ge:
            row = [ge[k] - ge[k + 1] for k in range(N_EDGES - 1)]
            row.append(ge[N_EDGES - 1])
            out.append(tuple(row))
        return tuple(out)

    def fragmentation_index(self) -> float:
        """Stranded fraction of free capacity across all resources:
        1.0 = every free unit is on a node nothing placeable fits."""
        total_free = sum(self.free)
        if total_free <= 0:
            return 0.0
        return sum(self.stranded_free) / total_free

    def _dc_report(self) -> Dict:
        """Per-DC counts trimmed to the populated id range."""
        n_dc = max((i + 1 for i, n in enumerate(self.dc_nodes) if n),
                   default=0)
        return {"nodes": list(self.dc_nodes[:n_dc]),
                "busy": list(self.dc_busy[:n_dc])}

    def report(self) -> Dict:
        total_avail = sum(self.avail)
        out = {
            "nodes": {"valid": self.nodes_valid,
                      "busy": self.nodes_busy,
                      "stranded": self.nodes_stranded},
            "utilization": (sum(self.used) / total_avail
                            if total_avail > 0 else 0.0),
            "util_edges": list(UTIL_EDGES),
            "util_hist": [list(r) for r in self.util_hist()],
            "fragmentation_index": self.fragmentation_index(),
            "stranded_free": list(self.stranded_free),
            "free": list(self.free),
            "used": list(self.used),
            "avail": list(self.avail),
            "spread_violations": self.spread_violations(),
            "dc": self._dc_report(),
            "evictable": {"slots": self.ev_slots,
                          "pressure": list(self.ev_pressure)},
            "devices": {"cap": self.dev_cap, "used": self.dev_used},
        }
        return out


# ---------------------------------------------------------- host twin
def health_host(template, used, dev_used,
                row_mask: Optional[np.ndarray] = None
                ) -> HealthCounters:
    """The reference's numpy twin of its device health kernel over a
    host-side PackedBatch: clamps, multiply-threshold compares, split
    accumulators and saturation as there.  `row_mask` selects the rows
    the device world actually holds (elastic layouts drop lost tiles).
    """
    f32 = np.float32
    valid = np.asarray(template.valid, bool).copy()
    if row_mask is not None:
        valid &= np.asarray(row_mask, bool)
    edges = np.asarray(UTIL_EDGES, dtype=f32)
    av = np.where(valid[:, None],
                  np.clip(np.asarray(template.avail, f32),
                          f32(0), _CAP_F), f32(0))
    us = np.where(valid[:, None],
                  np.clip(np.asarray(used, f32), f32(0), _CAP_F),
                  f32(0))
    free = np.clip(av - us, f32(0), _CAP_F)
    av_i = av.astype(np.int32)
    us_i = us.astype(np.int32)
    free_i = free.astype(np.int32)

    cap_pos = av > 0
    ge = np.logical_and(
        us[:, :, None] >= av[:, :, None] * edges,
        cap_pos[:, :, None]).astype(np.int32).sum(axis=0)

    busy = np.logical_and(cap_pos, us >= av * f32(BUSY_EDGE)).any(axis=1)

    ask_res = np.asarray(template.ask_res, f32)
    ask_mask = (ask_res > 0).any(axis=1)
    fits = (ask_res[None, :, :] <= free[:, None, :]).all(axis=2)
    placeable = np.logical_and(fits, ask_mask[None, :]).any(axis=1)
    stranded = valid & (free_i.sum(axis=1) > 0) & ~placeable

    dcc = np.clip(np.asarray(template.node_dc), 0, MAX_DC - 1)
    dc_nodes = np.zeros(MAX_DC, np.int32)
    np.add.at(dc_nodes, dcc, valid.astype(np.int32))
    dc_busy = np.zeros(MAX_DC, np.int32)
    np.add.at(dc_busy, dcc, busy.astype(np.int32))

    raw: Dict = {
        "nodes_valid": valid.astype(np.int32).sum(),
        "nodes_busy": busy.astype(np.int32).sum(),
        "nodes_stranded": stranded.astype(np.int32).sum(),
        "util_ge": ge, "dc_nodes": dc_nodes, "dc_busy": dc_busy,
    }
    for name, v_i in (("free", free_i), ("used", us_i),
                      ("avail", av_i),
                      ("stranded_free",
                       np.where(stranded[:, None], free_i, 0))):
        raw[name + "_hi"], raw[name + "_lo"] = _split_sum(v_i)

    for name, plane in (("dev_cap", template.dev_cap),
                        ("dev_used", dev_used)):
        v = np.minimum(
            np.where(valid[:, None],
                     np.clip(np.asarray(plane, f32), f32(0), _CAP_F),
                     f32(0)).astype(np.int32).sum(axis=1),
            np.int32(_CAP_I))
        raw[name + "_hi"] = (v >> 14).sum()
        raw[name + "_lo"] = (v & (_SPLIT - 1)).sum()

    if getattr(template, "ev_prio", None) is not None:
        slots = np.logical_and(
            np.asarray(template.ev_prio) >= 0, valid[:, None])
        raw["ev_slots"] = slots.astype(np.int32).sum()
        ev_i = np.minimum(
            np.where(slots[:, :, None],
                     np.clip(np.asarray(template.ev_res, f32),
                             f32(0), _CAP_F), f32(0))
            .astype(np.int32).sum(axis=1),
            np.int32(_CAP_I))
        raw["ev_hi"], raw["ev_lo"] = _split_sum(ev_i)
    return HealthCounters.from_raw(raw)
