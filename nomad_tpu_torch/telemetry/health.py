"""Fleet health counters: the device reduction and its numpy twin.

The counterpart of `nomad_tpu.telemetry.health`: `HealthCounters` (exact
integer fleet counters for one sample: per-resource utilization
ge-counts, stranded-capacity fragmentation, busy / per-DC counts for
spread-violation accounting, evictable pressure and device totals),
`_health_kernel`, one pass of torch ops over a resident solver's
card-resident planes and carried usage (`device_health_counters`,
`ResidentSolver.health_counters`), and `health_host`, its numpy twin,
with the same clamps, multiply-threshold compares and hi/lo split sums,
so the two agree bit for bit.  The server's telemetry beat samples the
twin over the worker solver's resident template
(`Solver.health_counters`).  On a mesh solver the kernel runs on every
shard's planes (with the elastic layout's live-row mask) and the integer
outputs sum over the shards; `HealthCounters.merge` sums regions, and
`tier_bytes` gives a report its per-tier modeled byte totals.

Every reduced quantity is an integer: per-node values are clamped to
[0, 2^24) (f32-exact), split into hi = v >> 14 and lo = v & 16383 and
summed in int32 (overflow-free up to `MAX_NODES` nodes), then recombined
on the host as Python ints.  Histogram membership multiplies by exact
f32 edges (`used >= avail * edge`), never divides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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

#: hi/lo split sums stay inside int32 for up to this many nodes
#: (2^17 * max(hi) = 2^17 * 2^10 < 2^31); device_health_raw guards it
MAX_NODES = 1 << 17


def _split_sum(v_i):
    """Order-independent i32 split sum over the node axis (axis 0)."""
    return ((v_i >> 14).sum(axis=0),
            (v_i & (_SPLIT - 1)).sum(axis=0))


def _health_kernel(avail, valid, node_dc, dev_cap, used, dev_used,
                   ask_res, live=None, ev_prio=None, ev_res=None) -> Dict:
    """One-pass fleet reduction on the planes' device; returns a dict of
    small int32 tensors (unpacked by `_unpack_raw`).  `live` masks the
    device rows whose tile is resident (elastic layouts keep stale rows,
    valid included, for retired and lost tiles); None: every row is
    live.  `ev_prio` / `ev_res` are None when the world has no
    preemption planes."""
    i32 = torch.int32
    if live is not None:
        valid = valid & live
    cap = float(_CAP_F)
    mask = _SPLIT - 1
    edges = torch.tensor(UTIL_EDGES, dtype=torch.float32,
                         device=avail.device)
    vcol = valid[:, None]
    av = torch.where(vcol, avail.clamp(0.0, cap), 0.0)
    us = torch.where(vcol, used.clamp(0.0, cap), 0.0)
    free = (av - us).clamp(0.0, cap)
    av_i, us_i, free_i = av.to(i32), us.to(i32), free.to(i32)

    def isum(x, dim=None):
        return (x.to(i32).sum(dtype=i32) if dim is None
                else x.to(i32).sum(dim=dim, dtype=i32))

    def split(v_i):
        return torch.stack([isum(v_i >> 14, 0), isum(v_i & mask, 0)])

    # ge-counts per (resource, edge); av is zeroed for invalid rows, so
    # the av > 0 gate doubles as the validity gate
    cap_pos = av > 0.0
    ge = isum((us[:, :, None] >= av[:, :, None] * edges)
              & cap_pos[:, :, None], 0)                      # [R, E]
    busy = (cap_pos & (us >= av * BUSY_EDGE)).any(dim=1)
    # stranded capacity: free somewhere, but no nonzero probe ask fits
    ask_mask = (ask_res > 0.0).any(dim=1)                   # [Gp]
    fits = (ask_res[None, :, :] <= free[:, None, :]).all(dim=2)
    placeable = (fits & ask_mask[None, :]).any(dim=1)
    stranded = valid & (isum(free_i, 1) > 0) & ~placeable
    dcc = node_dc.to(torch.int64).clamp(0, MAX_DC - 1)
    # device planes: sum over the device axis first, then clamp
    dcap = isum(torch.where(vcol, dev_cap.clamp(0.0, cap), 0.0),
                1).clamp(max=_CAP_I)
    dusd = isum(torch.where(vcol, dev_used.clamp(0.0, cap), 0.0),
                1).clamp(max=_CAP_I)
    # outputs stacked into a handful of buffers (order: _SCALAR_KEYS,
    # _SUM_KEYS, then the eviction entries)
    scalars = [isum(valid), isum(busy), isum(stranded),
               isum(dcap >> 14), isum(dcap & mask),
               isum(dusd >> 14), isum(dusd & mask)]
    sums = [split(v_i) for v_i in (free_i, us_i, av_i,
                                   torch.where(stranded[:, None], free_i, 0))]
    if ev_prio is not None:
        slots = (ev_prio >= 0) & vcol
        scalars.append(isum(slots))
        ev_i = isum(torch.where(slots[:, :, None], ev_res.clamp(0.0, cap),
                                0.0), 1).clamp(max=_CAP_I)   # [Np, R]
        sums.append(split(ev_i))
    zeros = torch.zeros(MAX_DC, dtype=i32, device=avail.device)
    return {
        "scalars": torch.stack(scalars),
        "sums": torch.stack(sums),
        "util_ge": ge,
        "dc_nodes": zeros.index_add(0, dcc, valid.to(i32)),
        "dc_busy": zeros.index_add(0, dcc, busy.to(i32)),
    }


#: unpack order for the kernel's stacked outputs (ev entries ride at
#: the end only when the world packs preemption planes)
_SCALAR_KEYS = ("nodes_valid", "nodes_busy", "nodes_stranded",
                "dev_cap_hi", "dev_cap_lo", "dev_used_hi",
                "dev_used_lo")
_SUM_KEYS = ("free", "used", "avail", "stranded_free")


def _unpack_raw(got: Dict) -> Dict:
    """Fan the kernel's stacked buffers (fetched to numpy) back out to
    the flat raw-dict key space `HealthCounters.from_raw` and the host
    twin share."""
    raw = {"util_ge": got["util_ge"], "dc_nodes": got["dc_nodes"],
           "dc_busy": got["dc_busy"]}
    sc = np.asarray(got["scalars"])
    for i, k in enumerate(_SCALAR_KEYS):
        raw[k] = sc[i]
    if sc.shape[0] > len(_SCALAR_KEYS):
        raw["ev_slots"] = sc[len(_SCALAR_KEYS)]
    sums = np.asarray(got["sums"])
    for i, k in enumerate(_SUM_KEYS):
        raw[k + "_hi"], raw[k + "_lo"] = sums[i, 0], sums[i, 1]
    if sums.shape[0] > len(_SUM_KEYS):
        raw["ev_hi"], raw["ev_lo"] = sums[-1, 0], sums[-1, 1]
    return raw


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

    def merge(self, other: "HealthCounters") -> "HealthCounters":
        """Counter-wise sum: every field is a sum over nodes, so merging
        regions equals computing over the union fleet."""
        if self.n_resources != other.n_resources:
            raise ValueError("resource-dim mismatch in health merge")

        def add(a, b):
            return tuple(x + y for x, y in zip(a, b))
        ep = (add(self.ev_pressure, other.ev_pressure)
              if self.ev_pressure and other.ev_pressure
              else self.ev_pressure or other.ev_pressure)
        return HealthCounters(
            n_resources=self.n_resources,
            nodes_valid=self.nodes_valid + other.nodes_valid,
            nodes_busy=self.nodes_busy + other.nodes_busy,
            nodes_stranded=self.nodes_stranded + other.nodes_stranded,
            util_ge=tuple(add(a, b) for a, b in
                          zip(self.util_ge, other.util_ge)),
            free=add(self.free, other.free),
            used=add(self.used, other.used),
            avail=add(self.avail, other.avail),
            stranded_free=add(self.stranded_free, other.stranded_free),
            dc_nodes=add(self.dc_nodes, other.dc_nodes),
            dc_busy=add(self.dc_busy, other.dc_busy),
            dev_cap=self.dev_cap + other.dev_cap,
            dev_used=self.dev_used + other.dev_used,
            ev_slots=self.ev_slots + other.ev_slots,
            ev_pressure=ep)

    def report(self, tiers: Optional[Dict] = None) -> Dict:
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
        if tiers:
            out["tier_bytes"] = dict(tiers)
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


# ------------------------------------------------- resident solvers
def device_health_raw(solver) -> Dict:
    """Run the health kernel over a resident solver's device planes and
    return its outputs unfetched (tensors on the solver's device).  The
    probe ask_res is put on the device once per template.  A mesh
    solver's planes are lists with one tensor a shard: the kernel runs on
    each shard (with its live-row mask) and the integer outputs sum on
    shard 0's device."""
    dn = solver._dev_node
    np_rows = int(solver.template.avail.shape[0])
    if np_rows > MAX_NODES:
        raise ValueError(
            f"health kernel split accumulators are i32-safe up to "
            f"{MAX_NODES} nodes; got {np_rows}")
    # keyed on the template and the mesh: a repack swaps the template, a
    # shard loss or recovery the shards the copies live on
    mesh = getattr(solver, "_mesh", None)
    cache = solver.__dict__.get("_health_ask_dev")
    if cache is None or cache[0] is not solver.template \
            or cache[2] is not mesh:
        dev = solver._put_ask(
            "health_ask_res",
            np.asarray(solver.template.ask_res, np.float32))
        solver.__dict__["_health_ask_dev"] = cache = (solver.template, dev,
                                                      mesh)
    live_fn = getattr(solver, "_health_live_mask", None)
    live = live_fn() if live_fn is not None else None
    if not isinstance(dn["avail"], list):
        return _health_kernel(
            dn["avail"], dn["valid"], dn["node_dc"], dn["dev_cap"],
            solver._used, solver._dev_used, cache[1], live,
            dn.get("ev_prio"), dn.get("ev_res"))
    total = None
    for i in range(len(dn["avail"])):
        raw = _health_kernel(
            dn["avail"][i], dn["valid"][i], dn["node_dc"][i],
            dn["dev_cap"][i], solver._used[i], solver._dev_used[i],
            cache[1][i], None if live is None else live[i],
            dn["ev_prio"][i] if "ev_prio" in dn else None,
            dn["ev_res"][i] if "ev_res" in dn else None)
        total = raw if total is None else {
            k: v + raw[k].to(v.device) for k, v in total.items()}
    return total


def fetch_health(raw) -> HealthCounters:
    """Fetch a `device_health_raw` result and build its counters."""
    got = {k: v.cpu().numpy() for k, v in raw.items()}
    return HealthCounters.from_raw(_unpack_raw(got))


def device_health_counters(solver) -> HealthCounters:
    """The health kernel over a resident solver's device planes: one
    pass on the device and one fetch."""
    return fetch_health(device_health_raw(solver))


def tier_bytes(solver, batches: Optional[Sequence] = None
               ) -> Dict[str, int]:
    """Per-tier modeled byte totals of the last dispatched stream: the
    memory tier always, ici / dcn / wan when the solver's wave_traffic
    models them (the mesh solvers).  {} when no batches are given."""
    if not batches:
        return {}
    wt = solver.wave_traffic(list(batches))
    m = wt.get("measured") or {}
    waves = int(m.get("waves_total", 1)) or 1
    out: Dict[str, int] = {}
    if "modeled_bytes_total" in m:
        out["hbm"] = int(m["modeled_bytes_total"])
    else:
        out["hbm"] = int(wt.get("bytes_per_wave", 0)) * waves
    for tier, key in (("ici", "bytes_ici_per_wave"),
                      ("dcn", "bytes_dcn_per_wave"),
                      ("wan", "bytes_wan_per_wave")):
        if key in wt:
            out[tier] = int(wt[key]) * waves
    return out
