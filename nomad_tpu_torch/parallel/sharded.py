"""The solve with its node axis split over a mesh of shards.

The counterpart of `nomad_tpu.parallel.sharded`.  The reference splits
the node axis over a grid of TPU devices with `shard_map` and XLA
collectives; here a mesh is a grid of `torch.device`s in one process, in
which a device may repeat: on a host with several GPUs the shards sit on
`cuda:0 ... cuda:S-1`, on one GPU all S shards sit on `cuda:0`, on the
CPU on `cpu`.  Each shard keeps its own slice of every node plane on its
device and runs the wave solve on it (`kernel.solve_steps` in mesh mode,
the fused wave kernel on CUDA tensors); only per-group candidate keys
(score, global node id) and K-sized integer vectors cross shards, merged
and summed by `kernel.solve_shards` chips first, then hosts, then
regions.  Placements and every explainability counter equal the flat
solve's.

  * `sharded_solve` / `sharded_solve_args`: one stateless solve split
    over the mesh's node axis; `federated_solve`: R independent regions,
    one a mesh row (`_federated_kernel`).
  * `ShardedResidentSolver`: the streaming `ResidentSolver` with its
    node planes and carried usage split over the mesh, delta rows routed
    to the shard that owns them.
  * `ElasticShardedResidentSolver`: the node axis owned in tiles through
    a remap table (`tensorize.TileLayout`): grow, move and shrink ship
    one tile's rows; `fail_shard` / `recover` is the shard-loss state
    machine; `ElasticMeshSupervisor` maps membership events onto it.
  * `model_ici_bytes`, `model_ici_dcn_bytes`, `model_ici_dcn_wan_bytes`:
    the reference's per-wave interconnect byte models (pure numpy), read
    by `wave_traffic`.

`NOMAD_TPU_MESH_HOSTS` and `NOMAD_TPU_MESH_REGIONS` default the host and
region counts of the mesh constructors and a solver built without a mesh;
`NOMAD_TPU_SHARD_TILE` and `NOMAD_TPU_RESHARD_SLACK` the elastic
solver's tile width and slack.  Each is read when the call that uses it
is made, and an argument wins.
"""
from __future__ import annotations

import inspect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver import wave_kernel as _wk
from ..solver.kernel import (MERGED_GP_MAX, TOP_K, WAVE_K, SolveResult,
                             _MERGED_W_CAP, _WIDE_W_CAP, delta_scatter_add,
                             delta_scatter_set, resolve_shortlist_c,
                             solve_kernel, solve_shards, solve_steps)
from ..solver.resident import (ResidentSolver, _host, _pack_out,
                               _solve_one, _status, model_wave_bytes)
from ..solver.solve import count_dispatch, resolve_device
from ..solver.tensorize import PackedBatch

MESH_NODE_AXIS = "nodes"
#: two-tier hierarchy: the node axis splits over ("hosts", "chips");
#: candidate keys merge per host, and only host winners cross hosts
MESH_HOST_AXIS = "hosts"
MESH_CHIP_AXIS = "chips"
#: three-tier hierarchy: ("regions", "hosts", "chips"); only region
#: winners cross regions
MESH_REGION_AXIS = "regions"

#: ask-side arguments whose TRAILING axis is the node axis
_PLANE_ASK_ARGS = ("host_ok", "coll0", "penalty", "a_host")

# How each positional argument of `solve_steps` splits over the mesh:
# 0 on its leading (node) axis, -1 on its trailing (node) axis, None
# replicated (the reference's _ARG_SPECS)
_ARG_SPLIT = (
    0, 0, 0,            # avail, reserved, used0 [Np, R]
    0, 0, 0,            # valid [Np], node_dc [Np], attr_rank [Np, A]
    None, None, None,   # ask_res [Gp, R], ask_desired [Gp], distinct [Gp]
    None,               # dc_ok [Gp, NDC]
    -1, -1, -1,         # host_ok, coll0, penalty [Gp, Np]
    None, None, None,   # c_op / c_col / c_rank [Gp, C]
    None, None, None, None,   # a_op / a_col / a_rank / a_weight [Gp, CA]
    -1,                 # a_host [Gp, Np]
    None, None, None,   # sp_col / sp_weight / sp_targeted [Gp, S]
    None, None, None,   # sp_desired / sp_implicit / sp_used0
    0, 0,               # dev_cap, dev_used0 [Np, D]
    None, None, None,   # dev_ask [Gp, D], p_ask [K], n_place
)


def _kernel_positional_count() -> int:
    """Required positional parameters of solve_steps (everything before
    the defaulted `seed`)."""
    sig = inspect.signature(solve_steps)
    return sum(1 for p in sig.parameters.values()
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               and p.default is p.empty)


# _ARG_SPLIT is kept by hand beside solve_steps' signature: an argument
# added without a split would shift every later one
assert len(_ARG_SPLIT) == _kernel_positional_count(), (
    f"sharded._ARG_SPLIT lists {len(_ARG_SPLIT)} splits but solve_steps "
    f"takes {_kernel_positional_count()} positional args")


class Mesh:
    """A grid of torch.devices with named axes (the reference's
    `jax.sharding.Mesh`): shard i of the node axis is the i-th device of
    the grid in row-major order.  A device may appear more than once."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        shape = np.asarray(devices, dtype=object).shape
        grid = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            grid[i] = d
        self.devices = grid.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))


def _device_list(n_devices: Optional[int], devices) -> List[torch.device]:
    """The mesh's devices: `devices` (default every CUDA device; raises
    without a GPU), cut to `n_devices`, or repeated in contiguous blocks
    when more shards than devices are asked for."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices={n} invalid: must be positive")
    if n <= len(devices):
        return devices[:n]
    return [devices[i * len(devices) // n] for i in range(n)]


def _grid(devs: List[torch.device], shape) -> np.ndarray:
    g = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        g[i] = d
    return g.reshape(shape)


def make_mesh(n_devices: Optional[int] = None, n_regions: int = 1,
              devices=None) -> Mesh:
    """A ("region", "nodes") grid: the stateless wrapper's and the
    federated solve's layout."""
    devs = _device_list(n_devices, devices)
    n = len(devs)
    if n % n_regions:
        raise ValueError("devices must divide evenly into regions")
    return Mesh(_grid(devs, (n_regions, n // n_regions)),
                ("region", "nodes"))


def make_node_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the node axis (the mesh-resident solver's
    layout).  `make_node_mesh(8, devices=[torch.device("cuda")])` puts
    eight shards on one GPU."""
    devs = _device_list(n_devices, devices)
    return Mesh(_grid(devs, (len(devs),)), (MESH_NODE_AXIS,))


def env_mesh_hosts() -> Optional[int]:
    """NOMAD_TPU_MESH_HOSTS: host-group count for the two-tier mesh
    (unset/empty/0 -> None: flat single-tier)."""
    import os
    raw = os.environ.get("NOMAD_TPU_MESH_HOSTS", "").strip()
    if not raw or raw == "0":
        return None
    try:
        h = int(raw)
    except ValueError:
        raise ValueError(
            f"NOMAD_TPU_MESH_HOSTS={raw!r} invalid: use a positive "
            "host-group count (0/unset = flat mesh)") from None
    if h <= 0:
        raise ValueError(
            f"NOMAD_TPU_MESH_HOSTS={h} invalid: must be positive")
    return h


def env_mesh_regions() -> Optional[int]:
    """NOMAD_TPU_MESH_REGIONS: region count for the three-tier mesh
    (unset/empty/0 -> None: no WAN tier)."""
    import os
    raw = os.environ.get("NOMAD_TPU_MESH_REGIONS", "").strip()
    if not raw or raw == "0":
        return None
    try:
        r = int(raw)
    except ValueError:
        raise ValueError(
            f"NOMAD_TPU_MESH_REGIONS={raw!r} invalid: use a positive "
            "region count (0/unset = no WAN tier)") from None
    if r <= 0:
        raise ValueError(
            f"NOMAD_TPU_MESH_REGIONS={r} invalid: must be positive")
    return r


def make_two_tier_mesh(n_hosts: Optional[int] = None,
                       n_devices: Optional[int] = None,
                       devices=None) -> Mesh:
    """A ("hosts", "chips") mesh: the shards factored into n_hosts
    contiguous groups.  n_hosts defaults to NOMAD_TPU_MESH_HOSTS."""
    devs = _device_list(n_devices, devices)
    n = len(devs)
    if n_hosts is None:
        n_hosts = env_mesh_hosts() or 1
    if n_hosts <= 0 or n % n_hosts:
        raise ValueError(
            f"{n} devices do not factor into {n_hosts} hosts x "
            f"{n / max(n_hosts, 1):g} chips; pick a host count that "
            "divides the device count")
    return Mesh(_grid(devs, (n_hosts, n // n_hosts)),
                (MESH_HOST_AXIS, MESH_CHIP_AXIS))


def make_three_tier_mesh(n_regions: Optional[int] = None,
                         n_hosts: Optional[int] = None,
                         n_devices: Optional[int] = None,
                         devices=None) -> Mesh:
    """A ("regions", "hosts", "chips") mesh: the shards factored into
    n_regions contiguous region groups of n_hosts hosts each (n_hosts is
    hosts PER REGION).  Defaults come from NOMAD_TPU_MESH_REGIONS /
    NOMAD_TPU_MESH_HOSTS."""
    devs = _device_list(n_devices, devices)
    n = len(devs)
    if n_regions is None:
        n_regions = env_mesh_regions() or 1
    if n_hosts is None:
        n_hosts = env_mesh_hosts() or 1
    if (n_regions <= 0 or n_hosts <= 0 or n % n_regions
            or (n // n_regions) % n_hosts):
        raise ValueError(
            f"{n} devices do not factor into {n_regions} regions x "
            f"{n_hosts} hosts x chips; pick counts whose product "
            "divides the device count")
    return Mesh(_grid(devs, (n_regions, n_hosts,
                             n // (n_regions * n_hosts))),
                (MESH_REGION_AXIS, MESH_HOST_AXIS, MESH_CHIP_AXIS))


def mesh_node_axes(mesh: Mesh):
    """(axes, n_hosts): the solve_steps `mesh_axis` value of a solver
    mesh ("nodes", ("hosts", "chips") or ("regions", "hosts", "chips"))
    and its host count (hosts PER REGION on three tiers)."""
    names = mesh.axis_names
    if MESH_HOST_AXIS in names and MESH_CHIP_AXIS in names:
        if MESH_REGION_AXIS in names:
            return ((MESH_REGION_AXIS, MESH_HOST_AXIS, MESH_CHIP_AXIS),
                    int(mesh.shape[MESH_HOST_AXIS]))
        return ((MESH_HOST_AXIS, MESH_CHIP_AXIS),
                int(mesh.shape[MESH_HOST_AXIS]))
    if MESH_NODE_AXIS in names:
        return MESH_NODE_AXIS, 1
    raise ValueError(
        f"mesh must carry a '{MESH_NODE_AXIS}' axis or the "
        f"('{MESH_HOST_AXIS}', '{MESH_CHIP_AXIS}') pair "
        f"(optionally under '{MESH_REGION_AXIS}'), got {names}")


def mesh_region_count(mesh: Mesh) -> int:
    """Region fan-out of a solver mesh (1 without a region tier)."""
    return (int(mesh.shape[MESH_REGION_AXIS])
            if MESH_REGION_AXIS in mesh.axis_names else 1)


def _mesh_kw(mesh: Mesh) -> Dict:
    axes, n_hosts = mesh_node_axes(mesh)
    return dict(mesh_axis=axes, mesh_shards=mesh.size, mesh_hosts=n_hosts,
                mesh_regions=mesh_region_count(mesh))


def _node_mesh(mesh: Mesh) -> Mesh:
    """The node-axis mesh of a ("region", "nodes") grid: its first row
    (the stateless wrapper splits only the node axis; the reference's
    region rows hold replicas)."""
    if "region" in mesh.axis_names:
        return Mesh(mesh.devices[0], (MESH_NODE_AXIS,))
    return mesh


def _on(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


def kernel_args(pb: PackedBatch) -> Tuple:
    """PackedBatch -> solve_steps positional arguments."""
    return (pb.avail, pb.reserved, pb.used0, pb.valid, pb.node_dc,
            pb.attr_rank, pb.ask_res, pb.ask_desired, pb.distinct, pb.dc_ok,
            pb.host_ok, pb.coll0, pb.penalty, pb.c_op, pb.c_col, pb.c_rank,
            pb.a_op, pb.a_col, pb.a_rank, pb.a_weight, pb.a_host, pb.sp_col,
            pb.sp_weight, pb.sp_targeted, pb.sp_desired, pb.sp_implicit,
            pb.sp_used0, pb.dev_cap, pb.dev_used0, pb.dev_ask, pb.p_ask,
            int(pb.n_place))


def _split_args(args: Tuple, mesh: Mesh) -> List[List]:
    """Each shard's positional arguments on its device: node-axis
    arguments sliced to the shard, the rest replicated (one copy a
    distinct device)."""
    devs = mesh.flat_devices()
    S = len(devs)
    Np = np.shape(args[0])[0]
    if Np % S:
        raise ValueError(f"padded node axis {Np} does not divide over "
                         f"{S} shards")
    npl = Np // S
    rep: Dict = {}
    out = []
    for i, d in enumerate(devs):
        row = []
        for j, (a, sp) in enumerate(zip(args, _ARG_SPLIT)):
            if isinstance(a, (int, np.integer)):
                row.append(int(a))
            elif sp is None:
                if (j, d) not in rep:
                    rep[(j, d)] = _on(a, d)
                row.append(rep[(j, d)])
            elif sp == 0:
                row.append(_on(a[i * npl:(i + 1) * npl], d))
            else:
                row.append(_on(a[..., i * npl:(i + 1) * npl], d))
        out.append(row)
    return out


def _assemble(results: List[SolveResult]) -> SolveResult:
    """One SolveResult from the shards': the replicated fields of shard
    0, the node-axis planes (`feas`, the final usage) concatenated on
    shard 0's device."""
    r0 = results[0]
    dev = r0.choice.device

    def cat(name, dim):
        return torch.cat([getattr(r, name).to(dev) for r in results],
                         dim=dim)
    return r0._replace(feas=cat("feas", 1), used_final=cat("used_final", 0),
                       dev_used_final=cat("dev_used_final", 0))


def sharded_solve_args(args: Tuple, mesh: Mesh, **kw) -> SolveResult:
    """One solve with the node axis split over the mesh's node axis
    (`kernel_args` order; keywords as solve_steps takes them)."""
    mesh = _node_mesh(mesh)
    kw.update(_mesh_kw(mesh))
    shards = _split_args(args, mesh)
    return _assemble(solve_shards([solve_steps(*a, **kw) for a in shards],
                                  mesh))


def sharded_solve(pb: PackedBatch, mesh: Mesh, **kw) -> SolveResult:
    return sharded_solve_args(kernel_args(pb), mesh, **kw)


def _federated_kernel(stacked: Tuple, n_places: Sequence[int], mesh: Mesh,
                      **kw) -> SolveResult:
    """R independent solves of the planes `stacked` on a leading region
    axis (`kernel_args` order without n_place; `n_places` [R]), region r
    on row r of a ("region", "nodes") mesh, split over the row's shards
    when it has more than one, each with `wave_mode="while"` and the
    shortlist off, as the reference's vmap of solve_kernel.  The results
    stack on a leading region axis on row 0's first device."""
    kw = dict(kw, wave_mode="while", shortlist_c=-1)
    R = len(n_places)
    rows = np.asarray(mesh.devices, dtype=object).reshape(R, -1)
    out = []
    for r in range(R):
        args = tuple(a[r] for a in stacked) + (int(n_places[r]),)
        row = Mesh(rows[r], (MESH_NODE_AXIS,))
        if row.size == 1:
            d = row.flat_devices()[0]
            out.append(solve_kernel(*[_on(a, d) for a in args[:-1]],
                                    args[-1], **kw))
        else:
            out.append(sharded_solve_args(args, row, **kw))
    dev = out[0].choice.device
    fields = {}
    for name in SolveResult._fields:
        vals = [getattr(r, name) for r in out]
        if vals[0] is None:
            fields[name] = None
        elif isinstance(vals[0], torch.Tensor):
            fields[name] = torch.stack([v.to(dev) for v in vals])
        else:
            fields[name] = torch.tensor(vals, device=dev)
    return SolveResult(**fields)


def federated_solve(pbs: Sequence[PackedBatch], mesh: Mesh,
                    **kw) -> SolveResult:
    """Solve R regions at once, region r on row r of the mesh.  Every
    batch must share shapes (one Tensorizer a region with the same
    padding)."""
    per_region = [kernel_args(pb) for pb in pbs]
    shapes = {tuple(np.shape(a) for a in args[:-1]) for args in per_region}
    if len(shapes) != 1:
        raise ValueError("region batches must be shape-aligned")
    if mesh.devices.shape[0] != len(pbs):
        raise ValueError(f"{len(pbs)} regions on a mesh of "
                         f"{mesh.devices.shape[0]} region rows")
    stacked = tuple(np.stack([args[i] for args in per_region])
                    for i in range(len(per_region[0]) - 1))
    return _federated_kernel(stacked, [args[-1] for args in per_region],
                             mesh, **kw)


# ------------------------------------------------------- byte models
def model_ici_bytes(Gp: int, K: int, A: int, R: int, TKl: int,
                    n_shards: int, want_tables: bool, V: int, TW: int,
                    has_spread: bool) -> Dict:
    """Per-wave interconnect byte model of the mesh-resident solve (the
    tier beside resident.model_wave_bytes' two memory tiers).

    `bytes_ici_per_wave` is the candidate-key traffic: each shard's
    [Gp, tk_local] (f32 score, i32 global id) window and table keys
    gathered across `n_shards`, equal by construction to tk_local x Gp x
    n_shards x key_bytes; no [Gp, Np] plane term appears.
    `bytes_ici_commit_per_wave` adds the K-sized commit-phase sums (fit
    votes, candidate attribute rows, explainability counters)."""
    key_bytes = 8                       # f32 score + i32 node id
    tk_local = TKl + ((V + 1) * TW if want_tables else 0)
    window = Gp * tk_local * key_bytes * n_shards
    commit = (2 * K * 4                          # fit / dev-fit votes
              + (K * A * 4 if has_spread else 0)  # candidate attr rows
              + (3 * Gp + Gp * R) * 4             # counters + grp_any
              ) * n_shards
    return {"key_bytes": key_bytes, "tk_local": int(tk_local),
            "devices": int(n_shards),
            "bytes_ici_per_wave": int(window),
            "bytes_ici_commit_per_wave": int(commit),
            "bytes_ici_total_per_wave": int(window + commit),
            "bound_candidate_keys": int(
                tk_local * Gp * n_shards * key_bytes)}


def model_ici_dcn_bytes(Gp: int, K: int, A: int, R: int, TK: int,
                        TKl: int, n_shards: int, n_hosts: int,
                        want_tables: bool, V: int, TKv: int, TW: int,
                        has_spread: bool) -> Dict:
    """Two-tier per-wave interconnect byte model, the host-tier
    generalization of model_ici_bytes.

    A tier's bytes a wave count the bytes entering devices across that
    tier's links, fleet-wide.  The flat exchange is host-oblivious: each
    chip imports (S - CPH) remote chunks across hosts.  The tiered
    exchange merges each host first and ships only chip-sliced
    host-winner windows across hosts, one host window a traversal, in
    log2(H) recursive-doubling rounds (power-of-two H; one sliced gather
    otherwise).  Commit sums tier the same way.  `dcn_cut_vs_flat` is
    the tiered exchange's cross-host bytes over the flat exchange's."""
    key_bytes = 8
    H = max(n_hosts, 1)
    CPH = n_shards // H
    tk_local = TKl + ((V + 1) * TW if want_tables else 0)
    ck = Gp * tk_local * key_bytes
    tk_host = (min(TK, TKl * CPH)
               + ((V + 1) * min(TKv, TW * CPH) if want_tables else 0))
    ch = Gp * tk_host * key_bytes
    cc = (2 * K * 4
          + (K * A * 4 if has_spread else 0)
          + (3 * Gp + Gp * R) * 4)
    flat_dcn_window = H * CPH * (n_shards - CPH) * ck
    # a sum ~ reduce-scatter + all-gather: 2(S-1)/S chunk imports a
    # chip, (S-CPH)/(S-1) of them crossing hosts
    flat_dcn_commit = (2 * H * CPH * (n_shards - CPH) * cc
                       // max(n_shards, 1))
    if H > 1 and H & (H - 1) == 0:
        rounds = H.bit_length() - 1
        dcn_window = H * rounds * ch
    elif H > 1:
        rounds = 1
        dcn_window = H * (H - 1) * ch
    else:
        rounds = 0
        dcn_window = 0
    ici_window = (H * CPH * (CPH - 1) * ck
                  + H * CPH * rounds * ch * (CPH - 1) // max(CPH, 1))
    ici_commit = 2 * H * CPH * (CPH - 1) * cc // max(CPH, 1)
    dcn_commit = (2 * (H - 1) * cc) if H > 1 else 0
    dcn_total = dcn_window + dcn_commit
    flat_dcn_total = flat_dcn_window + flat_dcn_commit
    return {
        "key_bytes": key_bytes, "n_hosts": int(H),
        "chips_per_host": int(CPH),
        "tk_local": int(tk_local), "tk_host": int(tk_host),
        "bytes_ici_per_wave": int(ici_window + ici_commit),
        "bytes_dcn_window_per_wave": int(dcn_window),
        "bytes_dcn_commit_per_wave": int(dcn_commit),
        "bytes_dcn_total_per_wave": int(dcn_total),
        "flat_dcn_window_per_wave": int(flat_dcn_window),
        "flat_dcn_total_per_wave": int(flat_dcn_total),
        "dcn_cut_vs_flat": (float(dcn_total) / float(flat_dcn_total)
                            if flat_dcn_total else 0.0),
    }


def model_ici_dcn_wan_bytes(Gp: int, K: int, A: int, R: int, TK: int,
                            TKl: int, n_shards: int, n_regions: int,
                            n_hosts: int, want_tables: bool, V: int,
                            TKv: int, TW: int,
                            has_spread: bool) -> Dict:
    """Three-tier per-wave interconnect byte model, the region-tier
    generalization of model_ici_dcn_bytes (`n_hosts` is hosts PER
    REGION).  Within a region the two-tier exchange runs unchanged;
    across regions only region-winner windows travel, one region window
    a traversal in log2(Rg) rounds, and one commit vector crosses
    regions a region a sum.  `wan_cut_vs_flat` is the tiered exchange's
    cross-region bytes over the flat exchange's."""
    key_bytes = 8
    Rg = max(n_regions, 1)
    SPR = n_shards // Rg
    base = model_ici_dcn_bytes(Gp, K, A, R, TK, TKl, SPR, n_hosts,
                               want_tables, V, TKv, TW, has_spread)
    H = max(n_hosts, 1)
    CPH = SPR // H
    tk_local = base["tk_local"]
    ck = Gp * tk_local * key_bytes
    tk_region = (min(TK, TKl * SPR)
                 + ((V + 1) * min(TKv, TW * SPR) if want_tables else 0))
    cr = Gp * tk_region * key_bytes
    cc = (2 * K * 4
          + (K * A * 4 if has_spread else 0)
          + (3 * Gp + Gp * R) * 4)
    flat_wan_window = n_shards * (n_shards - SPR) * ck
    flat_wan_commit = (2 * n_shards * (n_shards - SPR) * cc
                       // max(n_shards, 1))
    if Rg > 1 and Rg & (Rg - 1) == 0:
        rounds = Rg.bit_length() - 1
        wan_window = Rg * rounds * cr
    elif Rg > 1:
        rounds = 1
        wan_window = Rg * (Rg - 1) * cr
    else:
        rounds = 0
        wan_window = 0
    intra_reassembly = (Rg * SPR * rounds * cr * (SPR - 1)
                        // max(SPR, 1))
    wan_commit = (2 * (Rg - 1) * cc) if Rg > 1 else 0
    wan_total = wan_window + wan_commit
    flat_wan_total = flat_wan_window + flat_wan_commit
    return {
        "key_bytes": key_bytes, "n_regions": int(Rg),
        "shards_per_region": int(SPR), "n_hosts": int(H),
        "chips_per_host": int(CPH),
        "tk_local": int(tk_local), "tk_host": base["tk_host"],
        "tk_region": int(tk_region),
        "bytes_ici_per_wave": int(
            Rg * base["bytes_ici_per_wave"] + intra_reassembly),
        "bytes_dcn_total_per_wave": int(
            Rg * base["bytes_dcn_total_per_wave"]),
        "bytes_wan_window_per_wave": int(wan_window),
        "bytes_wan_commit_per_wave": int(wan_commit),
        "bytes_wan_total_per_wave": int(wan_total),
        "flat_wan_window_per_wave": int(flat_wan_window),
        "flat_wan_total_per_wave": int(flat_wan_total),
        "wan_cut_vs_flat": (float(wan_total) / float(flat_wan_total)
                            if flat_wan_total else 0.0),
    }


# ------------------------------------------------------ the stream
def _sharded_stream(nodes, used0, dev_used0, stacked, n_places, seeds, *,
                    mesh, compact=True, has_preempt=False, **kw):
    """The resident stream with every solve in mesh mode (the reference's
    `_sharded_stream_body`): `nodes` holds each shard's node planes (and
    its layout tables on the elastic layout), `used0` / `dev_used0` each
    shard's usage, `stacked` each shard's [B, ...] ask planes.  B solves
    in turn, usage threading from batch to batch.  Returns (used,
    dev_used (lists a shard), out [B, K, 2*TOP_K+1], evict, waves,
    rescores, syncs (over all shards)), the packed results on shard 0's
    device."""
    kw.update(_mesh_kw(mesh))
    S = len(nodes)
    used, dev_used = list(used0), list(dev_used0)
    outs, evicts, waves, rescores, syncs = [], [], [], [], []
    for b, (n_place, seed) in enumerate(zip(n_places, seeds)):
        batch = [{k: v[i][b] for k, v in stacked.items()} for i in range(S)]
        res = _solve_one(nodes, used, dev_used, batch, int(n_place),
                         int(seed), mesh=mesh, has_preempt=has_preempt, **kw)
        r0 = res[0]
        status = _status(r0.choice_ok[:, 0], r0.unfinished)
        outs.append(_pack_out(r0.choice, r0.score, status, compact))
        evicts.append(r0.evict if has_preempt else torch.zeros(
            (r0.choice.shape[0], 1), dtype=torch.bool,
            device=r0.choice.device))
        waves.append(r0.n_waves)
        rescores.append(r0.n_rescore)
        syncs.append(sum(r.n_syncs for r in res))
        used = [r.used_final for r in res]
        dev_used = [r.dev_used_final for r in res]
    return (used, dev_used, torch.stack(outs), torch.stack(evicts),
            np.asarray(waves, np.int32), np.asarray(rescores, np.int32),
            np.asarray(syncs, np.int32))


class ShardedResidentSolver(ResidentSolver):
    """ResidentSolver whose node planes live split across a mesh.

    Same surface as ResidentSolver (pack_batch / merge_asks /
    solve_stream / apply_delta / wave_traffic), but:

      * avail / reserved / valid / attr_rank / dev_cap and the carried
        used / dev_used are lists with one tensor a shard, each on its
        shard's device, put once;
      * apply_delta routes each scattered row to the shard that owns it
        (`_sharded_scatter`), so a delta moves only its rows;
      * solve_stream runs every solve in mesh mode: scoring, extraction
        and the shortlist stay on each shard and only candidate keys and
        K-sized sums cross shards; placements and explainability
        counters equal the flat solve's;
      * wave_traffic adds the interconnect tiers.

    The ask planes ship dense (not bitpacked): a packed word of 32 node
    columns cannot be split on the node axis.  The stream is serial:
    `fused_lanes` and `solve_parallel` are not part of the mesh solvers,
    as in the reference, whose sharded program is the serial stream.

    `mesh` (from make_node_mesh, make_two_tier_mesh or
    make_three_tier_mesh) shapes the solver: three tiers, two, or the
    flat mesh.  Without one, NOMAD_TPU_MESH_REGIONS > 1 builds the
    three-tier mesh, NOMAD_TPU_MESH_HOSTS > 1 the two-tier one, and
    otherwise the flat mesh, over `n_devices` of every CUDA device.
    """

    _pack_bool_planes = False
    #: subclass flag: the elastic solver owns the node axis by tile
    #: remap instead of contiguous blocks
    _elastic = False

    def __init__(self, nodes, probe_asks, *args,
                 mesh: Optional[Mesh] = None,
                 n_devices: Optional[int] = None, **kw):
        if mesh is None:
            regions = env_mesh_regions()
            hosts = env_mesh_hosts()
            if regions and regions > 1:
                mesh = make_three_tier_mesh(regions, hosts or 1,
                                            n_devices)
            elif hosts and hosts > 1:
                mesh = make_two_tier_mesh(hosts, n_devices)
            else:
                mesh = make_node_mesh(n_devices)
        kw["device"] = mesh.flat_devices()[0]
        self._set_mesh(mesh)
        super().__init__(nodes, probe_asks, *args, **kw)
        Np = self.template.avail.shape[0]
        if not self._elastic and Np % self.n_shards:
            raise ValueError(
                f"padded node axis {Np} does not divide over "
                f"{self.n_shards} shards")

    def _set_mesh(self, mesh: Mesh) -> None:
        """Bind a mesh: its node-axis split and its shards' devices.  The
        elastic reshard and recovery paths rebind as shards leave and
        rejoin."""
        self._mesh = mesh
        axes, n_hosts = mesh_node_axes(mesh)
        self._axis = axes
        self.n_hosts = n_hosts            # hosts PER REGION (three tiers)
        self.n_regions = mesh_region_count(mesh)
        self._devs = mesh.flat_devices()
        self.n_shards = len(self._devs)
        self.shards_per_region = self.n_shards // max(self.n_regions, 1)
        self.chips_per_host = self.shards_per_region // max(n_hosts, 1)
        self.two_tier = isinstance(axes, tuple)
        self.three_tier = self.two_tier and len(axes) == 3

    # ---------------- sharded placement hooks ----------------
    def _split_rows(self, arr) -> List[torch.Tensor]:
        """A node-axis array as one tensor a shard (leading axis split;
        the array is copied first, so no shard aliases the template)."""
        a = np.array(_host(arr))
        npl = a.shape[0] // self.n_shards
        return [torch.as_tensor(a[i * npl:(i + 1) * npl]).to(d)
                for i, d in enumerate(self._devs)]

    def _replicated(self, arr) -> List[torch.Tensor]:
        """One copy of `arr` a distinct shard device, listed a shard."""
        per_dev: Dict = {}
        out = []
        for d in self._devs:
            if d not in per_dev:
                per_dev[d] = torch.as_tensor(np.array(arr)).to(d)
            out.append(per_dev[d])
        return out

    def _split_cols(self, arr) -> List[torch.Tensor]:
        a = np.asarray(arr)
        npl = a.shape[-1] // self.n_shards
        return [torch.as_tensor(np.ascontiguousarray(
            a[..., i * npl:(i + 1) * npl])).to(d)
            for i, d in enumerate(self._devs)]

    def _put_node(self, name, arr):
        return self._split_rows(arr)

    def _put_ask(self, name, arr):
        if name in _PLANE_ASK_ARGS:
            return self._split_cols(arr)
        return self._replicated(arr)

    # ---------------- delta lifecycle ----------------
    def _sharded_scatter(self, op: str, arr, idx, rows):
        """Scatter rows into a split plane, each row to the shard that
        owns its device-layout row (the global row on the contiguous
        layout; the elastic solver translates first).  Rows outside every
        shard's range drop, as the reference pins them to its dropped
        slot."""
        idx = np.asarray(_host(idx), np.int64)
        rows = np.asarray(_host(rows))
        fn = delta_scatter_set if op == "set" else delta_scatter_add
        out = list(arr)
        lo = 0
        for i, a in enumerate(arr):
            npl = a.shape[0]
            own = (idx >= lo) & (idx < lo + npl)
            if own.any():
                out[i] = fn(a, idx[own] - lo, rows[own])
            lo += npl
        return out

    def _delta_set(self, arr, idx, rows):
        return self._sharded_scatter("set", arr, idx, rows)

    def _delta_add(self, arr, idx, rows):
        return self._sharded_scatter("add", arr, idx, rows)

    # ---------------- solving ----------------
    def _shard_nodes(self) -> List[Dict]:
        """Each shard's node planes (with its layout tables on the
        elastic layout), as `_solve_steps` takes them."""
        return [{k: v[i] for k, v in self._dev_node.items()}
                for i in range(self.n_shards)]

    def _elastic_kw(self) -> Dict:
        """tile_np / mesh_nt for the solve (none on the contiguous
        layout)."""
        return {}

    def solve_stream_async(self, batches: Sequence[PackedBatch],
                           seeds: Optional[Sequence[int]] = None,
                           lanes: Optional[int] = None) -> torch.Tensor:
        """Dispatch a stream (always the serial stream on the mesh) and
        return its packed result on shard 0's device."""
        self._check_stream_jobs(batches)
        self._check_batch_axis(batches)
        stacked = self._stack_args(batches)
        n_places = [pb.n_place for pb in batches]
        seed_list = [0] * len(batches) if seeds is None else list(seeds)
        has_distinct = self._has_distinct(batches)
        preempt = self._preempt_on(has_distinct)
        self.last_lane_counters = None
        (self._used, self._dev_used, out, self.last_evict, self.last_waves,
         self.last_rescore_waves, self.last_syncs) = _sharded_stream(
            self._shard_nodes(), self._used, self._dev_used, stacked,
            n_places, seed_list, mesh=self._mesh, compact=self._compact,
            has_preempt=preempt, **self._solve_kw(batches, has_distinct),
            **self._elastic_kw())
        # a mesh solve's waves run op by op (collectives mid-wave), its
        # commits keep their scatters, and its shards count no filtered
        # pairs
        self.last_graphed = self.last_captures = np.zeros(len(batches),
                                                          np.int32)
        self.last_conflict_kernel = np.zeros(len(batches), np.int32)
        self.last_filtered = np.zeros(len(batches), np.int64)
        count_dispatch(self.last_waves, self.last_rescore_waves,
                       self.last_syncs)
        return out

    def solve_parallel(self, batches):
        raise NotImplementedError(
            "solve_parallel is not part of the mesh solvers; use "
            "solve_stream")

    # ---------------- state ----------------
    def _fetch_rows(self, planes) -> np.ndarray:
        """A split plane fetched whole, in device-layout row order."""
        return np.concatenate([_host(p) for p in planes])

    def usage(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._fetch_rows(self._used), self._fetch_rows(self._dev_used)

    def plane_checksum(self) -> int:
        from ..solver.tensorize import plane_crc
        t = self.template
        dn = {k: self._fetch_rows(v) for k, v in self._dev_node.items()}
        meta = f"{t.n_real}:{','.join(t.node_ids)}".encode()
        return plane_crc(dn["avail"], dn["reserved"], dn["valid"],
                         dn["node_dc"], dn["attr_rank"], dn["dev_cap"],
                         ev_prio=dn.get("ev_prio"), ev_res=dn.get("ev_res"),
                         meta=meta)

    # ---------------- byte model ----------------
    def measured_wave_counters(self) -> Optional[Dict]:
        """Mesh units: rescore_waves counts per-SHARD full passes, so the
        shortlist remainder is taken against waves x shards."""
        m = super().measured_wave_counters()
        if m is not None:
            m["shard_waves_total"] = m["waves_total"] * self.n_shards
            m["shortlist_waves"] = max(
                m["shard_waves_total"] - m["rescore_waves"], 0)
        return m

    def wave_traffic(self, batches: Sequence[PackedBatch]) -> Dict:
        """The inherited memory tiers restated PER SHARD (each shard
        walks its Np / S slice of every plane) plus the interconnect
        tiers: `ici` always, `dcn` on two tiers and the elastic layout,
        `wan` on three; `measured` gains the modeled totals over the
        measured wave counters."""
        out = super().wave_traffic(batches)
        t = self.template
        Np, R = t.avail.shape
        Npl = self._np_local()
        Gp = max(pb.ask_res.shape[0] for pb in batches)
        K = max(pb.p_ask.shape[0] for pb in batches)
        A = t.attr_rank.shape[1]
        S = t.sp_desired.shape[1]
        V = t.sp_desired.shape[2]
        has_spread = self._has_spread(batches)
        hint = self._group_count_hint(batches)
        w_cap = (_MERGED_W_CAP if Gp <= MERGED_GP_MAX else _WIDE_W_CAP)
        TK = min(max(WAVE_K, min(2 * hint, w_cap)) + TOP_K, Np)
        TKl = min(TK, Npl)
        C = (0 if self._has_distinct(batches)
             else resolve_shortlist_c(Npl, TKl, self.shortlist_c))
        mode = self.pallas
        if mode == "auto":
            mode = _wk.resolve_mode(Npl, Gp, TKl, V, has_spread,
                                    on=self.device.type == "cuda")
        want_tables = has_spread and V <= 8 and not self.stack_commit
        TKv = -(-TK // (V + 1)) if want_tables else 0
        TW = min(TKv, Npl) if want_tables else 0
        out["ici"] = model_ici_bytes(Gp, K, A, R, TKl, self.n_shards,
                                     want_tables, V, TW, has_spread)
        out["bytes_ici_per_wave"] = out["ici"]["bytes_ici_per_wave"]
        n_reg = self.n_regions
        if self.two_tier or self._elastic:
            out["dcn"] = model_ici_dcn_bytes(
                Gp, K, A, R, TK, TKl, self.n_shards // max(n_reg, 1),
                self.n_hosts if self.two_tier else 1,
                want_tables, V, TKv, TW, has_spread)
            out["bytes_dcn_per_wave"] = \
                out["dcn"]["bytes_dcn_total_per_wave"]
        if self.three_tier and n_reg > 1:
            out["wan"] = model_ici_dcn_wan_bytes(
                Gp, K, A, R, TK, TKl, self.n_shards, n_reg,
                self.n_hosts, want_tables, V, TKv, TW, has_spread)
            out["bytes_wan_per_wave"] = \
                out["wan"]["bytes_wan_total_per_wave"]
        b1, brw, passes = model_wave_bytes(
            Npl, Gp, K, S, R, has_spread, mode, TKl, C)
        out["per_shard"] = {"np_local": int(Npl),
                            "bytes_wave1": int(b1),
                            "bytes_rewave": int(brw),
                            "shortlist_c": int(C),
                            "fused_pass_count": passes}
        m = out.get("measured")
        if m is not None:
            shortlist_shard_waves = (m["waves_total"] * self.n_shards
                                     - m["rescore_waves"])
            m["modeled_bytes_total"] = int(
                b1 * m["rescore_waves"]
                + brw * max(shortlist_shard_waves, 0))
            m["modeled_bytes_ici_total"] = int(
                out["ici"]["bytes_ici_total_per_wave"] * m["waves_total"])
            if "dcn" in out:
                m["modeled_bytes_dcn_total"] = int(
                    out["dcn"]["bytes_dcn_total_per_wave"]
                    * m["waves_total"])
                m["modeled_bytes_dcn_flat_total"] = int(
                    out["dcn"]["flat_dcn_total_per_wave"]
                    * m["waves_total"])
            if "wan" in out:
                m["modeled_bytes_wan_total"] = int(
                    out["wan"]["bytes_wan_total_per_wave"]
                    * m["waves_total"])
                m["modeled_bytes_wan_flat_total"] = int(
                    out["wan"]["flat_wan_total_per_wave"]
                    * m["waves_total"])
        return out

    def _np_local(self) -> int:
        """Per-shard node-axis width (the elastic layout carries slack
        beyond Np // n_shards)."""
        return self.template.avail.shape[0] // self.n_shards


# ===================================================================
# Elastic mesh: tile-granular reshard and shard-loss recovery
# ===================================================================

#: dead-slot fill per node plane (the tensorizer's padding)
_LAYOUT_FILLS = {"valid": False, "attr_rank": -1, "ev_prio": -1}

#: free tile slots a shard keeps for grow / move / recover by default
#: (NOMAD_TPU_RESHARD_SLACK overrides)
RESHARD_SLACK_TILES = 1


class ElasticShardedResidentSolver(ShardedResidentSolver):
    """ShardedResidentSolver whose node axis is owned in shard-tiles
    routed by an owner remap table (tensorize.TileLayout) instead of
    contiguous blocks.

      * ``grow_tiles`` extends the global node axis by whole tiles and
        ships only the new tiles' plane rows: no world repack;
      * ``move_tile`` rebalances one tile between shards, carrying its
        usage: the moved tile's rows are the only bytes that travel;
      * ``shrink_tiles`` retires empty tiles;
      * ``fail_shard`` / ``recover`` is the shard-loss state machine: on
        loss the surviving shards keep solving at degraded width (the
        lost tiles' nodes drop out), and ``recover`` rebuilds the lost
        planes from the host template and rejoins them, usage restored
        to the last plan-fed state.

    Placements and explainability counters equal the flat solve over the
    live nodes through any interleaving: candidate keys carry global node
    ids and every extraction and merge orders them by (score desc,
    global id asc) wherever a tile lives (solve_steps `tile_np`).
    The tile width is `tile_np`, else pick_tile_np's (which reads
    NOMAD_TPU_SHARD_TILE); each shard keeps `slack_tiles` free tile
    slots, else NOMAD_TPU_RESHARD_SLACK, else RESHARD_SLACK_TILES.
    """

    _elastic = True
    _fresh_layout = True

    def __init__(self, nodes, probe_asks, *args,
                 mesh: Optional[Mesh] = None, event_log=None,
                 tile_np: Optional[int] = None,
                 slack_tiles: Optional[int] = None, **kw):
        import os
        from ..utils.tracing import global_mesh_events
        self._tile_np_req = tile_np
        self._slack_tiles = (
            slack_tiles if slack_tiles is not None
            else int(os.environ.get("NOMAD_TPU_RESHARD_SLACK",
                                    str(RESHARD_SLACK_TILES))))
        #: reshard / recovery counters
        self.reshard_counters = {
            "tiles_grown": 0, "tiles_moved": 0, "tiles_shrunk": 0,
            "tiles_reclaimed": 0,
            "last_reshard_bytes": 0, "reshard_bytes_total": 0,
            "recoveries": 0, "last_recovery_bytes": 0,
            "last_recovery_s": 0.0, "degraded_solves": 0,
        }
        #: every grow / shrink / move / fail / recover transition, with
        #: its bytes and duration (the process-global log by default)
        self.event_log = (global_mesh_events if event_log is None
                          else event_log)
        super().__init__(nodes, probe_asks, *args, mesh=mesh, **kw)

    # ---------------- layout lifecycle ----------------
    def _put_node_side(self) -> None:
        from ..solver.tensorize import TileLayout, pick_tile_np
        if self._fresh_layout:
            NT = self.template.avail.shape[0]
            tile = pick_tile_np(NT, self.n_shards, self._tile_np_req or 0)
            self._layout = TileLayout(NT // tile, self.n_shards, tile,
                                      slack_tiles=self._slack_tiles)
            self.mesh_state = "healthy"
            self._lost_tiles: List[int] = []
            self._orig_mesh = self._mesh
        self._src_cache = self._layout.dev_src()
        super()._put_node_side()
        self._refresh_tables()

    @property
    def tile_np(self) -> int:
        return self._layout.tile_np

    def _np_local(self) -> int:
        return self._layout.npl

    def _elastic_kw(self) -> Dict:
        # mesh_nt caps the candidate window: the from-scratch pad of the
        # real universe, not the tile-grown axis (dead slack slots never
        # hold candidates, and a cap that tracked them would diverge from
        # a fresh pack of the same nodes)
        from ..solver.tensorize import _pad_nodes
        return dict(tile_np=self._layout.tile_np,
                    mesh_nt=_pad_nodes(max(self.template.n_real, 1)))

    def _shard_nodes(self) -> List[Dict]:
        out = super()._shard_nodes()
        for i, nd in enumerate(out):
            nd["node_gid"] = self._dev_gid[i]
            nd["owner_map"] = self._dev_owner[i]
            nd["slot_map"] = self._dev_slot[i]
        return out

    def _refresh_tables(self, gid_rows=None) -> int:
        """(Re)place the layout tables on the shards.  gid_rows =
        (dev_rows, gids) scatters only those rows of the gid vector.
        Returns the bytes shipped."""
        om, sm = self._layout.tables()
        self._dev_owner = self._replicated(om)
        self._dev_slot = self._replicated(sm)
        shipped = int(om.nbytes + sm.nbytes)
        if gid_rows is not None and getattr(self, "_dev_gid",
                                            None) is not None:
            rows, gids = gid_rows
            self._dev_gid = self._sharded_scatter(
                "set", self._dev_gid, np.asarray(rows, np.int32),
                np.asarray(gids, np.int32))
            shipped += int(np.asarray(rows).nbytes
                           + np.asarray(gids).nbytes)
        else:
            gid = self._layout.node_gid(self.template.avail.shape[0])
            self._dev_gid = self._split_rows(gid)
            shipped += int(gid.nbytes)
        return shipped

    # ---------------- layout-aware placement hooks ----------------
    def _to_layout(self, name, arr, axis):
        src = self._src_cache
        a = np.asarray(_host(arr))
        take = np.clip(src, 0, a.shape[axis] - 1)
        fill = _LAYOUT_FILLS.get(name, 0)
        if axis == 0:
            out = np.ascontiguousarray(a[take])
            out[src < 0] = fill
        else:
            out = np.ascontiguousarray(a[..., take])
            out[..., src < 0] = fill
        return out

    def _put_node(self, name, arr):
        return self._split_rows(self._to_layout(
            "used0" if name in ("used", "dev_used") else name, arr, 0))

    def _put_ask(self, name, arr):
        if name in _PLANE_ASK_ARGS:
            return self._split_cols(self._to_layout(name, arr, -1))
        return self._replicated(arr)

    def _back(self, planes) -> np.ndarray:
        """A split plane fetched and routed back to GLOBAL row order
        (rows of no live tile stay 0)."""
        a = self._fetch_rows(planes)
        src = self._src_cache
        live = src >= 0
        out = np.zeros((self.template.avail.shape[0],) + a.shape[1:],
                       a.dtype)
        out[src[live]] = a[live]
        return out

    def plane_checksum(self) -> int:
        """The planes routed back to template (global) order before
        hashing: a healthy mesh covers every global row with exactly one
        live tile, so the result compares with template_checksum."""
        from ..solver.tensorize import plane_crc
        t = self.template
        dn = self._dev_node
        meta = f"{t.n_real}:{','.join(t.node_ids)}".encode()
        return plane_crc(
            self._back(dn["avail"]), self._back(dn["reserved"]),
            self._back(dn["valid"]), self._back(dn["node_dc"]),
            self._back(dn["attr_rank"]), self._back(dn["dev_cap"]),
            ev_prio=(self._back(dn["ev_prio"]) if "ev_prio" in dn
                     else None),
            ev_res=(self._back(dn["ev_res"]) if "ev_res" in dn else None),
            meta=meta)

    # Delta scatters arrive with GLOBAL rows and route through the tile
    # tables to device-layout rows.  Rows in a retired tile (shrunk,
    # then handed to a joining node by the host slot allocator) re-own
    # that tile on demand; rows in a lost tile (shard down) drop on the
    # device: the template keeps the truth and recover() replays it.
    def _reclaim_tiles(self, idx) -> None:
        lay = self._layout
        tiles = np.unique(np.asarray(idx, np.int64) // lay.tile_np)
        lost = set(self._lost_tiles)
        for t in tiles:
            t = int(t)
            if 0 <= t < lay.n_tiles and lay.owner[t] < 0 and t not in lost:
                lay.assign(t, lay.least_loaded())
                self._src_cache = lay.dev_src()
                shipped = self._ship_tile(t)
                self._fresh_tiles.add(t)
                self.reshard_counters["tiles_reclaimed"] += 1
                self.reshard_counters["reshard_bytes_total"] += shipped

    def apply_delta(self, delta, evicted: bool = False) -> str:
        # tiles reclaimed while this delta applies ship template rows that
        # already hold the delta's usage; the usage add must skip them
        self._fresh_tiles: set = set()
        return super().apply_delta(delta, evicted=evicted)

    def _delta_set(self, arr, idx, rows):
        # only "set" scatters reclaim: their rows are real touched slots
        # (the add side's padding zero-fills idx, and row 0's tile must
        # not come back through a pad)
        self._reclaim_tiles(idx)
        return super()._delta_set(
            arr, self._layout.g2d(idx, unowned="drop"), rows)

    def _delta_add(self, arr, idx, rows):
        fresh = getattr(self, "_fresh_tiles", None)
        rows = np.asarray(_host(rows))
        if fresh:
            t = np.asarray(idx, np.int64) // self._layout.tile_np
            hit = np.isin(t, list(fresh))
            if hit.any():
                rows = np.where(hit.reshape((-1,) + (1,) * (rows.ndim - 1)),
                                0, rows).astype(rows.dtype)
        return super()._delta_add(
            arr, self._layout.g2d(idx, unowned="drop"), rows)

    def usage(self):
        """Carried usage in GLOBAL row order (dead / unowned rows 0)."""
        return self._back(self._used), self._back(self._dev_used)

    def _health_live_mask(self):
        """Per-shard device-row liveness: retired and lost tile rows keep
        stale plane values (valid included), since the layout fills apply
        only at put time, so the health kernel masks on tile residency.
        Cached per layout epoch (`_src_cache` is replaced, never mutated,
        on every transition)."""
        src = self._src_cache
        cache = self.__dict__.get("_health_live_dev")
        if cache is None or cache[0] is not src:
            dev = self._split_rows(np.ascontiguousarray(src >= 0))
            self.__dict__["_health_live_dev"] = cache = (src, dev)
        return cache[1]

    def health_row_mask(self) -> np.ndarray:
        """GLOBAL-order mask of the device-resident rows (the host twin's
        view of `_health_live_mask`; lost tiles drop out of both)."""
        src = self._src_cache
        mask = np.zeros(self.template.avail.shape[0], bool)
        mask[src[src >= 0]] = True
        return mask

    def solve_stream_async(self, batches, seeds=None, lanes=None):
        if self.mesh_state == "degraded":
            self.reshard_counters["degraded_solves"] += 1
        return super().solve_stream_async(batches, seeds)

    def repack(self, delta=None, evicted: bool = False) -> None:
        """A full repack rebuilds the world from the template; on a
        degraded mesh it rejoins first, so the lost tiles' usage comes
        back from the template before the repack reads device usage."""
        if getattr(self, "mesh_state", "healthy") == "degraded":
            self.recover()
        super().repack(delta, evicted=evicted)

    # ---------------- tile-granular reshard ----------------
    def _bump_layout_epoch(self) -> None:
        self._node_epoch += 1
        self._ev_epoch += 1
        self._row_cache.clear()
        self._drv_cache.clear()
        self._eval_cache.clear()
        self._const_cache.clear()
        self._stream_stack_cache.clear()

    def _ship_tile(self, t: int, usage=None) -> int:
        """Scatter one tile's plane rows (from the host template) into
        its device location.  Returns the bytes shipped."""
        tile = self._layout.tile_np
        tmpl = self.template
        rows = np.arange(t * tile, (t + 1) * tile)
        dev = self._layout.dev_rows(t).astype(np.int32)
        shipped = 0
        dn = self._dev_node
        plane_srcs = {
            "avail": tmpl.avail, "reserved": tmpl.reserved,
            "valid": tmpl.valid, "node_dc": tmpl.node_dc,
            "attr_rank": tmpl.attr_rank, "dev_cap": tmpl.dev_cap}
        if "ev_prio" in dn:
            plane_srcs["ev_prio"] = tmpl.ev_prio
            plane_srcs["ev_res"] = tmpl.ev_res
        for name, srca in plane_srcs.items():
            payload = np.ascontiguousarray(srca[rows])
            dn[name] = self._sharded_scatter("set", dn[name], dev, payload)
            shipped += payload.nbytes
        if usage is None:
            u_rows = np.ascontiguousarray(tmpl.used0[rows])
            du_rows = np.ascontiguousarray(tmpl.dev_used0[rows])
        else:
            u_rows, du_rows = usage
        self._used = self._sharded_scatter("set", self._used, dev, u_rows)
        self._dev_used = self._sharded_scatter("set", self._dev_used, dev,
                                               du_rows)
        shipped += int(u_rows.nbytes + du_rows.nbytes)
        shipped += self._refresh_tables(gid_rows=(dev, rows.astype(np.int32)))
        return shipped

    def grow_tiles(self, n: int = 1, shard: Optional[int] = None
                   ) -> List[int]:
        """Grow the global node axis by n whole tiles: extend the host
        template with dead rows, assign the tiles to the least-loaded
        shards (or `shard`) and ship only their rows.  Joining nodes then
        fill the slots through the normal delta path.  Raises when no
        shard has a free tile slot (repack)."""
        from ..solver.tensorize import extend_template_rows
        t0 = time.perf_counter()
        tile = self._layout.tile_np
        new = self._layout.grow(n)
        try:
            for t in new:
                self._layout.assign(t, shard if shard is not None
                                    else self._layout.least_loaded())
        except ValueError:
            raise ValueError(
                "no free tile slots left on any shard; increase "
                "slack_tiles/NOMAD_TPU_RESHARD_SLACK or repack") from None
        extend_template_rows(self.template, n * tile)
        NT = self.template.avail.shape[0]
        self._src_cache = self._layout.dev_src()
        self._compact = NT < 32768
        self._default_host_ok = np.zeros((self.gp, NT), bool)
        self._default_host_ok[:, :self.template.n_real] = True
        shipped = 0
        for t in new:
            shipped += self._ship_tile(t)
        self._bump_layout_epoch()
        self.reshard_counters["tiles_grown"] += n
        self.reshard_counters["last_reshard_bytes"] = shipped
        self.reshard_counters["reshard_bytes_total"] += shipped
        self.event_log.record(
            "grow", tiles=[int(t) for t in new], n_tiles=n, tile_np=tile,
            bytes=shipped, duration_s=round(time.perf_counter() - t0, 6),
            n_shards=self.n_shards)
        return new

    def move_tile(self, t: int, dst: int) -> int:
        """Rebalance one tile to shard `dst`, carrying its live usage;
        only the tile's rows (planes, usage, gid marks) travel.  Returns
        the bytes shipped."""
        t0 = time.perf_counter()
        lay = self._layout
        if lay.owner[t] < 0:
            raise ValueError(f"tile {t} is not owned")
        if lay.owner[t] == dst:
            return 0
        src_shard = int(lay.owner[t])
        tile = lay.tile_np
        old_rows = lay.dev_rows(t).astype(np.int32)
        u_rows = np.ascontiguousarray(self._fetch_rows(self._used)[old_rows])
        du_rows = np.ascontiguousarray(
            self._fetch_rows(self._dev_used)[old_rows])
        # the old location dies: dead gids, valid False, zero usage
        NT = self.template.avail.shape[0]
        dead = (NT + old_rows).astype(np.int32)
        dn = self._dev_node
        dn["valid"] = self._sharded_scatter("set", dn["valid"], old_rows,
                                            np.zeros(tile, bool))
        self._used = self._sharded_scatter("set", self._used, old_rows,
                                           np.zeros_like(u_rows))
        self._dev_used = self._sharded_scatter(
            "set", self._dev_used, old_rows, np.zeros_like(du_rows))
        self._refresh_tables(gid_rows=(old_rows, dead))
        lay.release(t)
        lay.assign(t, dst)
        self._src_cache = lay.dev_src()
        shipped = self._ship_tile(t, usage=(u_rows, du_rows))
        self._bump_layout_epoch()
        self.reshard_counters["tiles_moved"] += 1
        self.reshard_counters["last_reshard_bytes"] = shipped
        self.reshard_counters["reshard_bytes_total"] += shipped
        self.event_log.record(
            "move", tile=int(t), src_shard=src_shard, dst_shard=int(dst),
            bytes=shipped, duration_s=round(time.perf_counter() - t0, 6))
        return shipped

    def shrink_tiles(self, n: int = 1) -> List[int]:
        """Retire up to n EMPTY owned tiles (every template row invalid,
        no carried usage): their device rows die (dead gids, zero usage)
        and their slots free up.  A joining node later handed a retired
        tile's rows re-owns the tile on demand.  Returns the retired
        tile ids."""
        lay = self._layout
        tile = lay.tile_np
        v = self.template.valid
        u_dev = self._fetch_rows(self._used)
        du_dev = self._fetch_rows(self._dev_used)
        out: List[int] = []
        for t in range(lay.n_tiles):
            if len(out) >= n:
                break
            if lay.owner[t] < 0 or v[t * tile:(t + 1) * tile].any():
                continue
            dr = lay.dev_rows(t).astype(np.int32)
            if u_dev[dr].any() or du_dev[dr].any():
                # a tombstone keeps its usage row so a revived node
                # resumes exactly; retiring it would zero that
                continue
            NT = self.template.avail.shape[0]
            dead = (NT + dr).astype(np.int32)
            dn = self._dev_node
            dn["valid"] = self._sharded_scatter("set", dn["valid"], dr,
                                                np.zeros(tile, bool))
            self._used = self._sharded_scatter(
                "set", self._used, dr,
                np.zeros((tile,) + u_dev.shape[1:], u_dev.dtype))
            self._dev_used = self._sharded_scatter(
                "set", self._dev_used, dr,
                np.zeros((tile,) + du_dev.shape[1:], du_dev.dtype))
            self._refresh_tables(gid_rows=(dr, dead))
            lay.release(t)
            out.append(t)
        if out:
            self._src_cache = lay.dev_src()
            self._bump_layout_epoch()
            self.reshard_counters["tiles_shrunk"] += len(out)
            self.event_log.record("shrink", tiles=[int(t) for t in out],
                                  n_tiles=len(out))
        return out

    # ---------------- shard-loss recovery ----------------
    def _rebind(self, mesh: Mesh, layout, u, du) -> None:
        """Re-place the resident state under a new mesh and layout with
        the given GLOBAL usage (the fail / recover transitions)."""
        self._layout = layout
        self._set_mesh(mesh)
        self._fresh_layout = False
        try:
            self._put_node_side()
        finally:
            self._fresh_layout = True
        self._used = self._put_node("used", u)
        self._dev_used = self._put_node("dev_used", du)
        self._bump_layout_epoch()

    def fail_shard(self, shard: int) -> List[int]:
        """Declare one shard lost.  Its tiles become unowned (their nodes
        drop out of every solve) while the survivors rebind to a flat
        mesh over the remaining shards and keep solving with their
        carried usage.  Returns the lost tile ids."""
        if self.mesh_state != "healthy":
            raise ValueError(f"mesh is {self.mesh_state}; recover before "
                             "failing another shard")
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"no shard {shard}")
        if self.n_shards < 2:
            raise ValueError("cannot lose the only shard")
        u, du = self.usage()
        lost = self._layout.tiles_of(shard)
        tile = self._layout.tile_np
        for t in lost:
            u[t * tile:(t + 1) * tile] = 0      # the shard's state is gone
            du[t * tile:(t + 1) * tile] = 0
        devices = self._mesh.flat_devices()
        self._failed_shard = shard
        survivors = [d for i, d in enumerate(devices) if i != shard]
        remap = {}
        j = 0
        for i in range(self.n_shards):
            if i != shard:
                remap[i] = j
                j += 1
        self._recover_remap = {v: k for k, v in remap.items()}
        new_layout = self._layout.remap_shards(remap, len(survivors))
        self._lost_tiles = lost
        self._rebind(Mesh(_grid(survivors, (len(survivors),)),
                          (MESH_NODE_AXIS,)), new_layout, u, du)
        self.mesh_state = "degraded"
        self.event_log.record("fail", shard=int(shard),
                              tiles=[int(t) for t in lost],
                              surviving_shards=len(survivors))
        return lost

    def recover(self) -> int:
        """Rebuild the lost shard's planes from the host template and
        rejoin it: lost tiles return to the restored shard with usage as
        of the last plan-fed state; surviving tiles keep their carried
        usage.  Returns the recovery bytes (the lost tiles' rows)."""
        if self.mesh_state != "degraded":
            raise ValueError("mesh is not degraded")
        t0 = time.perf_counter()
        u, du = self.usage()
        tmpl = self.template
        tile = self._layout.tile_np
        recovered_bytes = 0
        for t in self._lost_tiles:
            rows = slice(t * tile, (t + 1) * tile)
            u[rows] = tmpl.used0[rows]
            du[rows] = tmpl.dev_used0[rows]
            recovered_bytes += int(
                tmpl.avail[rows].nbytes + tmpl.reserved[rows].nbytes
                + tmpl.valid[rows].nbytes + tmpl.node_dc[rows].nbytes
                + tmpl.attr_rank[rows].nbytes + tmpl.dev_cap[rows].nbytes
                + tmpl.used0[rows].nbytes + tmpl.dev_used0[rows].nbytes)
        mesh = self._orig_mesh
        layout = self._layout.remap_shards(self._recover_remap, mesh.size)
        for t in self._lost_tiles:
            layout.assign(t, self._failed_shard)
        self._lost_tiles = []
        self._rebind(mesh, layout, u, du)
        self.mesh_state = "healthy"
        self.reshard_counters["recoveries"] += 1
        self.reshard_counters["last_recovery_bytes"] = recovered_bytes
        self.reshard_counters["last_recovery_s"] = time.perf_counter() - t0
        self.event_log.record(
            "recover", shard=int(self._failed_shard), bytes=recovered_bytes,
            duration_s=round(self.reshard_counters["last_recovery_s"], 6),
            n_shards=self.n_shards)
        return recovered_bytes


class ElasticMeshSupervisor:
    """The recovery trigger: maps membership and node events onto the
    elastic solver's fail / recover state machine.

      * gossip plane: ``on_fail`` / ``on_join`` take a member (an object
        with `.id`, or the id); a registered mesh host going dead fails
        its shard, its return triggers the rejoin;
      * scheduler plane: ``note_node_event`` from the worker's
        node-update eval path, for fleets whose mesh hosts are workload
        nodes.

    Callbacks come on other threads while the solver is driven
    elsewhere, so transitions serialize under one lock; solves are not
    held by it (fail / recover rebind between solves)."""

    def __init__(self, solver: "ElasticShardedResidentSolver"):
        self.solver = solver
        self._hosts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.events: List[Tuple[str, str]] = []

    def register_host(self, member_id: str, shard: int) -> None:
        """Declare that `member_id` (a gossip member or node id) hosts
        mesh shard `shard`."""
        with self._lock:
            self._hosts[member_id] = int(shard)

    @staticmethod
    def _member_id(member) -> str:
        return getattr(member, "id", member)

    def on_fail(self, member) -> None:
        mid = self._member_id(member)
        with self._lock:
            shard = self._hosts.get(mid)
            if shard is None or self.solver.mesh_state != "healthy":
                return
            self.solver.fail_shard(shard)
            self.events.append(("fail", mid))
            self.solver.event_log.record("supervisor.fail", member=mid,
                                         shard=int(shard))

    def on_join(self, member) -> None:
        mid = self._member_id(member)
        with self._lock:
            if mid not in self._hosts \
                    or self.solver.mesh_state != "degraded":
                return
            self.solver.recover()
            self.events.append(("recover", mid))
            self.solver.event_log.record("supervisor.recover", member=mid)

    def note_node_event(self, node_id: str, status: str) -> None:
        """Scheduler-plane trigger: a node-update eval saw `node_id` at
        `status` (structs NODE_STATUS_*)."""
        from ..structs.consts import NODE_STATUS_DOWN
        if status == NODE_STATUS_DOWN:
            self.on_fail(node_id)
        else:
            self.on_join(node_id)
