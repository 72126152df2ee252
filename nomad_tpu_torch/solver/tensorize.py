"""Pack a (nodes, asks) scheduling problem into dense tensors.

The counterpart of `nomad_tpu.solver.tensorize`: node fingerprints and
task-group asks become `nodes[N,R]` resource arrays, rank-interned attribute columns, and per-ask constraint programs.
Non-vectorizable checks (regex, version, semver, set_contains, host
volumes, driver health) are evaluated host-side — memoized by computed
class exactly like the reference's FeasibilityWrapper
(scheduler/feasible.go:915) — and folded into a per-ask boolean `host_ok`
mask.

`Tensorizer.pack` returns numpy arrays, plane for plane what the JAX
package's packer returns; `packed_from_numpy` moves a batch (from either
packer) onto a torch device for the solve.

The incremental side serves the solver's resident cluster world
(`solve._ResidentWorld`): `delta_pack` turns a `ClusterDelta` (nodes
joined, changed or removed; allocs placed or stopped) into a `NodeDelta`
of scatter rows, `apply_node_delta_host` applies it to the numpy template
in place, and `repack_asks` rebuilds only the ask side of a batch against
that template.

`pack(..., evict_e=E)` with E > 0 also packs the in-kernel preemption
planes: each node's top-E evictable allocs in `_evict_sort_key` order
(`ev_prio`, `ev_res`, `ev_ids`, and the full candidate lists `ev_lists`
on a template); `apply_node_delta_host` keeps them current through
`apply_evict_ops`.

`plane_crc` / `template_checksum` fingerprint the node-side planes, so
the streaming `ResidentSolver`'s card-resident planes can be held to
the host template they mirror.

Resource dims (R=4): cpu MHz, memory MB, disk MB, network mbits.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..scheduler import feasible as hostfeas
from ..structs import (CONSTRAINT_ATTR_IS_NOT_SET, CONSTRAINT_ATTR_IS_SET,
                       CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY,
                       Constraint, Node, resolve_node_target)
from .interning import Interner, RankColumn

# Device-side constraint op codes
OP_NONE = 0
OP_EQ = 1
OP_NE = 2
OP_LT = 3
OP_LE = 4
OP_GT = 5
OP_GE = 6
OP_IS_SET = 7
OP_NOT_SET = 8

_VECTOR_OPS = {
    "=": OP_EQ, "==": OP_EQ, "is": OP_EQ,
    "!=": OP_NE, "not": OP_NE,
    "<": OP_LT, "<=": OP_LE, ">": OP_GT, ">=": OP_GE,
    CONSTRAINT_ATTR_IS_SET: OP_IS_SET,
    CONSTRAINT_ATTR_IS_NOT_SET: OP_NOT_SET,
}

R_CPU, R_MEM, R_DISK, R_NET = 0, 1, 2, 3
NUM_R = 4

#: evictable-alloc slots per node in the preemption planes by default
#: (the reference's default width); 0 packs no planes
EVICT_E = 8


def evict_width() -> int:
    """Top-E evictable-alloc slots per node for the in-kernel
    preemption planes: `EVICT_E`, or NOMAD_TPU_EVICT_E, read at each
    resident-world build; 0 disables packing the planes entirely
    (solves fall back to the host-side preemption walk)."""
    import os
    raw = os.environ.get("NOMAD_TPU_EVICT_E", "").strip()
    if not raw:
        return EVICT_E
    try:
        return max(0, int(raw))
    except ValueError:
        raise ValueError(
            f"NOMAD_TPU_EVICT_E={raw!r} invalid: use a non-negative "
            "integer slot width (0 disables)") from None


def _evict_sort_key(prio: int, create_index: int, alloc_id: str):
    """Canonical evictable-candidate order: lowest priority first, then
    create_index, then id (scheduler/preemption.preemptible_allocs'
    (priority, create_index) order; the id makes ties deterministic)."""
    return (prio, create_index, alloc_id)


def _evict_candidates(allocs) -> list:
    """Sorted evictable-candidate list for one node:
    [(prio, create_index, id, usage_vec), ...].  Job-less allocs have
    no knowable priority and are never victims."""
    out = []
    for a in allocs:
        if a.terminal_status() or a.job is None:
            continue
        out.append((int(a.job.priority), int(a.create_index), a.id,
                    alloc_usage_vector(a)))
    out.sort(key=lambda t: _evict_sort_key(t[0], t[1], t[2]))
    return out


def _evict_row(cands, E: int):
    """(prio [E] i16, res [E, R] f32, ids [E]) for one node's top-E
    evictable candidates (-1 / zeros / '' pad the empty slots)."""
    prio = np.full(E, -1, np.int16)
    res = np.zeros((E, NUM_R), np.float32)
    ids = [""] * E
    for e, (p, _ci, aid, vec) in enumerate(cands[:E]):
        prio[e] = min(max(int(p), -1), 32000)
        res[e] = vec
        ids[e] = aid
    return prio, res, ids


@dataclass
class PlacementAsk:
    """One task group needing `count` placements."""
    job: Job
    tg: TaskGroup
    count: int
    penalty_nodes: FrozenSet[str] = frozenset()     # previous-node penalties
    existing_by_node: Dict[str, int] = field(default_factory=dict)
    # ^ count of live allocs of this (job, tg) per node (anti-affinity +
    #   spread seed); computed by the scheduler from proposed state.
    distinct_hosts_blocked: FrozenSet[str] = frozenset()
    # ^ node ids excluded by distinct_hosts / distinct_property semantics
    spread_seed: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # ^ attr target -> value -> existing count (propertyset seed)
    property_limits: Dict[str, Tuple[int, Dict[str, int]]] = field(
        default_factory=dict)
    # ^ distinct_property: attr target -> (limit, existing count by value);
    #   enforced host-side across in-batch placements (solve.py)


def group_resource_vector(tg: TaskGroup) -> np.ndarray:
    """Summed resource ask for one instance of the group."""
    v = np.zeros(NUM_R, dtype=np.float32)
    for t in tg.tasks:
        v[R_CPU] += t.resources.cpu
        v[R_MEM] += t.resources.memory_mb
        for n in t.resources.networks:
            v[R_NET] += n.mbits
    for n in tg.networks:
        v[R_NET] += n.mbits
    v[R_DISK] = tg.ephemeral_disk.size_mb
    return v


def node_capacity_vectors(node: Node) -> Tuple[np.ndarray, np.ndarray]:
    """(capacity, reserved) R-vectors for a node."""
    cap = np.zeros(NUM_R, dtype=np.float32)
    res = np.zeros(NUM_R, dtype=np.float32)
    nr = node.node_resources
    cap[R_CPU], cap[R_MEM], cap[R_DISK] = nr.cpu, nr.memory_mb, nr.disk_mb
    cap[R_NET] = sum(n.mbits for n in nr.networks)
    rr = node.reserved_resources
    res[R_CPU], res[R_MEM], res[R_DISK] = rr.cpu, rr.memory_mb, rr.disk_mb
    return cap, res


def alloc_usage_vector(alloc) -> np.ndarray:
    v = np.zeros(NUM_R, dtype=np.float32)
    c = alloc.comparable_resources()
    v[R_CPU], v[R_MEM], v[R_DISK] = c.cpu, c.memory_mb, c.disk_mb
    v[R_NET] = sum(n.mbits for n in c.networks)
    return v


def alloc_device_usage(dev_pattern_ids, D: int, alloc
                       ) -> Optional[np.ndarray]:
    """[D] device-instance usage row for one alloc against a template's
    interned device patterns, or None when it uses none of them."""
    ar = getattr(alloc, "allocated_resources", None)
    if not dev_pattern_ids or ar is None:
        return None
    row = None
    from ..structs.resources import device_pattern_matches
    for tr in ar.tasks.values():
        for ad in tr.devices:
            for key, dix in dev_pattern_ids.items():
                if device_pattern_matches(key,
                                          (ad.vendor, ad.type, ad.name)):
                    if row is None:
                        row = np.zeros(D, np.float32)
                    row[dix] += len(ad.device_ids)
    return row


def _pad_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_nodes(n: int) -> int:
    """Node-axis padding.  Small clusters pad to a power of two (few
    distinct compiled shapes across tests/dryruns); large clusters pad
    to a multiple of 1024 — the TPU only needs lane alignment, and
    pow2-padding 10K nodes to 16K would do 1.6x the [G, N] wave work
    for nothing.

    Both regimes are TILE-ALIGNED for the pallas fused wave kernel
    (pallas_kernel.pick_tile): a power of two <= 4096 is divisible by
    every smaller power-of-two tile, and 1024-multiples split into
    lane-aligned 1024/2048 tiles — so the fused path never needs a
    ragged last tile."""
    if n <= 4096:
        return _pad_pow2(max(n, 1))
    return -(-n // 1024) * 1024


def _index_dtype(rank_columns, n_targets: int):
    """int16 when every interned rank (and column index) fits —
    halving the [Np, A] attribute matrix and the constraint/affinity
    program rows that the kernel streams per solve; int32 when a value
    universe is pathologically wide.  Resource tensors deliberately
    STAY float32: cpu-MHz/memory-MB values are integral and < 2^24 so
    f32 compares exactly, while fp16 would round them (a 11000-MHz
    node is not fp16-representable) and int tensors would re-convert
    on every fused multiply-add."""
    if n_targets < 32000 and all(rc.n_values < 32000
                                 for rc in rank_columns):
        return np.int16
    return np.int32


@dataclass
class PackedBatch:
    """Everything the kernel needs: numpy arrays from `Tensorizer.pack`,
    torch tensors from `packed_from_numpy`."""
    # node axis
    node_ids: List[str]
    n_real: int
    avail: np.ndarray          # [Np, R] cap - reserved
    reserved: np.ndarray       # [Np, R]
    used0: np.ndarray          # [Np, R] live alloc usage (no reserved)
    valid: np.ndarray          # [Np] bool
    node_class: np.ndarray     # [Np] i32 interned computed class
    node_dc: np.ndarray        # [Np] i32 interned datacenter
    attr_rank: np.ndarray      # [Np, A] i32 rank-interned values (-1 missing)
    # ask axis
    n_asks: int
    ask_res: np.ndarray        # [Gp, R]
    ask_desired: np.ndarray    # [Gp] f32 tg.count for anti-affinity denom
    distinct: np.ndarray       # [Gp] i32 distinct_hosts group id (-1 none):
    #   in-batch placements sharing a group id must land on distinct nodes;
    #   a job-level constraint puts all the job's asks in one group
    dc_ok: np.ndarray          # [Gp, NDC] bool over interned dc ids
    host_ok: np.ndarray        # [Gp, Np] bool host-evaluated feasibility
    coll0: np.ndarray          # [Gp, Np] f32 same-(job,tg) live counts
    penalty: np.ndarray        # [Gp, Np] bool reschedule penalty nodes
    # constraint programs
    c_op: np.ndarray           # [Gp, C] i32
    c_col: np.ndarray          # [Gp, C] i32 attr column
    c_rank: np.ndarray         # [Gp, C] i32 operand rank
    # affinities
    a_op: np.ndarray           # [Gp, CA] i32
    a_col: np.ndarray          # [Gp, CA]
    a_rank: np.ndarray         # [Gp, CA]
    a_weight: np.ndarray       # [Gp, CA] f32 (0 = empty slot)
    a_host: np.ndarray         # [Gp, Np] f32 host-evaluated affinity score
    # spreads
    sp_col: np.ndarray         # [Gp, S] i32 attr column (-1 empty)
    sp_weight: np.ndarray      # [Gp, S] f32 weight/sumWeights
    sp_targeted: np.ndarray    # [Gp, S] bool
    sp_desired: np.ndarray     # [Gp, S, V] f32 desired count per value rank
    sp_implicit: np.ndarray    # [Gp, S] f32 implicit-target desired (-1 none)
    sp_used0: np.ndarray       # [Gp, S, V] f32
    # devices
    dev_cap: np.ndarray        # [Np, D] f32 healthy instance counts per pattern
    dev_used0: np.ndarray      # [Np, D]
    dev_ask: np.ndarray        # [Gp, D]
    # placement schedule
    p_ask: np.ndarray          # [K] i32 ask index per placement step
    n_place: int
    # unpack metadata
    rank_columns: List[RankColumn] = field(default_factory=list)
    attr_targets: List[str] = field(default_factory=list)
    constraint_labels: List[List[str]] = field(default_factory=list)
    class_ids: Dict[str, int] = field(default_factory=dict)
    dc_ids: Dict[str, int] = field(default_factory=dict)
    dev_pattern_ids: Dict[Tuple[str, str, str], int] = field(
        default_factory=dict)
    # in-kernel preemption planes, present when packed with evict_e > 0
    ask_prio: Optional[np.ndarray] = None   # [Gp] i32 job priority
    ev_prio: Optional[np.ndarray] = None    # [Np, E] i16 victim priority
    #   (-1 = empty slot; slots in _evict_sort_key order)
    ev_res: Optional[np.ndarray] = None     # [Np, E, R] f32 victim usage
    ev_ids: Optional[List[List[str]]] = None  # [Np][E] alloc ids
    ev_lists: Optional[List[list]] = None   # per-node candidate lists
    #   (template only; _evict_candidates order, feeds delta recompute)


#: array fields of PackedBatch, in declaration order (the planes
#: `packed_from_numpy` moves onto a device)
ARRAY_FIELDS = (
    "avail", "reserved", "used0", "valid", "node_class", "node_dc",
    "attr_rank", "ask_res", "ask_desired", "distinct", "dc_ok", "host_ok",
    "coll0", "penalty", "c_op", "c_col", "c_rank", "a_op", "a_col",
    "a_rank", "a_weight", "a_host", "sp_col", "sp_weight", "sp_targeted",
    "sp_desired", "sp_implicit", "sp_used0", "dev_cap", "dev_used0",
    "dev_ask", "p_ask")
#: the preemption planes, moved like ARRAY_FIELDS when present
EVICT_FIELDS = ("ask_prio", "ev_prio", "ev_res")


def packed_from_numpy(arrays: dict, device) -> PackedBatch:
    """A PackedBatch whose planes are torch tensors on `device`.

    `arrays` maps field names to numpy arrays (the ARRAY_FIELDS, exactly
    as either package's packer produces them, and the EVICT_FIELDS where
    not None) plus the scalar fields `n_real`, `n_asks` and `n_place`;
    any other field present (ids, labels, interning tables) is carried
    over as is.  Dtypes are kept: bool planes stay bool, int16 index
    planes stay int16."""
    import torch
    kw = {}
    for f in fields(PackedBatch):
        if f.name in ARRAY_FIELDS or (f.name in EVICT_FIELDS
                                      and arrays.get(f.name) is not None):
            kw[f.name] = torch.as_tensor(np.ascontiguousarray(
                arrays[f.name])).to(device)
        elif f.name in arrays:
            kw[f.name] = arrays[f.name]
        elif f.name == "node_ids":
            kw[f.name] = [""] * int(arrays["n_real"])
    return PackedBatch(**kw)


@dataclass
class ClusterDelta:
    """Changeset between two cluster states (the plan-apply feedback
    unit): nodes joined/updated, nodes drained/removed, allocs placed,
    allocs stopped.  `Tensorizer.delta_pack` turns one of these into
    small scatter arrays instead of a full [N, R] re-tensorization."""
    upsert_nodes: List = field(default_factory=list)   # joined or changed
    remove_node_ids: List[str] = field(default_factory=list)
    place: List[Tuple[str, object]] = field(default_factory=list)
    # ^ (node_id, alloc) usage adds
    stop: List[Tuple[str, object]] = field(default_factory=list)
    # ^ (node_id, alloc) usage subtracts

    def empty(self) -> bool:
        return not (self.upsert_nodes or self.remove_node_ids
                    or self.place or self.stop)


@dataclass
class NodeDelta:
    """Scatter-update arrays produced by Tensorizer.delta_pack: the
    node-side rows a ClusterDelta touches, ready for an in-place numpy
    apply (apply_node_delta_host)."""
    idx: np.ndarray          # [M] i32 touched node slots (upsert+remove)
    avail: np.ndarray        # [M, R]
    reserved: np.ndarray     # [M, R]
    valid: np.ndarray        # [M] bool
    node_class: np.ndarray   # [M] i32
    node_dc: np.ndarray      # [M] i32
    attr_rank: np.ndarray    # [M, A] template dtype
    dev_cap: np.ndarray      # [M, D]
    u_idx: np.ndarray        # [Mu] i32 usage-touched slots (deduped)
    u_res: np.ndarray        # [Mu, R] signed usage adds
    u_dev: np.ndarray        # [Mu, D] signed device-usage adds
    new_nodes: List = field(default_factory=list)  # joins, slot order
    n_real_new: int = 0
    # raw alloc ops (slot, alloc) for templates that carry eviction
    # planes: apply_node_delta_host replays them into ev_lists
    alloc_place: List[Tuple[int, object]] = field(default_factory=list)
    alloc_stop: List[Tuple[int, object]] = field(default_factory=list)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in (
            self.idx, self.avail, self.reserved, self.valid,
            self.node_class, self.node_dc, self.attr_rank, self.dev_cap,
            self.u_idx, self.u_res, self.u_dev))

    def touches_nodes(self) -> bool:
        return self.idx.size > 0

    def ratio(self, n_real: int) -> float:
        """Fraction of real node slots this delta touches — the
        repack-fallback threshold input."""
        touched = len(set(self.idx.tolist()) | set(self.u_idx.tolist()))
        return touched / max(n_real, 1)


def apply_node_delta_host(template: PackedBatch, nd: NodeDelta,
                          nodes: List[Node],
                          node_index: Dict[str, int]) -> None:
    """Apply a NodeDelta to the numpy template in place, growing
    nodes/node_ids/n_real for joins.  Removed nodes stay as valid=False
    tombstones so every surviving slot keeps its index (and therefore
    its tie-break order and its carried usage row)."""
    for n in nd.new_nodes:
        node_index[n.id] = len(nodes)
        nodes.append(n)
        template.node_ids.append(n.id)
    template.n_real = nd.n_real_new
    if nd.idx.size:
        template.avail[nd.idx] = nd.avail
        template.reserved[nd.idx] = nd.reserved
        template.valid[nd.idx] = nd.valid
        template.node_class[nd.idx] = nd.node_class
        template.node_dc[nd.idx] = nd.node_dc
        template.attr_rank[nd.idx] = nd.attr_rank
        template.dev_cap[nd.idx] = nd.dev_cap
    if nd.u_idx.size:
        # u_idx rows are pre-aggregated per slot (no duplicate indices)
        template.used0[nd.u_idx] += nd.u_res
        template.dev_used0[nd.u_idx] += nd.u_dev
    if template.ev_lists is not None:
        _apply_evict_delta(template, nd)


def apply_evict_ops(template: PackedBatch, stops, places) -> None:
    """Advance the template's eviction planes by slot-level alloc ops:
    replay (slot, alloc) stops then places into ev_lists (stops first:
    an updated alloc arrives as stop + place of the same id) and
    recompute the touched top-E rows."""
    import bisect
    lists = template.ev_lists
    while len(lists) < len(template.node_ids):
        lists.append([])            # joined nodes start empty
    touched = set()
    for s, alloc in stops:
        aid = alloc.id
        lists[s] = [t for t in lists[s] if t[2] != aid]
        touched.add(s)
    for s, alloc in places:
        if alloc.terminal_status() or alloc.job is None:
            continue
        ent = (int(alloc.job.priority), int(alloc.create_index),
               alloc.id, alloc_usage_vector(alloc))
        keys = [_evict_sort_key(t[0], t[1], t[2]) for t in lists[s]]
        pos = bisect.bisect_left(keys, _evict_sort_key(*ent[:3]))
        lists[s].insert(pos, ent)
        touched.add(s)
    # invalid (drained or removed) slots keep their lists: the eviction
    # pass gates on `feas`, which carries `valid`
    E = template.ev_prio.shape[1]
    for s in touched:
        if s >= template.ev_prio.shape[0]:
            continue
        prio, res, ids = _evict_row(lists[s], E)
        template.ev_prio[s] = prio
        template.ev_res[s] = res
        template.ev_ids[s] = ids


def _apply_evict_delta(template: PackedBatch, nd: NodeDelta) -> None:
    apply_evict_ops(template, nd.alloc_stop, nd.alloc_place)


def plane_crc(avail, reserved, valid, node_dc, attr_rank, dev_cap,
              ev_prio=None, ev_res=None, meta: bytes = b"") -> int:
    """CRC32 over the node-side planes in a fixed order (numpy arrays or
    tensors, fetched to the host).  `valid` is canonicalized to uint8 so
    host bools and fetched device bools hash identically."""
    import zlib

    def host(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.ascontiguousarray(np.asarray(a))
    crc = zlib.crc32(meta)
    arrs = [host(avail), host(reserved), host(valid).astype(np.uint8),
            host(node_dc), host(attr_rank), host(dev_cap)]
    if ev_prio is not None:
        arrs += [host(ev_prio), host(ev_res)]
    for a in arrs:
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def template_checksum(template: PackedBatch) -> int:
    """Fingerprint of a template's node-side planes (the host source of
    truth); `ResidentSolver.plane_checksum()` must equal it."""
    t = template
    meta = f"{t.n_real}:{','.join(t.node_ids)}".encode()
    return plane_crc(t.avail, t.reserved, t.valid, t.node_dc,
                     t.attr_rank, t.dev_cap, ev_prio=t.ev_prio,
                     ev_res=t.ev_res, meta=meta)


# ------------------------------------------------- elastic tile layout
# The elastic mesh owns the node axis in TILES of `tile_np` slots routed
# by an owner remap table instead of contiguous blocks.  A reshard (grow,
# shrink, rebalance, recover) edits the table and moves ONE tile's rows,
# never the world.

def pick_tile_np(np_pad: int, n_shards: int, tile_np: int = 0) -> int:
    """Shard-tile width: `tile_np` when given (a positive power of two
    dividing the padded node axis), else NOMAD_TPU_SHARD_TILE when set
    (the same rule), else ~4 tiles a shard, a power of two so that it
    divides the padded node axis (pow2 <= 4096 or a multiple of 1024,
    see _pad_nodes), floor 8, cap 1024."""
    import os
    raw = os.environ.get("NOMAD_TPU_SHARD_TILE", "").strip()
    if not tile_np and raw:
        try:
            t = int(raw)
        except ValueError:
            raise ValueError(
                f"NOMAD_TPU_SHARD_TILE={raw!r} invalid: use a positive "
                "power-of-two slot width") from None
        if t <= 0 or t & (t - 1) or np_pad % t:
            raise ValueError(
                f"NOMAD_TPU_SHARD_TILE={t} invalid: must be a positive "
                f"power of two dividing the padded node axis {np_pad}")
        return t
    if tile_np:
        t = int(tile_np)
        if t <= 0 or t & (t - 1) or np_pad % t:
            raise ValueError(
                f"tile_np={t} invalid: must be a positive power of two "
                f"dividing the padded node axis {np_pad}")
        return t
    target = max(8, np_pad // max(4 * n_shards, 1))
    t = 1 << (target.bit_length() - 1)
    return max(8, min(t, 1024, np_pad))


class TileLayout:
    """Owner remap for the elastic node axis: tile t of `tile_np` slots
    lives on shard owner[t] at local tile position slot[t] (owner -1:
    unowned, retired or lost with its shard).  Every shard carries
    `cap_tiles` tile slots (a power of two); unfilled slots are dead
    (valid False, dead global ids), the slack that lets a grow ship one
    tile instead of repadding the world."""

    def __init__(self, n_tiles: int, n_shards: int, tile_np: int,
                 cap_tiles: Optional[int] = None, slack_tiles: int = 1):
        self.tile_np = int(tile_np)
        self.n_shards = int(n_shards)
        self.n_tiles = int(n_tiles)
        need = -(-n_tiles // max(n_shards, 1)) + max(slack_tiles, 0)
        if cap_tiles is None:
            cap_tiles = _pad_pow2(max(need, 1), floor=1)
        if cap_tiles * n_shards < n_tiles:
            raise ValueError(
                f"cap_tiles={cap_tiles} x {n_shards} shards cannot hold "
                f"{n_tiles} tiles")
        self.cap_tiles = int(cap_tiles)
        # contiguous initial placement: tile t -> shard t // per, the
        # block layout of the static mesh
        self.owner = np.full(n_tiles, -1, np.int32)
        self.slot = np.zeros(n_tiles, np.int32)
        fill = np.zeros(n_shards, np.int32)
        for t in range(n_tiles):
            s = min(t * n_shards // max(n_tiles, 1), n_shards - 1)
            if fill[s] >= cap_tiles:
                s = int(np.argmin(fill))
            self.owner[t] = s
            self.slot[t] = fill[s]
            fill[s] += 1

    @property
    def npl(self) -> int:
        """Per-shard local node-axis width (slots)."""
        return self.cap_tiles * self.tile_np

    @property
    def n_slots(self) -> int:
        return self.n_shards * self.npl

    def tiles_of(self, shard: int) -> List[int]:
        return [t for t in range(self.n_tiles) if self.owner[t] == shard]

    def free_slots(self, shard: int) -> int:
        return self.cap_tiles - len(self.tiles_of(shard))

    def least_loaded(self) -> int:
        loads = [len(self.tiles_of(s)) for s in range(self.n_shards)]
        return int(np.argmin(loads))

    def assign(self, t: int, shard: int) -> int:
        """Place tile t on `shard` at its lowest free tile slot."""
        if self.owner[t] >= 0:
            raise ValueError(f"tile {t} already owned by {self.owner[t]}")
        taken = {int(self.slot[u]) for u in self.tiles_of(shard)}
        for sl in range(self.cap_tiles):
            if sl not in taken:
                self.owner[t] = shard
                self.slot[t] = sl
                return sl
        raise ValueError(f"shard {shard} has no free tile slot")

    def release(self, t: int) -> None:
        self.owner[t] = -1
        self.slot[t] = 0

    def grow(self, n: int = 1) -> List[int]:
        """Extend the global axis by n unowned tiles (assign next)."""
        new = list(range(self.n_tiles, self.n_tiles + n))
        self.n_tiles += n
        self.owner = np.concatenate([self.owner, np.full(n, -1, np.int32)])
        self.slot = np.concatenate([self.slot, np.zeros(n, np.int32)])
        return new

    def dev_rows(self, t: int) -> np.ndarray:
        """Device-layout row range of tile t (in its owner's block)."""
        lo = int(self.owner[t]) * self.npl + int(self.slot[t]) * self.tile_np
        return np.arange(lo, lo + self.tile_np)

    def dev_src(self) -> np.ndarray:
        """[n_slots] global row per device row (-1 = dead slot)."""
        src = np.full(self.n_slots, -1, np.int64)
        for t in range(self.n_tiles):
            if self.owner[t] >= 0:
                src[self.dev_rows(t)] = np.arange(t * self.tile_np,
                                                  (t + 1) * self.tile_np)
        return src

    def node_gid(self, nt_pad: int) -> np.ndarray:
        """[n_slots] global id per device row; dead rows get unique ids
        past the global axis (they order deterministically and can never
        win or be owned)."""
        src = self.dev_src()
        gid = src.astype(np.int32)
        dead = src < 0
        gid[dead] = nt_pad + np.nonzero(dead)[0].astype(np.int32)
        return gid

    def tables(self):
        """(owner_map, slot_map) [T+1] i32 with the -1 sentinel row the
        solve clips out-of-range tile indices onto."""
        om = np.full(self.n_tiles + 1, -1, np.int32)
        om[:self.n_tiles] = self.owner
        sm = np.zeros(self.n_tiles + 1, np.int32)
        sm[:self.n_tiles] = self.slot
        return om, sm

    def g2d(self, gids, unowned: str = "raise") -> np.ndarray:
        """Global node rows -> device-layout rows.  unowned="raise"
        rejects rows in unowned tiles; "drop" maps them to n_slots, out
        of every shard's range, so the owner-masked scatters drop them
        (a lost tile's rows stay on the host until recover)."""
        g = np.asarray(gids, np.int64)
        t = g // self.tile_np
        bad = self.owner[t] < 0
        if bad.any() and unowned != "drop":
            raise ValueError("global row maps to an unowned tile")
        d = (self.owner[t].astype(np.int64) * self.npl
             + self.slot[t].astype(np.int64) * self.tile_np
             + g % self.tile_np)
        return np.where(bad, np.int64(self.n_slots), d)

    def remap_shards(self, new_ids: Dict[int, int],
                     n_shards: int) -> "TileLayout":
        """A copy on a different shard count: surviving shards keep their
        tiles at their slots under their new ids; tiles of shards absent
        from `new_ids` become unowned (the shard-loss transition)."""
        out = TileLayout.__new__(TileLayout)
        out.tile_np = self.tile_np
        out.n_shards = int(n_shards)
        out.n_tiles = self.n_tiles
        out.cap_tiles = self.cap_tiles
        out.owner = np.full(self.n_tiles, -1, np.int32)
        out.slot = self.slot.copy()
        for t in range(self.n_tiles):
            o = int(self.owner[t])
            if o >= 0 and o in new_ids:
                out.owner[t] = new_ids[o]
        return out


#: node-axis template arrays a tile-granular grow extends, with their
#: dead-row fill values (the tensorizer's padding)
_NODE_AXIS_FILLS = (
    ("avail", 0), ("reserved", 0), ("used0", 0), ("valid", False),
    ("node_class", 0), ("node_dc", 0), ("attr_rank", -1),
    ("dev_cap", 0), ("dev_used0", 0), ("ev_prio", -1), ("ev_res", 0),
)


def extend_template_rows(template: PackedBatch, n_rows: int) -> None:
    """Grow the template's global node axis by n_rows dead slots: every
    node-axis plane is extended in place with its pad value, with no
    repack and no re-interning; joining nodes then fill the new slots
    through the normal delta path."""
    for name, fill in _NODE_AXIS_FILLS:
        arr = getattr(template, name, None)
        if arr is None:
            continue
        pad = np.full((n_rows,) + arr.shape[1:], fill, arr.dtype)
        setattr(template, name, np.concatenate([arr, pad]))
    if template.ev_ids is not None:
        E = template.ev_prio.shape[1]
        template.ev_ids.extend([[""] * E for _ in range(n_rows)])


class Tensorizer:
    """Builds PackedBatch from nodes + asks. Stateless across calls except
    for host-op memoization keyed by computed class."""

    def __init__(self) -> None:
        self._class_memo: Dict[Tuple[str, tuple], bool] = {}

    def pack(self, nodes: Sequence[Node], asks: Sequence[PlacementAsk],
             allocs_by_node: Optional[Dict[str, list]] = None,
             evict_e: int = 0) -> PackedBatch:
        N = len(nodes)
        Np = _pad_nodes(N)
        G = len(asks)
        Gp = _pad_pow2(max(G, 1), floor=1)

        # ---- node resources ----
        avail = np.zeros((Np, NUM_R), np.float32)
        reserved = np.zeros((Np, NUM_R), np.float32)
        used0 = np.zeros((Np, NUM_R), np.float32)
        valid = np.zeros(Np, bool)
        node_index = {}
        for i, n in enumerate(nodes):
            cap, res = node_capacity_vectors(n)
            avail[i] = cap - res
            reserved[i] = res
            valid[i] = True
            node_index[n.id] = i
        if allocs_by_node:
            for nid, allocs in allocs_by_node.items():
                i = node_index.get(nid)
                if i is None:
                    continue
                for a in allocs:
                    if not a.terminal_status():
                        used0[i] += alloc_usage_vector(a)

        # ---- interned identity columns ----
        dc_interner = Interner()
        class_interner = Interner()
        node_dc = np.zeros(Np, np.int32)
        node_class = np.zeros(Np, np.int32)
        for i, n in enumerate(nodes):
            node_dc[i] = dc_interner.intern(n.datacenter)
            node_class[i] = class_interner.intern(n.computed_class
                                                  or n.compute_class())
        NDC = _pad_pow2(max(len(dc_interner), 1), floor=1)

        # ---- collect referenced attr targets / constraint programs ----
        attr_targets: List[str] = []
        attr_target_ix: Dict[str, int] = {}

        def target_col(t: str) -> int:
            ix = attr_target_ix.get(t)
            if ix is None:
                ix = len(attr_targets)
                attr_target_ix[t] = ix
                attr_targets.append(t)
            return ix

        per_ask_vec_constraints: List[List[Tuple[int, int, str]]] = []
        per_ask_host_constraints: List[List[Constraint]] = []
        per_ask_affinities: List[List[Tuple[int, int, str, float]]] = []
        per_ask_host_affinities: List[List] = []
        constraint_labels: List[List[str]] = []

        for ask in asks:
            vec, host, labels = [], [], []
            for c in hostfeas.merged_constraints(ask.job, ask.tg):
                if c.operand in (CONSTRAINT_DISTINCT_HOSTS,
                                 CONSTRAINT_DISTINCT_PROPERTY):
                    continue  # handled via distinct_hosts_blocked
                op = _VECTOR_OPS.get(c.operand)
                if (op is not None and c.ltarget.startswith("${")
                        and not c.rtarget.startswith("${")):
                    vec.append((op, target_col(c.ltarget), c.rtarget))
                    labels.append(str(c))
                else:
                    host.append(c)
            per_ask_vec_constraints.append(vec)
            per_ask_host_constraints.append(host)
            constraint_labels.append(labels)

            affs, haffs = [], []
            merged_affs = list(ask.job.affinities) + list(ask.tg.affinities)
            for t in ask.tg.tasks:
                merged_affs.extend(t.affinities)
            for a in merged_affs:
                op = _VECTOR_OPS.get(a.operand)
                if (op is not None and a.ltarget.startswith("${")
                        and not a.rtarget.startswith("${")):
                    affs.append((op, target_col(a.ltarget), a.rtarget,
                                 float(a.weight)))
                else:
                    haffs.append(a)
            per_ask_affinities.append(affs)
            per_ask_host_affinities.append(haffs)

            for sp in list(ask.job.spreads) + list(ask.tg.spreads):
                target_col(sp.attribute)

        A = max(len(attr_targets), 1)

        # ---- rank-interned attribute matrix ----
        # value universe per column: node values + operand literals
        node_vals: List[List[Optional[str]]] = [[None] * N for _ in range(A)]
        universes: List[set] = [set() for _ in range(A)]
        for col, t in enumerate(attr_targets):
            for i, n in enumerate(nodes):
                v, ok = resolve_node_target(n, t)
                if ok:
                    node_vals[col][i] = str(v)
                    universes[col].add(str(v))
        for g, vecs in enumerate(per_ask_vec_constraints):
            for op, col, operand in vecs:
                universes[col].add(operand)
        for g, affs in enumerate(per_ask_affinities):
            for op, col, operand, w in affs:
                universes[col].add(operand)
        for ask in asks:
            for sp in list(ask.job.spreads) + list(ask.tg.spreads):
                for st in sp.spread_targets:
                    universes[attr_target_ix[sp.attribute]].add(st.value)

        rank_columns = [RankColumn(u) for u in universes]
        idt = _index_dtype(rank_columns, A)
        attr_rank = np.full((Np, A), -1, idt)
        for col in range(A):
            rc = rank_columns[col]
            for i in range(N):
                v = node_vals[col][i]
                if v is not None:
                    attr_rank[i, col] = rc.rank(v)

        # ---- constraint program arrays ----
        C = _pad_pow2(max((len(v) for v in per_ask_vec_constraints),
                          default=1), floor=4)
        c_op = np.zeros((Gp, C), idt)
        c_col = np.zeros((Gp, C), idt)
        c_rank = np.zeros((Gp, C), idt)
        for g, vecs in enumerate(per_ask_vec_constraints):
            for k, (op, col, operand) in enumerate(vecs):
                c_op[g, k] = op
                c_col[g, k] = col
                c_rank[g, k] = rank_columns[col].rank(operand)

        CA = _pad_pow2(max((len(v) for v in per_ask_affinities), default=1),
                       floor=2)
        a_op = np.zeros((Gp, CA), idt)
        a_col = np.zeros((Gp, CA), idt)
        a_rank = np.zeros((Gp, CA), idt)
        a_weight = np.zeros((Gp, CA), np.float32)
        a_weight_sum = np.zeros(Gp, np.float32)
        for g, affs in enumerate(per_ask_affinities):
            total = sum(abs(w) for _, _, _, w in affs)
            total += sum(abs(a.weight) for a in per_ask_host_affinities[g])
            a_weight_sum[g] = total
            for k, (op, col, operand, w) in enumerate(affs):
                a_op[g, k] = op
                a_col[g, k] = col
                a_rank[g, k] = rank_columns[col].rank(operand)
                a_weight[g, k] = w / total if total else 0.0

        # ---- host-evaluated affinity scores (version/regex/etc. operands) ----
        a_host = np.zeros((Gp, Np), np.float32)
        for g, haffs in enumerate(per_ask_host_affinities):
            total = a_weight_sum[g]
            for aff in haffs:
                c = Constraint(aff.ltarget, aff.rtarget, aff.operand)
                match = self._class_masked(nodes, c)
                a_host[g, :N] += match * (aff.weight / total if total else 0.0)

        # ---- host-evaluated feasibility mask ----
        host_ok = np.zeros((Gp, Np), bool)
        host_ok[:, :N] = True
        drv_masks: Dict[str, np.ndarray] = {}
        for g, ask in enumerate(asks):
            mask = np.ones(N, bool)
            # constraints not expressible on device, memoized by class
            for c in per_ask_host_constraints[g]:
                cmask = self._class_masked(nodes, c)
                mask &= cmask
            # drivers
            for drv in hostfeas.group_drivers(ask.tg):
                dmask = drv_masks.get(drv)
                if dmask is None:
                    dmask = np.fromiter(
                        (hostfeas.driver_feasible(n, drv) for n in nodes),
                        bool, N)
                    drv_masks[drv] = dmask
                mask &= dmask
            # host volumes
            if any(v.type in ("", "host") for v in ask.tg.volumes.values()):
                mask &= np.fromiter(
                    (hostfeas.host_volumes_feasible(n, ask.tg) for n in nodes),
                    bool, N)
            # distinct-hosts / distinct-property exclusions
            for nid in ask.distinct_hosts_blocked:
                i = node_index.get(nid)
                if i is not None:
                    mask[i] = False
            host_ok[g, :N] = mask

        # ---- dc eligibility ----
        dc_ok = np.zeros((Gp, NDC), bool)
        for g, ask in enumerate(asks):
            dcs = set(ask.job.datacenters)
            for dc, did in dc_interner.items():
                if dc in dcs or "*" in dcs:
                    dc_ok[g, did] = True

        # ---- asks ----
        ask_res = np.zeros((Gp, NUM_R), np.float32)
        ask_desired = np.ones(Gp, np.float32)
        distinct = np.full(Gp, -1, np.int32)
        distinct_interner = Interner()
        coll0 = np.zeros((Gp, Np), np.float32)
        penalty = np.zeros((Gp, Np), bool)
        for g, ask in enumerate(asks):
            ask_res[g] = group_resource_vector(ask.tg)
            ask_desired[g] = max(ask.tg.count, 1)
            if any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                   for c in ask.job.constraints):
                # job-level: no two allocs of the job share a node, across
                # all its task groups in this batch
                distinct[g] = distinct_interner.intern("job:" + ask.job.id)
            elif any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                     for c in hostfeas.merged_constraints(ask.job, ask.tg)):
                distinct[g] = distinct_interner.intern(
                    f"tg:{ask.job.id}:{ask.tg.name}")
            for nid, cnt in ask.existing_by_node.items():
                i = node_index.get(nid)
                if i is not None:
                    coll0[g, i] = cnt
            for nid in ask.penalty_nodes:
                i = node_index.get(nid)
                if i is not None:
                    penalty[g, i] = True

        # ---- spreads ----
        all_spreads = [list(ask.job.spreads) + list(ask.tg.spreads)
                       for ask in asks]
        S = _pad_pow2(max((len(s) for s in all_spreads), default=1), floor=1)
        V = _pad_pow2(max((rank_columns[attr_target_ix[sp.attribute]].n_values
                           for sps in all_spreads for sp in sps),
                          default=1), floor=2)
        sp_col = np.full((Gp, S), -1, idt)
        sp_weight = np.zeros((Gp, S), np.float32)
        sp_targeted = np.zeros((Gp, S), bool)
        sp_desired = np.full((Gp, S, V), -1.0, np.float32)
        sp_implicit = np.full((Gp, S), -1.0, np.float32)
        sp_used0 = np.zeros((Gp, S, V), np.float32)
        for g, (ask, sps) in enumerate(zip(asks, all_spreads)):
            sum_w = sum(sp.weight for sp in sps)
            total_count = max(ask.tg.count, 1)
            for s, sp in enumerate(sps):
                col = attr_target_ix[sp.attribute]
                rc = rank_columns[col]
                sp_col[g, s] = col
                sp_weight[g, s] = sp.weight / sum_w if sum_w else 0.0
                if sp.spread_targets:
                    sp_targeted[g, s] = True
                    sum_desired = 0.0
                    for st in sp.spread_targets:
                        d = (st.percent / 100.0) * total_count
                        r = rc.rank(st.value)
                        if r >= 0:
                            sp_desired[g, s, r] = d
                        sum_desired += d
                    if 0 < sum_desired < total_count:
                        sp_implicit[g, s] = total_count - sum_desired
                seed = ask.spread_seed.get(sp.attribute, {})
                for val, cnt in seed.items():
                    r = rc.rank(val)
                    if r >= 0:
                        sp_used0[g, s, r] = cnt

        # ---- devices ----
        dev_patterns: List[Tuple[str, str, str]] = []
        dev_pattern_ix: Dict[Tuple[str, str, str], int] = {}
        for ask in asks:
            for t in ask.tg.tasks:
                for d in t.resources.devices:
                    key = d.id_tuple()
                    if key not in dev_pattern_ix:
                        dev_pattern_ix[key] = len(dev_patterns)
                        dev_patterns.append(key)
        D = _pad_pow2(max(len(dev_patterns), 1), floor=1)
        dev_cap = np.zeros((Np, D), np.float32)
        dev_used0 = np.zeros((Np, D), np.float32)
        dev_ask = np.zeros((Gp, D), np.float32)
        if dev_patterns:
            from ..structs.resources import device_pattern_matches
            for i, n in enumerate(nodes):
                for dev in n.node_resources.devices:
                    healthy = sum(1 for inst in dev.instances if inst.healthy)
                    for key, dix in dev_pattern_ix.items():
                        if device_pattern_matches(key, dev.id_tuple()):
                            dev_cap[i, dix] += healthy
            if allocs_by_node:
                for nid, allocs in allocs_by_node.items():
                    i = node_index.get(nid)
                    if i is None:
                        continue
                    for a in allocs:
                        if a.terminal_status():
                            continue
                        for tr in a.allocated_resources.tasks.values():
                            for ad in tr.devices:
                                for key, dix in dev_pattern_ix.items():
                                    if device_pattern_matches(
                                            key, (ad.vendor, ad.type, ad.name)):
                                        dev_used0[i, dix] += len(ad.device_ids)
            for g, ask in enumerate(asks):
                for t in ask.tg.tasks:
                    for d in t.resources.devices:
                        dev_ask[g, dev_pattern_ix[d.id_tuple()]] += d.count

        # ---- placement schedule ----
        p_ask_list: List[int] = []
        for g, ask in enumerate(asks):
            p_ask_list.extend([g] * ask.count)
        K = _pad_pow2(max(len(p_ask_list), 1), floor=1)
        p_ask = np.zeros(K, np.int32)
        p_ask[:len(p_ask_list)] = p_ask_list

        # ---- ask priorities + evictable-alloc planes ----
        ask_prio = np.zeros(Gp, np.int32)
        for g, ask in enumerate(asks):
            ask_prio[g] = int(getattr(ask.job, "priority", 0) or 0)
        ev_prio = ev_res = ev_ids = ev_lists = None
        if evict_e > 0:
            E = evict_e
            ev_prio = np.full((Np, E), -1, np.int16)
            ev_res = np.zeros((Np, E, NUM_R), np.float32)
            ev_ids = [[""] * E for _ in range(Np)]
            ev_lists = [[] for _ in range(Np)]
            if allocs_by_node:
                for nid, allocs in allocs_by_node.items():
                    i = node_index.get(nid)
                    if i is None:
                        continue
                    cands = _evict_candidates(allocs)
                    ev_lists[i] = cands
                    ev_prio[i], ev_res[i], ev_ids[i] = _evict_row(
                        cands, E)

        return PackedBatch(
            node_ids=[n.id for n in nodes], n_real=N,
            avail=avail, reserved=reserved, used0=used0, valid=valid,
            node_class=node_class, node_dc=node_dc, attr_rank=attr_rank,
            n_asks=G, ask_res=ask_res, ask_desired=ask_desired,
            distinct=distinct, dc_ok=dc_ok, host_ok=host_ok,
            coll0=coll0, penalty=penalty,
            c_op=c_op, c_col=c_col, c_rank=c_rank,
            a_op=a_op, a_col=a_col, a_rank=a_rank, a_weight=a_weight,
            a_host=a_host,
            sp_col=sp_col, sp_weight=sp_weight, sp_targeted=sp_targeted,
            sp_desired=sp_desired, sp_implicit=sp_implicit, sp_used0=sp_used0,
            dev_cap=dev_cap, dev_used0=dev_used0, dev_ask=dev_ask,
            p_ask=p_ask, n_place=len(p_ask_list),
            rank_columns=rank_columns, attr_targets=attr_targets,
            constraint_labels=constraint_labels,
            class_ids=dict(class_interner.items()),
            dc_ids=dict(dc_interner.items()),
            dev_pattern_ids=dict(dev_pattern_ix),
            ask_prio=ask_prio, ev_prio=ev_prio, ev_res=ev_res,
            ev_ids=ev_ids, ev_lists=ev_lists,
        )

    def delta_pack(self, template: PackedBatch,
                   node_index: Dict[str, int],
                   delta: ClusterDelta) -> Optional[NodeDelta]:
        """Incremental tensorize: turn a ClusterDelta into scatter-update
        arrays against `template` instead of a full re-pack.

        Returns None whenever the delta cannot be expressed inside the
        template's interned universe — a joined/changed node carrying an
        attribute value or datacenter the rank tables have never seen,
        an alloc on an unknown node, or more joins than the padded node
        axis holds — in which case the caller must fall back to a full
        repack.  Computed classes are the one table that CAN grow in
        place: class ids live in an unbounded int column, not a sized
        axis.

        u_idx/u_res/u_dev are pre-aggregated per node slot so the numpy
        `+=` apply sees each slot once.
        """
        R = template.avail.shape[1]
        A = template.attr_rank.shape[1]
        D = template.dev_cap.shape[1]
        Np = template.avail.shape[0]
        idt = template.attr_rank.dtype
        n_real = template.n_real

        new_nodes: List[Node] = []
        slot_of: Dict[str, int] = {}

        def slot_for(nid: str) -> Optional[int]:
            s = node_index.get(nid)
            if s is not None:
                return s
            return slot_of.get(nid)

        # ---- node upserts (joins get tail slots in the padding) ----
        rows: List[Tuple[int, Node]] = []
        for n in delta.upsert_nodes:
            s = slot_for(n.id)
            if s is None:
                s = n_real + len(new_nodes)
                if s >= Np:
                    return None                 # node axis overflow
                slot_of[n.id] = s
                new_nodes.append(n)
            rows.append((s, n))

        M = len(rows) + len(delta.remove_node_ids)
        idx = np.zeros(M, np.int32)
        avail = np.zeros((M, R), np.float32)
        reserved = np.zeros((M, R), np.float32)
        valid = np.zeros(M, bool)
        node_class = np.zeros(M, np.int32)
        node_dc = np.zeros(M, np.int32)
        attr_rank = np.full((M, A), -1, idt)
        dev_cap = np.zeros((M, D), np.float32)

        for m, (s, n) in enumerate(rows):
            cap, res = node_capacity_vectors(n)
            idx[m] = s
            avail[m] = cap - res
            reserved[m] = res
            valid[m] = n.ready()
            did = template.dc_ids.get(n.datacenter)
            if did is None:
                return None                     # dc axis is sized
            node_dc[m] = did
            cls = n.computed_class or n.compute_class()
            cid = template.class_ids.get(cls)
            if cid is None:                     # class ids are unbounded
                cid = (max(template.class_ids.values()) + 1
                       if template.class_ids else 0)
                template.class_ids[cls] = cid
            node_class[m] = cid
            for col, t in enumerate(template.attr_targets):
                v, ok = resolve_node_target(n, t)
                if not ok:
                    continue
                r = template.rank_columns[col].rank(str(v))
                if r < 0:
                    return None                 # unseen attr value
                attr_rank[m, col] = r
            if template.dev_pattern_ids:
                from ..structs.resources import device_pattern_matches
                for dev in n.node_resources.devices:
                    healthy = sum(1 for i in dev.instances if i.healthy)
                    for key, dix in template.dev_pattern_ids.items():
                        if device_pattern_matches(key, dev.id_tuple()):
                            dev_cap[m, dix] += healthy

        # ---- removes: valid=False tombstones keeping current rows ----
        for k, nid in enumerate(delta.remove_node_ids):
            s = slot_for(nid)
            if s is None:
                return None                     # unknown node id
            m = len(rows) + k
            idx[m] = s
            avail[m] = template.avail[s]
            reserved[m] = template.reserved[s]
            valid[m] = False
            node_class[m] = template.node_class[s]
            node_dc[m] = template.node_dc[s]
            attr_rank[m] = template.attr_rank[s]
            dev_cap[m] = template.dev_cap[s]

        # ---- usage deltas (allocs placed / stopped), per-slot sums ----
        u_res_by: Dict[int, np.ndarray] = {}
        u_dev_by: Dict[int, np.ndarray] = {}
        alloc_place: List[Tuple[int, object]] = []
        alloc_stop: List[Tuple[int, object]] = []

        def charge(nid: str, alloc, sign: float) -> bool:
            s = slot_for(nid)
            if s is None:
                return False
            (alloc_place if sign > 0 else alloc_stop).append((s, alloc))
            vec = u_res_by.get(s)
            if vec is None:
                vec = u_res_by[s] = np.zeros(R, np.float32)
            vec += sign * alloc_usage_vector(alloc)
            drow = alloc_device_usage(template.dev_pattern_ids, D, alloc)
            if drow is not None:
                dv = u_dev_by.get(s)
                if dv is None:
                    dv = u_dev_by[s] = np.zeros(D, np.float32)
                dv += sign * drow
            return True

        for nid, alloc in delta.place:
            if not charge(nid, alloc, 1.0):
                return None
        for nid, alloc in delta.stop:
            if not charge(nid, alloc, -1.0):
                return None

        slots = sorted(set(u_res_by) | set(u_dev_by))
        u_idx = np.asarray(slots, np.int32)
        u_res = np.zeros((len(slots), R), np.float32)
        u_dev = np.zeros((len(slots), D), np.float32)
        for i, s in enumerate(slots):
            if s in u_res_by:
                u_res[i] = u_res_by[s]
            if s in u_dev_by:
                u_dev[i] = u_dev_by[s]

        return NodeDelta(
            idx=idx, avail=avail, reserved=reserved, valid=valid,
            node_class=node_class, node_dc=node_dc, attr_rank=attr_rank,
            dev_cap=dev_cap, u_idx=u_idx, u_res=u_res, u_dev=u_dev,
            new_nodes=new_nodes, n_real_new=n_real + len(new_nodes),
            alloc_place=alloc_place, alloc_stop=alloc_stop)

    @staticmethod
    def ask_signature(ask: PlacementAsk):
        """Hashable semantic signature of an ask's CACHEABLE row - the
        spec-derived program pieces (constraints, affinities, spreads,
        resources, drivers, volumes, datacenters).  Excludes per-eval
        state (existing allocs, penalties, blocked hosts, spread seeds),
        which is pasted onto the cached row per ask, and excludes
        ask.count, which only sizes the placement vector."""
        return (Tensorizer.job_signature(ask.job),
                Tensorizer.tg_signature(ask.tg))

    @staticmethod
    def ask_signer():
        """Per-call signature helper that memoizes the job-level half
        by object identity — a batch's asks usually share few jobs, and
        the job half is ~half the hashing cost.  Scope the returned
        closure to ONE pack call (identity memoization is only sound
        while the caller holds the job objects)."""
        jmemo: dict = {}

        def sig(a):
            js = jmemo.get(id(a.job))
            if js is None:
                js = Tensorizer.job_signature(a.job)
                jmemo[id(a.job)] = js
            return (js, Tensorizer.tg_signature(a.tg))
        return sig

    @staticmethod
    def job_signature(job):
        """Job-level half of ask_signature."""
        sig: list = []
        add = sig.append
        add("c")
        for c in job.constraints:
            add(c.ltarget); add(c.rtarget); add(c.operand)
        add("a")
        for a in job.affinities:
            add(a.ltarget); add(a.rtarget); add(a.operand); add(a.weight)
        add("s")
        for sp in job.spreads:
            # per-spread marker: targets are variable-arity, and two
            # adjacent spreads must not flatten ambiguously
            add("sp"); add(sp.attribute); add(sp.weight)
            for t in (sp.spread_targets or ()):
                add(t.value); add(t.percent)
        add("d"); sig.extend(job.datacenters)
        return tuple(sig)

    @staticmethod
    def tg_signature(tg):
        """Task-group half of ask_signature (flat append-driven build:
        this runs once per ask on the pack critical path)."""
        sig: list = []
        add = sig.append
        add("c")
        for c in tg.constraints:
            add(c.ltarget); add(c.rtarget); add(c.operand)
        add("a")
        for a in tg.affinities:
            add(a.ltarget); add(a.rtarget); add(a.operand); add(a.weight)
        add("s")
        for sp in tg.spreads:
            add("sp"); add(sp.attribute); add(sp.weight)
            for t in (sp.spread_targets or ()):
                add(t.value); add(t.percent)
        add(tg.count); add(tg.ephemeral_disk.size_mb)
        add(tg.ephemeral_disk.sticky)
        if tg.volumes:
            add("v")
            sig.extend(sorted(
                (k, v.type, v.source, v.read_only)
                for k, v in tg.volumes.items()))
        add("n")
        for n in tg.networks:
            add(n.mbits)
        for t in tg.tasks:
            add("t"); add(t.driver)
            r = t.resources
            add(r.cpu); add(r.memory_mb); add(r.disk_mb)
            for c in t.constraints:
                add(c.ltarget); add(c.rtarget); add(c.operand)
            add("ta")
            for a in t.affinities:
                add(a.ltarget); add(a.rtarget); add(a.operand)
                add(a.weight)
            add("td")
            for d in r.devices:
                add(d.name); add(d.count); add(str(d.constraints))
            add("tn")
            for n in r.networks:
                add(n.mbits)
        return tuple(sig)

    def repack_asks(self, nodes: Sequence[Node], asks: Sequence[PlacementAsk],
                    template: PackedBatch,
                    gp: Optional[int] = None, kp: Optional[int] = None,
                    drv_cache: Optional[Dict[str, np.ndarray]] = None,
                    row_cache: Optional[Dict] = None
                    ) -> Optional[PackedBatch]:
        """Rebuild ONLY the ask-side tensors of `template`, reusing its
        node-side arrays and rank universes untouched: no O(N) node walk
        per batch.  Returns None when an ask steps outside the template's
        universe (unknown attr column, too many constraint slots, unknown
        device pattern, distinct_property limits), in which case the
        caller falls back to a full `pack`.

        Ordered comparisons against operands the universe has never seen
        stay exact via RankColumn.insertion (a `<` against an unseen
        operand becomes `<` against its insertion rank, etc. — lexical
        order is preserved by construction).  `drv_cache` memoizes the
        per-driver node masks and `row_cache` the spec-derived row of
        each ask signature, across calls, for as long as the caller
        keeps the template's node side unchanged.
        """
        N = len(nodes)
        Np = template.avail.shape[0]
        if N != template.n_real:
            return None
        G = len(asks)
        gp = gp or template.ask_res.shape[0]
        C = template.c_op.shape[1]
        CA = template.a_op.shape[1]
        S = template.sp_col.shape[1]
        V = template.sp_desired.shape[2]
        D = template.dev_cap.shape[1]
        NDC = template.dc_ok.shape[1]
        if G > gp:
            return None
        # asks with distinct_property limits take the full pack, as in
        # the reference
        if any(ask.property_limits for ask in asks):
            return None
        rank_columns = template.rank_columns
        attr_ix = {t: i for i, t in enumerate(template.attr_targets)}

        def ranked(col: int, operand: str, op: int
                   ) -> Optional[Tuple[int, int]]:
            """(op, rank) for an operand vs a fixed universe; exact for
            every op. None = inexpressible."""
            rc = rank_columns[col]
            r = rc.rank(operand)
            if r >= 0:
                return op, r
            if op in (OP_EQ, OP_NE, OP_IS_SET, OP_NOT_SET):
                return op, -2          # never equals a real rank
            ins = rc.insertion(operand)
            if op in (OP_LT, OP_LE):   # value < unseen  ==  value <= pred
                return OP_LT, ins
            if op in (OP_GT, OP_GE):
                return OP_GE, ins
            return None

        node_index = {n.id: i for i, n in enumerate(nodes)}
        if drv_cache is None:
            drv_cache = {}
        FALLBACK = "fallback"

        def build_row(ask):
            """Spec-derived row pieces for one ask (no per-eval state).
            Returns FALLBACK when the ask is inexpressible in this
            universe (caller returns None -> full pack path)."""
            row = {
                "c_op": np.zeros(C, np.int32),
                "c_col": np.zeros(C, np.int32),
                "c_rank": np.zeros(C, np.int32),
                "a_op": np.zeros(CA, np.int32),
                "a_col": np.zeros(CA, np.int32),
                "a_rank": np.zeros(CA, np.int32),
                "a_weight": np.zeros(CA, np.float32),
                "a_host": np.zeros(N, np.float32),
                "dc_ok": np.zeros(NDC, bool),
                "sp_col": np.full(S, -1, np.int32),
                "sp_weight": np.zeros(S, np.float32),
                "sp_targeted": np.zeros(S, bool),
                "sp_desired": np.full((S, V), -1.0, np.float32),
                "sp_implicit": np.full(S, -1.0, np.float32),
                "dev_ask": np.zeros(D, np.float32),
            }
            vec, labels, host = [], [], []
            for c in hostfeas.merged_constraints(ask.job, ask.tg):
                if c.operand in (CONSTRAINT_DISTINCT_HOSTS,
                                 CONSTRAINT_DISTINCT_PROPERTY):
                    continue
                op = _VECTOR_OPS.get(c.operand)
                if (op is not None and c.ltarget.startswith("${")
                        and not c.rtarget.startswith("${")):
                    col = attr_ix.get(c.ltarget)
                    if col is None:
                        return FALLBACK
                    orank = ranked(col, c.rtarget, op)
                    if orank is None:
                        return FALLBACK
                    vec.append((orank[0], col, orank[1]))
                    labels.append(str(c))
                else:
                    host.append(c)
            if len(vec) > C:
                return FALLBACK
            for k, (op, col, r) in enumerate(vec):
                row["c_op"][k] = op
                row["c_col"][k] = col
                row["c_rank"][k] = r
            row["labels"] = labels

            mask = np.ones(N, bool)
            for c in host:
                mask &= self._class_masked(nodes, c)
            for drv in hostfeas.group_drivers(ask.tg):
                dmask = drv_cache.get(drv)
                if dmask is None:
                    dmask = np.fromiter(
                        (hostfeas.driver_feasible(n, drv) for n in nodes),
                        bool, N)
                    drv_cache[drv] = dmask
                mask &= dmask
            if any(v.type in ("", "host") for v in ask.tg.volumes.values()):
                mask &= np.fromiter(
                    (hostfeas.host_volumes_feasible(n, ask.tg)
                     for n in nodes), bool, N)
            row["host_ok"] = mask

            affs, haffs = [], []
            merged_affs = list(ask.job.affinities) + list(ask.tg.affinities)
            for t in ask.tg.tasks:
                merged_affs.extend(t.affinities)
            for a in merged_affs:
                op = _VECTOR_OPS.get(a.operand)
                if (op is not None and a.ltarget.startswith("${")
                        and not a.rtarget.startswith("${")):
                    col = attr_ix.get(a.ltarget)
                    if col is None:
                        return FALLBACK
                    affs.append((col, a.rtarget, op, float(a.weight)))
                else:
                    haffs.append(a)
            if len(affs) > CA:
                return FALLBACK
            total = (sum(abs(w) for _, _, _, w in affs)
                     + sum(abs(a.weight) for a in haffs))
            for k, (col, operand, op, w) in enumerate(affs):
                orank = ranked(col, operand, op)
                if orank is None:
                    return FALLBACK
                row["a_op"][k] = orank[0]
                row["a_col"][k] = col
                row["a_rank"][k] = orank[1]
                row["a_weight"][k] = w / total if total else 0.0
            for aff in haffs:
                c = Constraint(aff.ltarget, aff.rtarget, aff.operand)
                match = self._class_masked(nodes, c)
                row["a_host"] += match * (aff.weight / total if total
                                          else 0.0)

            dcs = set(ask.job.datacenters)
            for dc, did in template.dc_ids.items():
                if dc in dcs or "*" in dcs:
                    row["dc_ok"][did] = True

            row["ask_res"] = group_resource_vector(ask.tg)
            row["ask_desired"] = float(max(ask.tg.count, 1))
            if any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                   for c in ask.job.constraints):
                row["distinct_kind"] = "job"
            elif any(c.operand == CONSTRAINT_DISTINCT_HOSTS
                     for c in hostfeas.merged_constraints(ask.job, ask.tg)):
                row["distinct_kind"] = "tg"
            else:
                row["distinct_kind"] = None

            sps = list(ask.job.spreads) + list(ask.tg.spreads)
            if len(sps) > S:
                return FALLBACK
            sum_w = sum(sp.weight for sp in sps)
            total_count = max(ask.tg.count, 1)
            for si, sp in enumerate(sps):
                col = attr_ix.get(sp.attribute)
                if col is None:
                    return FALLBACK
                rc = rank_columns[col]
                if rc.n_values > V:
                    return FALLBACK
                row["sp_col"][si] = col
                row["sp_weight"][si] = sp.weight / sum_w if sum_w else 0.0
                if sp.spread_targets:
                    row["sp_targeted"][si] = True
                    sum_desired = 0.0
                    for st in sp.spread_targets:
                        d = (st.percent / 100.0) * total_count
                        r = rc.rank(st.value)
                        if r >= 0:
                            row["sp_desired"][si, r] = d
                        sum_desired += d
                    if 0 < sum_desired < total_count:
                        row["sp_implicit"][si] = total_count - sum_desired

            for t in ask.tg.tasks:
                for d in t.resources.devices:
                    dix = template.dev_pattern_ids.get(d.id_tuple())
                    if dix is None:
                        return FALLBACK
                    row["dev_ask"][dix] += d.count
            return row

        # one cached spec row per distinct ask shape; per-eval state is
        # pasted over the copy in the assembly loop below, so cached
        # rows are never mutated
        rows = []
        signer = self.ask_signer()
        for ask in asks:
            sig = signer(ask) if row_cache is not None else None
            row = row_cache.get(sig) if sig is not None else None
            if row is None:
                row = build_row(ask)
                if row is FALLBACK:
                    return None
                if sig is not None:
                    row_cache[sig] = row
            rows.append(row)

        # program rows reuse the TEMPLATE's (possibly int16-minimized)
        # dtypes, as the full pack would give them
        idt = template.attr_rank.dtype
        c_op = np.zeros((gp, C), idt)
        c_col = np.zeros((gp, C), idt)
        c_rank = np.zeros((gp, C), idt)
        a_op = np.zeros((gp, CA), idt)
        a_col = np.zeros((gp, CA), idt)
        a_rank = np.zeros((gp, CA), idt)
        a_weight = np.zeros((gp, CA), np.float32)
        a_host = np.zeros((gp, Np), np.float32)
        host_ok = np.zeros((gp, Np), bool)
        host_ok[:, :N] = True      # padding rows keep the universe
        dc_ok = np.zeros((gp, NDC), bool)
        ask_res = np.zeros((gp, NUM_R), np.float32)
        ask_desired = np.ones(gp, np.float32)
        distinct = np.full(gp, -1, np.int32)
        distinct_interner = Interner()
        coll0 = np.zeros((gp, Np), np.float32)
        penalty = np.zeros((gp, Np), bool)
        sp_col = np.full((gp, S), -1, idt)
        sp_weight = np.zeros((gp, S), np.float32)
        sp_targeted = np.zeros((gp, S), bool)
        sp_desired = np.full((gp, S, V), -1.0, np.float32)
        sp_implicit = np.full((gp, S), -1.0, np.float32)
        sp_used0 = np.zeros((gp, S, V), np.float32)
        dev_ask = np.zeros((gp, D), np.float32)
        constraint_labels: List[List[str]] = []
        p_ask_list: List[int] = []

        for g, (ask, row) in enumerate(zip(asks, rows)):
            c_op[g], c_col[g], c_rank[g] = \
                row["c_op"], row["c_col"], row["c_rank"]
            constraint_labels.append(row["labels"])
            host_ok[g, :N] = row["host_ok"]
            for nid in ask.distinct_hosts_blocked:
                i = node_index.get(nid)
                if i is not None:
                    host_ok[g, i] = False
            a_op[g], a_col[g], a_rank[g] = \
                row["a_op"], row["a_col"], row["a_rank"]
            a_weight[g] = row["a_weight"]
            a_host[g, :N] = row["a_host"]
            dc_ok[g] = row["dc_ok"]
            ask_res[g] = row["ask_res"]
            ask_desired[g] = row["ask_desired"]
            if row["distinct_kind"] == "job":
                distinct[g] = distinct_interner.intern("job:" + ask.job.id)
            elif row["distinct_kind"] == "tg":
                distinct[g] = distinct_interner.intern(
                    f"tg:{ask.job.id}:{ask.tg.name}")
            for nid, cnt in ask.existing_by_node.items():
                i = node_index.get(nid)
                if i is not None:
                    coll0[g, i] = cnt
            for nid in ask.penalty_nodes:
                i = node_index.get(nid)
                if i is not None:
                    penalty[g, i] = True
            sp_col[g], sp_weight[g] = row["sp_col"], row["sp_weight"]
            sp_targeted[g] = row["sp_targeted"]
            sp_desired[g] = row["sp_desired"]
            sp_implicit[g] = row["sp_implicit"]
            if ask.spread_seed:
                for si, sp in enumerate(list(ask.job.spreads)
                                        + list(ask.tg.spreads)):
                    seed = ask.spread_seed.get(sp.attribute, {})
                    if seed:
                        rc = rank_columns[sp_col[g, si]]
                        for val, cnt in seed.items():
                            r = rc.rank(val)
                            if r >= 0:
                                sp_used0[g, si, r] = cnt
            dev_ask[g] = row["dev_ask"]
            p_ask_list.extend([g] * ask.count)

        kp = kp or _pad_pow2(max(len(p_ask_list), 1), floor=1)
        if len(p_ask_list) > kp:
            return None
        p_ask = np.zeros(kp, np.int32)
        p_ask[:len(p_ask_list)] = p_ask_list

        ask_prio = np.zeros(gp, np.int32)
        for g, ask in enumerate(asks):
            ask_prio[g] = int(getattr(ask.job, "priority", 0) or 0)

        return PackedBatch(
            node_ids=template.node_ids, n_real=template.n_real,
            avail=template.avail, reserved=template.reserved,
            used0=template.used0, valid=template.valid,
            node_class=template.node_class, node_dc=template.node_dc,
            attr_rank=template.attr_rank,
            n_asks=G, ask_res=ask_res, ask_desired=ask_desired,
            distinct=distinct, dc_ok=dc_ok, host_ok=host_ok,
            coll0=coll0, penalty=penalty,
            c_op=c_op, c_col=c_col, c_rank=c_rank,
            a_op=a_op, a_col=a_col, a_rank=a_rank, a_weight=a_weight,
            a_host=a_host,
            sp_col=sp_col, sp_weight=sp_weight, sp_targeted=sp_targeted,
            sp_desired=sp_desired, sp_implicit=sp_implicit,
            sp_used0=sp_used0,
            dev_cap=template.dev_cap, dev_used0=template.dev_used0,
            dev_ask=dev_ask,
            p_ask=p_ask, n_place=len(p_ask_list),
            rank_columns=rank_columns, attr_targets=template.attr_targets,
            constraint_labels=constraint_labels,
            class_ids=template.class_ids, dc_ids=template.dc_ids,
            dev_pattern_ids=template.dev_pattern_ids,
            ask_prio=ask_prio,
            # the node-side eviction planes ride along from the template
            # (delta-maintained there; ev_lists stay the template's).
            # The id rows are a shallow copy: the host fixup reads them
            # after the fetch, when a plan fed to the world meanwhile may
            # have replaced a row (apply_evict_ops replaces, never edits)
            ev_prio=template.ev_prio, ev_res=template.ev_res,
            ev_ids=(None if template.ev_ids is None
                    else list(template.ev_ids)),
        )

    def _class_masked(self, nodes: Sequence[Node], c: Constraint) -> np.ndarray:
        """Evaluate a host-op constraint per node, memoized by computed class
        unless the constraint escapes class optimization (unique.* targets)."""
        escapes = ("${node.unique." in c.ltarget or "${attr.unique." in c.ltarget
                   or "${meta.unique." in c.ltarget
                   or "unique." in c.rtarget)
        out = np.zeros(len(nodes), bool)
        if escapes:
            for i, n in enumerate(nodes):
                out[i] = hostfeas.node_meets_constraint(n, c)
            return out
        key_base = (c.ltarget, c.rtarget, c.operand)
        for i, n in enumerate(nodes):
            ck = (n.computed_class, key_base)
            v = self._class_memo.get(ck)
            if v is None:
                v = hostfeas.node_meets_constraint(n, c)
                self._class_memo[ck] = v
            out[i] = v
        return out
