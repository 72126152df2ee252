"""Pack a (nodes, asks) scheduling problem into dense tensors.

The counterpart of `nomad_tpu.solver.tensorize`, reduced to the one-shot
pack: node fingerprints and task-group asks become `nodes[N,R]` resource
arrays, rank-interned attribute columns, and per-ask constraint programs.
Non-vectorizable checks (regex, version, semver, set_contains, host
volumes, driver health) are evaluated host-side — memoized by computed
class exactly like the reference's FeasibilityWrapper
(scheduler/feasible.go:915) — and folded into a per-ask boolean `host_ok`
mask.

`Tensorizer.pack` returns numpy arrays, plane for plane what the JAX
package's packer returns; `packed_from_numpy` moves a batch (from either
packer) onto a torch device for the solve.

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


#: array fields of PackedBatch, in declaration order (the planes
#: `packed_from_numpy` moves onto a device)
ARRAY_FIELDS = (
    "avail", "reserved", "used0", "valid", "node_class", "node_dc",
    "attr_rank", "ask_res", "ask_desired", "distinct", "dc_ok", "host_ok",
    "coll0", "penalty", "c_op", "c_col", "c_rank", "a_op", "a_col",
    "a_rank", "a_weight", "a_host", "sp_col", "sp_weight", "sp_targeted",
    "sp_desired", "sp_implicit", "sp_used0", "dev_cap", "dev_used0",
    "dev_ask", "p_ask")


def packed_from_numpy(arrays: dict, device) -> PackedBatch:
    """A PackedBatch whose planes are torch tensors on `device`.

    `arrays` maps field names to numpy arrays (the ARRAY_FIELDS, exactly
    as either package's packer produces them) plus the scalar fields
    `n_real`, `n_asks` and `n_place`; any other field present (ids,
    labels, interning tables) is carried over as is.  Dtypes are kept:
    bool planes stay bool, int16 index planes stay int16."""
    import torch
    kw = {}
    for f in fields(PackedBatch):
        if f.name in ARRAY_FIELDS:
            kw[f.name] = torch.as_tensor(np.ascontiguousarray(
                arrays[f.name])).to(device)
        elif f.name in arrays:
            kw[f.name] = arrays[f.name]
        elif f.name == "node_ids":
            kw[f.name] = [""] * int(arrays["n_real"])
    return PackedBatch(**kw)


class Tensorizer:
    """Builds PackedBatch from nodes + asks. Stateless across calls except
    for host-op memoization keyed by computed class."""

    def __init__(self) -> None:
        self._class_memo: Dict[Tuple[str, tuple], bool] = {}

    def pack(self, nodes: Sequence[Node], asks: Sequence[PlacementAsk],
             allocs_by_node: Optional[Dict[str, list]] = None
             ) -> PackedBatch:
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
