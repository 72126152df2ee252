"""Solver orchestration: pack -> device solve -> unpack into placements.

The counterpart of `nomad_tpu.solver.solve` on its one-shot pack path.
The discrete leftovers the tensor solve can't express (exact port
picking, device instance IDs — SURVEY §7.3) are fixed up host-side here,
walking the kernel's top-K candidates per placement so a port/instance
conflict falls through to the next-best node instead of failing the eval.

The solve runs on the solver's device, `cuda` unless the caller asks for
the CPU; with no GPU present a default `Solver()` raises instead of
carrying on quietly on the CPU.  The reference's host-twin routing
(`prefer_host`), watchdog failover, resident world, chaos injection and
plan views are not part of this package, nor is the scheduler-facing
interface that serves only the resident world and its in-kernel eviction
pass (`solve()`'s `snapshot` / `proposed_delta` / `preempt`,
`resident_active()`, `note_plan_result()`, `Placement.evicted`,
`LazyAllocsView`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..structs import (AllocatedDeviceResource, AllocatedResources,
                       AllocatedSharedResources, AllocatedTaskResources,
                       AllocMetric, DeviceAccounter, NetworkIndex, Node)
from .kernel import TOP_K, solve_kernel
from .tensorize import (NUM_R, PackedBatch, PlacementAsk, Tensorizer,
                        R_CPU, R_DISK, R_MEM, R_NET)

_DIM_NAMES = {R_CPU: "cpu", R_MEM: "memory", R_DISK: "disk", R_NET: "network"}


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: `cuda` by default.  Raises when CUDA
    is asked for (or defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch: no CUDA device is available; the solver "
            "runs on the GPU unless constructed with device='cpu'")
    return dev


@dataclass
class Placement:
    ask_index: int
    node: Optional[Node]
    score: float
    metrics: AllocMetric
    resources: Optional[AllocatedResources] = None
    failed_reason: str = ""


@dataclass
class SolveOutput:
    placements: List[Placement]
    class_eligibility: List[Dict[str, bool]] = field(default_factory=list)
    # ^ per ask: computed-class -> any feasible node of that class
    #: solve-span attributes: wave / rescore counters and wall times
    trace: Dict = field(default_factory=dict)


class PendingSolve:
    """An in-flight solve: packed and launched on the device, fetch and
    host fixup deferred to `wait()`, the only blocking step (idempotent,
    single-owner).

      pack_wall_s      host pack (tensorize) wall
      dispatch_wall_s  launch wall after the pack (host-side cost of
                       driving the wave loop up to its last launch)
      fetch_wall_s     wall blocked inside wait() on the device result
      finish_wall_s    host fixup walk wall
    """

    __slots__ = ("_solver", "_pb", "_nodes", "_asks", "_allocs_by_node",
                 "_by_dc", "_res", "_t0", "_out", "pack_wall_s",
                 "dispatch_wall_s", "fetch_wall_s", "finish_wall_s")

    def __init__(self, solver, pb=None, nodes=None, asks=None,
                 allocs_by_node=None, by_dc=None, res=None, t0: float = 0.0,
                 out: Optional[SolveOutput] = None):
        self._solver = solver
        self._pb = pb
        self._nodes = nodes
        self._asks = asks
        self._allocs_by_node = allocs_by_node
        self._by_dc = by_dc
        self._res = res
        self._t0 = t0
        self._out = out
        self.pack_wall_s = 0.0
        self.dispatch_wall_s = 0.0
        self.fetch_wall_s = 0.0
        self.finish_wall_s = 0.0

    def wait(self) -> SolveOutput:
        """Block until the device result lands, then run the host fixup.
        Safe to call again after completion (returns the cached output);
        not safe to call concurrently from two threads."""
        if self._out is not None:
            return self._out
        t0 = time.perf_counter()
        res = _to_host(self._res)
        t1 = time.perf_counter()
        self.fetch_wall_s = t1 - t0
        out = self._solver._finish_solve(self._pb, self._nodes, self._asks,
                                         res, self._allocs_by_node,
                                         self._by_dc, self._t0)
        self.finish_wall_s = time.perf_counter() - t1
        out.trace["pack_wall_s"] = round(self.pack_wall_s, 6)
        out.trace["dispatch_wall_s"] = round(self.dispatch_wall_s, 6)
        out.trace["fetch_wall_s"] = round(self.fetch_wall_s, 6)
        self._out = out
        self._res = self._pb = self._nodes = self._asks = None
        self._allocs_by_node = self._by_dc = None
        return out


def _to_host(res):
    """SolveResult with every tensor fetched to a numpy array."""
    return res._replace(**{
        k: v.cpu().numpy() for k, v in res._asdict().items()
        if isinstance(v, torch.Tensor)})


class Solver:
    """Stateful wrapper owning tensorizer memoization. One per scheduler
    worker (reference analog: the Stack owned by each scheduler).
    `device` is where the solve runs: `cuda` when None."""

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._tensorizer = Tensorizer()

    @property
    def device(self) -> torch.device:
        return self._device

    def solve(self, nodes: Sequence[Node], asks: Sequence[PlacementAsk],
              allocs_by_node: Optional[Dict[str, list]] = None,
              by_dc: Optional[Dict[str, int]] = None) -> SolveOutput:
        return self.solve_async(nodes, asks, allocs_by_node, by_dc).wait()

    def solve_async(self, nodes: Sequence[Node],
                    asks: Sequence[PlacementAsk],
                    allocs_by_node: Optional[Dict[str, list]] = None,
                    by_dc: Optional[Dict[str, int]] = None) -> PendingSolve:
        """Dispatch phase of `solve`: pack and launch the solve without
        fetching the result; `wait()` on the returned PendingSolve
        fetches and runs the host fixup walk."""
        t0 = time.perf_counter()
        if not asks:
            return PendingSolve(self, out=SolveOutput(placements=[]), t0=t0)
        pb = self._tensorizer.pack(nodes, asks, allocs_by_node)
        t_pack = time.perf_counter()
        res = _run_kernel(pb, self._device)
        pending = PendingSolve(self, pb=pb, nodes=nodes, asks=list(asks),
                               allocs_by_node=allocs_by_node, by_dc=by_dc,
                               res=res, t0=t0)
        pending.pack_wall_s = t_pack - t0
        pending.dispatch_wall_s = time.perf_counter() - t_pack
        return pending

    def _finish_solve(self, pb: PackedBatch, sol_nodes, asks, res,
                      allocs_by_node, by_dc, _solve_t0: float
                      ) -> SolveOutput:
        """Fetch-side half of `solve`: walks the host fixup over the
        fetched (numpy) result and builds the SolveOutput."""
        trace_attrs = {"n_asks": int(pb.n_asks), "n_place": int(pb.n_place),
                       "n_nodes": int(pb.n_real),
                       "device": self._device.type,
                       "waves": int(res.n_waves),
                       "rescore_waves": int(res.n_rescore),
                       "shortlist_waves": int(res.n_waves)
                       - int(res.n_rescore),
                       "unfinished": int(res.unfinished.sum()),
                       "kernel_wall_s": round(
                           time.perf_counter() - _solve_t0, 6)}
        choice, choice_ok, score = res.choice, res.choice_ok, res.score
        n_feasible, n_exhausted = res.n_feasible, res.n_exhausted
        dim_exhausted, feas = res.dim_exhausted, res.feas
        cons_filtered, unfinished = res.cons_filtered, res.unfinished

        # host fixup state: per-node port/device accounting incl.
        # in-batch.  host_used is the AUTHORITATIVE usage: when a
        # placement falls through to a lower-ranked candidate, the
        # kernel's in-batch commit charged the wrong node, so every
        # candidate is re-checked against host_used before acceptance.
        # Likewise distinct_hosts / distinct_property are re-enforced
        # here across in-batch commits.
        net_cache: Dict[int, NetworkIndex] = {}
        dev_cache: Dict[int, DeviceAccounter] = {}
        host_used = pb.used0.copy()
        chosen_by_ask: Dict[int, set] = {}
        # distinct_property charges shared batch-wide by (scope, target)
        prop_used: Dict[tuple, Dict[str, int]] = {}

        placements: List[Placement] = []
        for p in range(pb.n_place):
            g = int(pb.p_ask[p])
            ask = asks[g]
            m = AllocMetric()
            m.nodes_evaluated = pb.n_real
            m.nodes_available = dict(by_dc or {})
            if unfinished[p]:
                # never decided: its per-wave metric slots were never
                # written, so don't fabricate filtered/exhausted counts
                m.nodes_filtered = 0
            else:
                m.nodes_filtered = pb.n_real - int(n_feasible[p])
                for ci, label in enumerate(pb.constraint_labels[g]):
                    cnt = int(cons_filtered[g, ci])
                    if cnt:
                        m.constraint_filtered[label] = cnt
                m.nodes_exhausted = int(n_exhausted[p])
                for d in range(NUM_R):
                    cnt = int(dim_exhausted[p, d])
                    if cnt:
                        m.dimension_exhausted[_DIM_NAMES[d]] = cnt

            placed = None
            ask_vec = pb.ask_res[g]
            for k in range(TOP_K):
                if not choice_ok[p, k]:
                    break
                ni = int(choice[p, k])
                node = sol_nodes[ni]
                if not np.all(host_used[ni] + ask_vec <= pb.avail[ni]):
                    continue
                gid = int(pb.distinct[g])
                if gid >= 0 and ni in chosen_by_ask.get(gid, ()):
                    continue
                prop_vals = self._property_fit(node, ask, prop_used)
                if prop_vals is None:
                    continue
                resources = self._host_commit(node, ni, ask, net_cache,
                                              dev_cache, allocs_by_node)
                if resources is None:
                    continue
                host_used[ni] += ask_vec
                if gid >= 0:
                    chosen_by_ask.setdefault(gid, set()).add(ni)
                for key, val in prop_vals:
                    by_val = prop_used.setdefault(key, {})
                    by_val[val] = by_val.get(val, 0) + 1
                m.score_meta = [
                    {"node_id": pb.node_ids[int(choice[p, j])],
                     "normalized_score": float(score[p, j])}
                    for j in range(TOP_K) if choice_ok[p, j]]
                placed = Placement(ask_index=g, node=node,
                                   score=float(score[p, k]), metrics=m,
                                   resources=resources)
                break
            if placed is None:
                if unfinished[p]:
                    # the wave budget ran out before this placement was
                    # decided; the blocked-eval path will retry it
                    reason = "solve wave budget exhausted (retryable)"
                elif n_feasible[p] > 0:
                    reason = "resources exhausted"
                else:
                    reason = "no feasible nodes"
                placed = Placement(ask_index=g, node=None, score=0.0,
                                   metrics=m, failed_reason=reason)
            placements.append(placed)

        # class eligibility for blocked-eval optimization
        class_elig: List[Dict[str, bool]] = []
        node_class = pb.node_class[:pb.n_real]
        inv_class = {v: k for k, v in pb.class_ids.items()}
        for g in range(pb.n_asks):
            fg = feas[g, :pb.n_real]
            elig: Dict[str, bool] = {}
            for cid, cname in inv_class.items():
                members = node_class == cid
                if members.any():
                    elig[cname] = bool(fg[members].any())
            class_elig.append(elig)

        return SolveOutput(placements=placements,
                           class_eligibility=class_elig, trace=trace_attrs)

    @staticmethod
    def _host_commit(node: Node, node_ix: int, ask: PlacementAsk,
                     net_cache: Dict[int, NetworkIndex],
                     dev_cache: Dict[int, DeviceAccounter],
                     allocs_by_node) -> Optional[AllocatedResources]:
        """Build AllocatedResources with real ports + device instance ids.

        Works on clones and reserves each offer immediately, so multiple
        tasks in one group see each other's ports/instances; the clone is
        only promoted into the cache on success (all-or-nothing).
        Returns None if the discrete assignment fails on this node.
        """
        idx = net_cache.get(node_ix)
        if idx is None:
            idx = NetworkIndex()
            idx.set_node(node)
            if allocs_by_node:
                idx.add_allocs(allocs_by_node.get(node.id, ()))
            net_cache[node_ix] = idx
        acct = dev_cache.get(node_ix)
        if acct is None:
            acct = DeviceAccounter(node)
            if allocs_by_node:
                acct.add_allocs(allocs_by_node.get(node.id, ()))
            dev_cache[node_ix] = acct

        idx = idx.clone()
        acct = acct.clone()

        out = AllocatedResources()
        for t in ask.tg.tasks:
            tr = AllocatedTaskResources(cpu=t.resources.cpu,
                                        memory_mb=t.resources.memory_mb)
            for ask_net in t.resources.networks:
                offer, _err = idx.assign_network(ask_net)
                if offer is None:
                    return None
                idx.add_reserved(offer)
                tr.networks.append(offer)
            for d in t.resources.devices:
                got = Solver._assign_devices(acct, node, d)
                if got is None:
                    return None
                acct.add_reserved(got.vendor, got.type, got.name,
                                  got.device_ids)
                tr.devices.append(got)
            out.tasks[t.name] = tr
        shared_nets = []
        for ask_net in ask.tg.networks:
            offer, _err = idx.assign_network(ask_net)
            if offer is None:
                return None
            idx.add_reserved(offer)
            shared_nets.append(offer)
        out.shared = AllocatedSharedResources(
            disk_mb=ask.tg.ephemeral_disk.size_mb, networks=shared_nets)
        net_cache[node_ix] = idx
        dev_cache[node_ix] = acct
        return out

    @staticmethod
    def _property_fit(node: Node, ask: PlacementAsk,
                      used: Dict[tuple, Dict[str, int]]):
        """Check distinct_property limits against existing + in-batch
        counts.  Limits are keyed (scope, attr target); charges under one
        key are shared across all asks carrying it.  Returns the
        (key, value) pairs to charge on acceptance, or None if any
        property is at its limit."""
        if not ask.property_limits:
            return ()
        from ..structs import resolve_node_target
        out = []
        for key, (limit, existing) in ask.property_limits.items():
            target = key[1] if isinstance(key, tuple) else key
            val, ok = resolve_node_target(node, target)
            if not ok:
                # nodes missing the property are infeasible for
                # distinct_property (reference: propertyset.go:240)
                return None
            val = str(val)
            count = existing.get(val, 0) + used.get(key, {}).get(val, 0)
            if count + 1 > limit:
                return None
            out.append((key, val))
        return out

    @staticmethod
    def _assign_devices(acct: DeviceAccounter, node: Node, req
                        ) -> Optional[AllocatedDeviceResource]:
        """Pick free instance ids matching the request pattern
        (reference: scheduler/device.go:32 AssignDevice)."""
        for dev in node.node_resources.devices:
            dv, dt, dm = dev.id_tuple()
            if not req.matches(dv, dt, dm):
                continue
            free = acct.free_instances(dv, dt, dm)
            if len(free) >= req.count:
                return AllocatedDeviceResource(
                    vendor=dv, type=dt, name=dm,
                    device_ids=free[:req.count])
        return None


def _run_kernel(pb: PackedBatch, device, max_waves: int = 0):
    """Launch the solve for a packed batch on `device` (not fetched).
    The fused wave kernel mode resolves from the shape ("auto": the
    CUDA kernel on a GPU, the torch scorer on the CPU).  Batches without
    distinct_hosts groups drop the blocking planes, which turns on the
    shortlist-resident contention waves."""
    has_spread = bool((pb.sp_col[:, 0] >= 0).any())
    has_distinct = bool((pb.distinct >= 0).any())
    return solve_kernel(*_kernel_args(pb, device), has_spread=has_spread,
                        has_distinct=has_distinct, pallas_mode="auto",
                        max_waves=max_waves)


def _kernel_args(pb: PackedBatch, device="cpu"):
    """The solve_kernel argument tuple for `pb`, planes as tensors on
    `device` (numpy planes are copied there; tensors are moved)."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return tuple(t(x) for x in (
        pb.avail, pb.reserved, pb.used0, pb.valid, pb.node_dc, pb.attr_rank,
        pb.ask_res, pb.ask_desired, pb.distinct, pb.dc_ok, pb.host_ok,
        pb.coll0,
        pb.penalty, pb.c_op, pb.c_col, pb.c_rank, pb.a_op, pb.a_col,
        pb.a_rank, pb.a_weight, pb.a_host, pb.sp_col, pb.sp_weight,
        pb.sp_targeted,
        pb.sp_desired, pb.sp_implicit, pb.sp_used0, pb.dev_cap, pb.dev_used0,
        pb.dev_ask, pb.p_ask)) + (pb.n_place,)
