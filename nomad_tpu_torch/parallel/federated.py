"""Federated and cross-region resident solves.

The counterpart of `nomad_tpu.parallel.federated`.  Nomad federates by
running an independent server cluster per region and forwarding RPCs
between them (nomad/serf.go WAN gossip, nomad/rpc.go `forward`); each
region's scheduler sees only its own nodes.

  * `FederatedResidentSolver` keeps that isolation (each region owns its
    node universe, usage and eval stream) and runs every region's
    stream step in one call (`_federated_stream_kernel`: the reference's
    scan over steps of a vmap over regions, here a loop over regions
    with the wave loop in "while" mode and the shortlist off).
  * `CrossRegionResidentSolver` places every eval against the UNION of
    all regions' nodes on one three-tier elastic mesh: candidate keys
    merge per host, then per region, and only region winners cross
    regions, in the same (score desc, global id asc) order, so the
    results equal a flat mesh's.
  * `RegionDirectory` is the federation membership table that gossip
    join / fail events drive.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver.resident import (ResidentSolver, _ASK_ARGS, _host, _pack_out,
                               _solve_one, _status, unpack_stream)
from ..solver.tensorize import PackedBatch, PlacementAsk
from ..structs import Node


def _federated_stream_kernel(node, used0, dev_used0, stacked, n_places,
                             seeds, *, compact=True, **kw):
    """Node planes carry a leading [R] region axis, `stacked` ask planes
    [B, R, ...], `n_places` / `seeds` [B][R]: B steps, each solving every
    region against its own carried usage (`wave_mode="while"`, shortlist
    off, as the reference's vmap over regions).  Returns (used,
    dev_used, out [B, R, K, 2*TOP_K+1])."""
    kw = dict(kw, wave_mode="while", shortlist_c=-1)
    R = used0.shape[0]
    used = [used0[r] for r in range(R)]
    dev_used = [dev_used0[r] for r in range(R)]
    outs = []
    for b in range(len(n_places)):
        row = []
        for r in range(R):
            batch = {k: v[b, r] for k, v in stacked.items()}
            res = _solve_one({k: v[r] for k, v in node.items()}, used[r],
                             dev_used[r], batch, int(n_places[b][r]),
                             int(seeds[b][r]), **kw)
            status = _status(res.choice_ok[:, 0], res.unfinished)
            row.append(_pack_out(res.choice, res.score, status, compact))
            used[r], dev_used[r] = res.used_final, res.dev_used_final
        outs.append(torch.stack(row))
    return torch.stack(used), torch.stack(dev_used), torch.stack(outs)


class FederatedResidentSolver:
    """R regional node universes solved in one stream call.

    Every region gets its own ResidentSolver for packing (merge_asks /
    pack_batch run against that region's rank universe); the node-side
    planes are stacked [R, ...] once, on `device` (cuda unless the caller
    asks for the CPU).  Regions may differ in node count: the smaller
    universes pad to the largest padded node axis with dead rows, which
    score nothing and never win, so a padded region solves as its
    unpadded self.  The attribute, datacenter and device universes must
    agree (build every region from the same probe asks; pass `gp` / `kp`
    to pin the ask-side padding).
    """

    def __init__(self, region_nodes: Sequence[Sequence[Node]],
                 probe_asks: Sequence[PlacementAsk],
                 gp: Optional[int] = None, kp: Optional[int] = None,
                 max_waves: int = 0, evict_e: int = 0, device=None,
                 pallas: str = "auto"):
        from ..solver.tensorize import extend_template_rows
        if not region_nodes:
            raise ValueError("need at least one region")
        # regions passed the SAME node-list object share one packed
        # template and tensorizer (usage stays per region in the stacks);
        # the keyed list is kept alive beside its solver, so its id can
        # never be reused by another region's list
        shared: Dict[int, Tuple[object, ResidentSolver]] = {}
        self.solvers = []
        for nodes in region_nodes:
            entry = shared.get(id(nodes))
            if entry is None or entry[0] is not nodes:
                entry = (nodes, ResidentSolver(
                    nodes, probe_asks, gp=gp, kp=kp, max_waves=max_waves,
                    evict_e=evict_e, device=device, pallas=pallas))
                shared[id(nodes)] = entry
            self.solvers.append(entry[1])
        self.device = self.solvers[0].device
        self.R = len(self.solvers)
        self.gp = self.solvers[0].gp
        self.kp = self.solvers[0].kp
        self.max_waves = max_waves
        np_max = max(s.template.avail.shape[0] for s in self.solvers)
        for s in {id(s): s for s in self.solvers}.values():
            Np = s.template.avail.shape[0]
            if Np < np_max:
                extend_template_rows(s.template, np_max - Np)
                s._compact = np_max < 32768
                s._default_host_ok = np.zeros((s.gp, np_max), bool)
                s._default_host_ok[:, :s.template.n_real] = True
        # the other axes cannot be padded away: name the region
        for name in ("attr_rank", "dc_ok", "dev_cap"):
            ref_dim = tuple(getattr(self.solvers[0].template, name).shape)
            for r, s in enumerate(self.solvers):
                dim = tuple(getattr(s.template, name).shape)
                if dim != ref_dim:
                    raise ValueError(
                        f"region {r} disagrees on {name} shape: {dim} vs "
                        f"region 0's {ref_dim}; regions must share "
                        "attribute/datacenter/device universes (node "
                        "counts may differ)")

        def stack(name):
            return torch.as_tensor(np.stack(
                [getattr(s.template, name) for s in self.solvers])
            ).to(self.device)
        self._node_stack = {name: stack(name) for name in (
            "avail", "reserved", "valid", "node_dc", "attr_rank",
            "dev_cap")}
        self._used = stack("used0")
        self._dev_used = stack("dev_used0")
        self._const_cache: Dict = {}
        self._step_cache: Dict = {}
        self._default_host_ok = np.stack(
            [s._default_host_ok for s in self.solvers])   # [R, gp, Np]

    # ---------------- packing (per region) ----------------
    def merge_asks(self, region: int, asks: Sequence[PlacementAsk]):
        return self.solvers[region].merge_asks(asks)

    def pack_batch(self, region: int, asks: Sequence[PlacementAsk],
                   job_keys: Optional[set] = None) -> Optional[PackedBatch]:
        return self.solvers[region].pack_batch(asks, job_keys=job_keys)

    def pack_batch_cached(self, region: int, asks: Sequence[PlacementAsk],
                          job_keys: Optional[set] = None
                          ) -> Optional[PackedBatch]:
        return self.solvers[region].pack_batch_cached(asks,
                                                      job_keys=job_keys)

    # ---------------- solving ----------------
    def solve_stream(self, batches: Sequence[Sequence[PackedBatch]],
                     seeds: Optional[Sequence[Sequence[int]]] = None):
        """batches[r][b]: region r's b-th batch; every region carries the
        same number of steps.  Returns (choice, ok, score, status), each
        with leading [R, B] axes."""
        return self.finish_stream(self.solve_stream_async(batches, seeds))

    def solve_stream_async(self, batches: Sequence[Sequence[PackedBatch]],
                           seeds=None) -> torch.Tensor:
        NBs = {len(rb) for rb in batches}
        if len(batches) != self.R or len(NBs) != 1:
            raise ValueError(
                f"need {self.R} regions with equal step counts, got "
                f"{[len(rb) for rb in batches]}")
        NB = NBs.pop()
        for r, rb in enumerate(batches):
            self.solvers[r]._check_stream_jobs(rb)
        stacked = self._stack_args(batches, NB)
        n_places = [[batches[r][b].n_place for r in range(self.R)]
                    for b in range(NB)]
        seed_arr = ([[0] * self.R for _ in range(NB)] if seeds is None
                    else [[seeds[r][b] for r in range(self.R)]
                          for b in range(NB)])
        flat = [pb for rb in batches for pb in rb]
        self._used, self._dev_used, out = _federated_stream_kernel(
            self._node_stack, self._used, self._dev_used, stacked,
            n_places, seed_arr,
            has_spread=ResidentSolver._has_spread(flat),
            group_count_hint=ResidentSolver._group_count_hint(flat),
            max_waves=self.max_waves,
            has_distinct=ResidentSolver._has_distinct(flat),
            has_devices=ResidentSolver._has_devices(flat),
            pallas_mode=self.solvers[0].pallas,
            compact=self.solvers[0]._compact)
        return out

    def finish_stream(self, out) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        out = np.swapaxes(_host(out), 0, 1)          # [R, B, K, .]
        return unpack_stream(out)

    def _stack_args(self, batches, NB) -> Dict[str, torch.Tensor]:
        """The [B, R, ...] ask planes on the device, with device constants
        for the usually all-zero / default [G, N] planes.  A re-dispatched
        step (the same PackedBatch objects) ships nothing.  The cache key
        holds every region solver's node and eviction-plane epochs, so a
        delta applied to a region between steps is never served planes
        packed against its old universe."""
        step_key = (tuple(s._node_epoch for s in self.solvers),
                    tuple(s._ev_epoch for s in self.solvers),
                    tuple(id(pb) for rb in batches for pb in rb))
        flat_pbs = [pb for rb in batches for pb in rb]
        hit = self._step_cache.get(step_key)
        if hit is not None and len(hit[0]) == len(flat_pbs) \
                and all(a is b for a, b in zip(hit[0], flat_pbs)):
            return hit[1]
        dev = {}
        for name in _ASK_ARGS:
            mats = [[getattr(batches[r][b], name) for r in range(self.R)]
                    for b in range(NB)]
            if mats[0][0] is None:
                continue
            if name in ("coll0", "penalty", "a_host") and not any(
                    m.any() for row in mats for m in row):
                ckey = (name, NB)
                if ckey not in self._const_cache:
                    self._const_cache[ckey] = torch.zeros(
                        (NB, self.R) + mats[0][0].shape,
                        dtype=torch.as_tensor(mats[0][0][:0]).dtype,
                        device=self.device)
                dev[name] = self._const_cache[ckey]
                continue
            if name == "host_ok" and all(
                    np.array_equal(m, self._default_host_ok[r])
                    for row in mats for r, m in enumerate(row)):
                ckey = (name, NB)
                if ckey not in self._const_cache:
                    self._const_cache[ckey] = torch.as_tensor(
                        np.broadcast_to(
                            self._default_host_ok[None],
                            (NB,) + self._default_host_ok.shape).copy()
                    ).to(self.device)
                dev[name] = self._const_cache[ckey]
                continue
            dev[name] = torch.as_tensor(
                np.stack([np.stack(row) for row in mats])).to(self.device)
        if len(self._step_cache) > 64:
            self._step_cache.clear()
        self._step_cache[step_key] = (flat_pbs, dev)
        return dev

    @staticmethod
    def compile_count() -> int:
        """The reference's compile-cache probe; -1, its value for "probe
        unavailable": nothing here is traced or cached by shape."""
        return -1

    # ---------------- usage ----------------
    def usage(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.array(_host(self._used)), np.array(_host(self._dev_used))

    def reset_usage(self, used0: Optional[np.ndarray] = None,
                    dev_used0: Optional[np.ndarray] = None) -> None:
        if used0 is None:
            used0 = np.stack([s.template.used0 for s in self.solvers])
        if dev_used0 is None:
            dev_used0 = np.stack(
                [s.template.dev_used0 for s in self.solvers])
        # copies: a later in-place edit of the caller's array must never
        # reach the carried usage
        self._used = torch.as_tensor(np.array(used0)).to(self.device)
        self._dev_used = torch.as_tensor(np.array(dev_used0)).to(self.device)

    # ---------------- health ----------------
    def health_counters(self):
        """Union-fleet health in one kernel pass: the [R, Np, ...] region
        stacks flatten to one [R*Np, ...] node axis (the reduction is a
        sum over nodes).  Equal to merging the per-region host twins."""
        from ..telemetry.health import (MAX_NODES, _health_kernel,
                                        fetch_health)
        ns = self._node_stack
        R, Np = ns["valid"].shape
        if R * Np > MAX_NODES:
            raise ValueError(
                f"health kernel split accumulators are i32-safe up to "
                f"{MAX_NODES} stacked node rows; got {R * Np}")
        ask = self._const_cache.get(("health_ask_res", 0))
        if ask is None:
            ask = self._const_cache[("health_ask_res", 0)] = \
                torch.as_tensor(np.asarray(self.solvers[0].template.ask_res,
                                           np.float32)).to(self.device)
        nres = ns["avail"].shape[-1]
        return fetch_health(_health_kernel(
            ns["avail"].reshape(-1, nres), ns["valid"].reshape(-1),
            ns["node_dc"].reshape(-1), ns["dev_cap"].reshape(R * Np, -1),
            self._used.reshape(-1, nres),
            self._dev_used.reshape(R * Np, -1), ask))

    def health_host_twin(self):
        """Per-region numpy twins, merged: what `health_counters` is held
        to."""
        used, dev_used = self.usage()
        out = None
        for r, s in enumerate(self.solvers):
            hc = _twin_no_ev(s.template, used[r], dev_used[r])
            out = hc if out is None else out.merge(hc)
        return out


def _twin_no_ev(template, used, dev_used):
    """Host twin over a template whose device stack carries no eviction
    planes (the federated node stack): they are masked off, so the twin
    sees what the kernel saw."""
    from ..telemetry.health import health_host
    if getattr(template, "ev_prio", None) is None:
        return health_host(template, used, dev_used)
    import copy
    t = copy.copy(template)
    t.ev_prio = None
    t.ev_res = None
    return health_host(t, used, dev_used)


# ===================================================================
# Cross-region scheduling
# ===================================================================

class RegionDirectory:
    """Federation membership table: region -> live gossip members,
    driven by WAN-gossip join / fail events (``on_join`` / ``on_fail``
    take a member with `.region` and `.id`).  Every transition lands in
    the mesh event log as a ``region.*`` event."""

    def __init__(self, event_log=None):
        from ..utils.tracing import global_mesh_events
        self.event_log = (global_mesh_events if event_log is None
                          else event_log)
        self._members: Dict[str, set] = {}

    @staticmethod
    def _region_member(member) -> Tuple[str, str]:
        region = getattr(member, "region", None) or "global"
        mid = getattr(member, "id", None) or str(member)
        return str(region), str(mid)

    def on_join(self, member) -> None:
        region, mid = self._region_member(member)
        new_region = not self._members.get(region)
        self._members.setdefault(region, set()).add(mid)
        self.event_log.record(
            "region.join", region=region, member=mid,
            n_members=len(self._members[region]),
            new_region=bool(new_region))

    def on_fail(self, member) -> None:
        region, mid = self._region_member(member)
        self._members.get(region, set()).discard(mid)
        left = not self._members.get(region)
        self.event_log.record(
            "region.fail", region=region, member=mid,
            n_members=len(self._members.get(region, ())))
        if left:
            # the last member gone: the region leaves the federation
            self.event_log.record("region.leave", region=region)

    def regions(self) -> List[str]:
        return sorted(r for r, m in self._members.items() if m)

    def members_of(self, region: str) -> List[str]:
        return sorted(self._members.get(region, ()))


class CrossRegionResidentSolver:
    """Cross-region scheduling over one three-tier elastic mesh.

    Where FederatedResidentSolver keeps Nomad's isolation, this solver
    places every eval against the union of all regions' nodes.  The
    union node axis splits over a ("regions", "hosts", "chips") mesh
    (region r's nodes on region r's shards, `n_hosts_per_region` hosts a
    region, `devices` as for make_three_tier_mesh); candidate keys merge
    per host, then per region, and only region-winner windows cross
    regions, in the (score desc, global id asc) order of every tier, so
    placements and all explainability counters equal a flat mesh's.
    Built on ElasticShardedResidentSolver: a shard lost inside a region
    degrades the mesh (the lost tiles' nodes drop out fleet-wide) and
    ``recover_region`` rejoins it at the original topology."""

    def __init__(self, region_nodes: Sequence[Sequence[Node]],
                 probe_asks: Sequence[PlacementAsk], *,
                 region_names: Optional[Sequence[str]] = None,
                 n_hosts_per_region: int = 1,
                 n_devices: Optional[int] = None, devices=None,
                 directory: Optional[RegionDirectory] = None, **kw):
        from .sharded import (ElasticShardedResidentSolver,
                              make_three_tier_mesh)
        if not region_nodes:
            raise ValueError("need at least one region")
        self.R = len(region_nodes)
        self.region_names = (list(region_names) if region_names
                             else [f"region{r}" for r in range(self.R)])
        if len(self.region_names) != self.R:
            raise ValueError(f"{len(self.region_names)} region names for "
                             f"{self.R} regions")
        union: List[Node] = []
        #: node id -> owning region name (which region a placement
        #: landed in)
        self.region_of: Dict[str, str] = {}
        self._region_slices: Dict[str, Tuple[int, int]] = {}
        for name, nodes in zip(self.region_names, region_nodes):
            lo = len(union)
            union.extend(nodes)
            self._region_slices[name] = (lo, len(union))
            for n in nodes:
                self.region_of[n.id] = name
        if devices is None and kw.get("device") is not None:
            devices = [kw["device"]]
        mesh = make_three_tier_mesh(self.R, n_hosts_per_region, n_devices,
                                    devices=devices)
        self.solver = ElasticShardedResidentSolver(union, probe_asks,
                                                   mesh=mesh, **kw)
        self.directory = directory
        self.event_log = self.solver.event_log
        for name, (lo, hi) in self._region_slices.items():
            self.event_log.record(
                "region.join", region=name, n_nodes=hi - lo,
                shards_per_region=self.solver.shards_per_region)

    # ---------------- delegation to the union solver ----------------
    def pack_batch(self, asks, job_keys=None):
        return self.solver.pack_batch(asks, job_keys=job_keys)

    def pack_batch_cached(self, asks, job_keys=None):
        return self.solver.pack_batch_cached(asks, job_keys=job_keys)

    def merge_asks(self, asks):
        return self.solver.merge_asks(asks)

    def solve_stream(self, batches, seeds=None):
        return self.solver.solve_stream(batches, seeds)

    def solve_stream_async(self, batches, seeds=None):
        return self.solver.solve_stream_async(batches, seeds)

    def apply_delta(self, delta, evicted: bool = False):
        return self.solver.apply_delta(delta, evicted=evicted)

    def reset_usage(self, used0=None, dev_used0=None):
        return self.solver.reset_usage(used0=used0, dev_used0=dev_used0)

    def usage(self):
        return self.solver.usage()

    def health_counters(self):
        """Fleet health over the union mesh, with the elastic live-row
        mask: a region-degraded mesh reports only the device-resident
        fleet, as the solve sees it."""
        return self.solver.health_counters()

    def health_row_mask(self):
        return self.solver.health_row_mask()

    def wave_traffic(self, batches) -> Dict:
        """The whole tier stack: memory, ici, per-region dcn and the wan
        block (see ShardedResidentSolver.wave_traffic)."""
        return self.solver.wave_traffic(batches)

    @property
    def template(self):
        return self.solver.template

    @property
    def mesh_state(self) -> str:
        return self.solver.mesh_state

    # ---------------- region surfaces ----------------
    def _region_index(self, region) -> int:
        if isinstance(region, str):
            return self.region_names.index(region)
        return int(region)

    def region_shards(self, region) -> List[int]:
        """Linear shard ids of one region on the healthy mesh."""
        ix = self._region_index(region)
        spr = self.solver.shards_per_region
        return list(range(ix * spr, (ix + 1) * spr))

    def region_bias_plane(self, gp: int, home,
                          weight: float = 1.0) -> np.ndarray:
        """[gp, Np] region-affinity plane for the score spec's `region`
        term (solve_kernel / host_solve_kernel ``region_bias=``): +weight
        on the home region's rows, 0 elsewhere."""
        Np = self.solver.template.avail.shape[0]
        plane = np.zeros((gp, Np), np.float32)
        lo, hi = self._region_slices[self.region_names[
            self._region_index(home)]]
        plane[:, lo:hi] = np.float32(weight)
        return plane

    def fail_region_shard(self, region, shard_in_region: int = 0
                          ) -> List[int]:
        """Shard loss inside a region: the lost tiles' nodes drop out of
        every solve while every surviving shard keeps solving.  Returns
        the lost tile ids."""
        ix = self._region_index(region)
        shard = self.region_shards(ix)[shard_in_region]
        lost = self.solver.fail_shard(shard)
        self.event_log.record("region.degraded",
                              region=self.region_names[ix],
                              shard=int(shard), lost_tiles=len(lost))
        return lost

    def recover_region(self) -> int:
        """Rejoin the failed shard at the original three-tier topology
        (ElasticShardedResidentSolver.recover)."""
        recovered = self.solver.recover()
        self.event_log.record("region.recovered", bytes=int(recovered))
        return recovered
