"""Solver orchestration: pack -> device solve -> unpack into placements.

The counterpart of `nomad_tpu.solver.solve`.  The discrete leftovers the
tensor solve can't express (exact port picking, device instance IDs —
SURVEY §7.3) are fixed up host-side here, walking the kernel's top-K
candidates per placement so a port/instance conflict falls through to
the next-best node instead of failing the eval.

A Solver built with a state store (`Solver(store=store)`, as the
worker builds its own) keeps a resident cluster world once the cluster
has `resident_min_nodes` nodes: the node side is packed once and then
advanced by changesets — the plan results the scheduler's planner feeds
back (`note_plan_result`) and the store's change log — and each solve
repacks only its asks (`Tensorizer.repack_asks`) and overlays the plan's
proposed stops and sticky probes onto a copy of the carried usage.  The
scheduler then reads allocs by node through `LazyAllocsView` instead of
walking the cluster.

The resident world also carries the in-kernel preemption planes
(`Solver(evict_e=)`, `EVICT_E` = 8 slots per node by default, 0 for
none).  A solve with `preempt=True` on such a world runs the kernel's
eviction pass, with a doubled wave budget, and a placement it commits
that way comes back with the victims' alloc ids in `Placement.evicted`.

The device solve runs on the solver's device, `cuda` unless the caller
asks for the CPU; with no GPU present a default `Solver()` raises instead
of carrying on quietly on the CPU.  `Solver(host=)` routes a problem by
its size, as the reference's does: "auto" (the default) solves a small
one with the numpy twin (`host.host_solve_kernel`, when
`host.prefer_host` holds for its padded node axis, asks and placements),
"never" pins the device solve and "always" the twin.  The pick depends
on the problem only, never on whether a GPU is present; each solve span
says which ran (`backend`: "host" or "device").  Under the serving
tier's brownout (`set_degraded`) solves run with the reduced
`BROWNOUT_MAX_WAVES` budget, and `health_counters` samples the resident
world for the server's telemetry beat.

The device route consults the chaos site "device_solve" just before
`solve_kernel` (one dict lookup while nothing is armed) and runs under
the solve watchdog (`watchdog.global_watchdog`), which is off unless a
chaos harness sets its deadline.  Armed, it answers a device solve that
an injected fault stalled past the deadline or poisoned from the host
twin, and the solve span's `backend` then reads "host_failover" or
"host_quarantine"; any other device error propagates.

`plan_view()` gives the what-if plan view (`PlanSolverView`) that the
HTTP API's `/v1/job/:id/plan` dry runs solve through: overlay-only
solves over the resident template that never create, sync, rebuild,
grow or feed the world, on the solver's device and its kernels.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..structs import (AllocatedDeviceResource, AllocatedResources,
                       AllocatedSharedResources, AllocatedTaskResources,
                       AllocMetric, DeviceAccounter, NetworkIndex, Node)
from ..chaos.injection import global_injections
from ..utils.metrics import global_metrics
from .host import host_solve_kernel, prefer_host
from .kernel import MAX_WAVES, TOP_K, solve_kernel
from .tensorize import (EVICT_E, NUM_R, ClusterDelta, PackedBatch,
                        PlacementAsk, Tensorizer, _evict_row,
                        alloc_device_usage, alloc_usage_vector,
                        apply_node_delta_host, R_CPU, R_DISK, R_MEM, R_NET)
from .watchdog import global_watchdog

_DIM_NAMES = {R_CPU: "cpu", R_MEM: "memory", R_DISK: "disk", R_NET: "network"}

#: clusters below this size full-pack per eval (the walk is cheap); at or
#: above it a store-attached Solver keeps a delta-updated resident world
RESIDENT_MIN_NODES = 512
#: a change-log sync whose delta touches more than this share of the
#: nodes rebuilds the resident world instead of applying the delta
DELTA_THRESHOLD = 0.25
#: `Solver(host=)` routes: by the problem's size, or pinned to one side
HOST_MODES = ("auto", "never", "always")
#: brownout wave budget: under sustained overload the serving tier's
#: admission controller flips workers into degraded mode and solves run
#: with this reduced budget — undecided placements come back retryable
#: and follow the normal blocked/requeue path, trading per-eval
#: completeness for queue drain
BROWNOUT_MAX_WAVES = 6


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: `cuda` by default.  Raises when CUDA
    is asked for (or defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch: no CUDA device is available; the solver "
            "runs on the GPU unless constructed with device='cpu'")
    return dev


class LazyAllocsView(dict):
    """Proposed live allocs by node, filled lazily from the snapshot
    (live minus `excluded` alloc ids).  The steady-state scheduler only
    touches a handful of nodes per eval (chosen candidates' port/device
    fixups, sticky preferences), so the O(cluster) walk the eager dict
    pays per eval collapses to O(touched); anything that genuinely
    needs the whole world (full-pack fallback iterating items()) just
    materializes.  Once a key is filled it is a plain dict entry, so
    in-place mutation (sticky probes, preemption rewrites) behaves
    exactly like the eager dict."""

    def __init__(self, snapshot, excluded=frozenset()):
        super().__init__()
        self._snap = snapshot
        self.excluded = set(excluded)
        self._filled = set()
        self._all = False

    def _fill(self, nid) -> None:
        if self._all or nid in self._filled:
            return
        self._filled.add(nid)
        live = [a for a in self._snap.allocs_by_node(nid)
                if not a.terminal_status() and a.id not in self.excluded]
        if live:                 # eager dict only has non-empty keys
            dict.__setitem__(self, nid, live)

    def materialize(self) -> "LazyAllocsView":
        if not self._all:
            pending: Dict[str, list] = {}
            for a in self._snap.allocs():
                if (a.terminal_status() or a.id in self.excluded
                        or a.node_id in self._filled):
                    continue
                pending.setdefault(a.node_id, []).append(a)
            for nid, lst in pending.items():
                dict.__setitem__(self, nid, lst)
            self._all = True
        return self

    def get(self, nid, default=None):
        self._fill(nid)
        return dict.get(self, nid, default)

    def __getitem__(self, nid):
        self._fill(nid)
        return dict.__getitem__(self, nid)

    def __contains__(self, nid):
        self._fill(nid)
        return dict.__contains__(self, nid)

    def setdefault(self, nid, default=None):
        self._fill(nid)
        return dict.setdefault(self, nid, default)

    def items(self):
        return self.materialize() and dict.items(self)

    def keys(self):
        return self.materialize() and dict.keys(self)

    def values(self):
        return self.materialize() and dict.values(self)

    def __iter__(self):
        self.materialize()
        return dict.__iter__(self)

    def __len__(self):
        self.materialize()
        return dict.__len__(self)


class _ResidentWorld:
    """Delta-updated packed cluster state for a Solver: the node tensors
    are packed ONCE from a snapshot and then advanced by exact
    changesets — plan-apply results fed eagerly (note_plan_result) plus
    the state store's change log for everything written by other actors
    (client status updates, node joins/drains) — so steady-state
    scheduling never re-walks or re-tensorizes the world.  Falls back to
    a full rebuild when the change log was truncated, the delta escapes
    the interned universe, or it touches more than `DELTA_THRESHOLD` of
    the nodes."""

    def __init__(self, tz: Tensorizer, store, snapshot,
                 probe_asks: Sequence[PlacementAsk], evict_e: int = EVICT_E):
        self._tz = tz
        self.store = store
        self.evict_e = evict_e
        # probe asks define the ask universe; grown (dedup by spec
        # signature, capped) when an ask escapes it
        self._probe_sigs: Dict = {}
        self.probe_asks: List[PlacementAsk] = []
        self.add_probes(probe_asks)
        self.counters = {"delta_syncs": 0, "repack_fallbacks": 0,
                         "plan_feeds": 0, "last_delta_ratio": 0.0}
        self.drv_cache: Dict[str, np.ndarray] = {}
        self.row_cache: Dict = {}
        self.rebuild(snapshot)
        self.counters["repack_fallbacks"] = 0   # initial build is free

    def add_probes(self, asks: Sequence[PlacementAsk]) -> bool:
        added = False
        signer = self._tz.ask_signer()
        for a in asks:
            sig = signer(a)
            if sig not in self._probe_sigs and len(self.probe_asks) < 64:
                self._probe_sigs[sig] = True
                self.probe_asks.append(a)
                added = True
        return added

    def rebuild(self, snapshot) -> None:
        global_metrics.incr_counter("solver.resident.rebuild")
        self.nodes = list(snapshot.nodes())          # join order
        by_node: Dict[str, list] = {}
        self.live: Dict[str, tuple] = {}             # id -> (nid, alloc)
        for a in snapshot.allocs():
            if not a.terminal_status():
                by_node.setdefault(a.node_id, []).append(a)
                self.live[a.id] = (a.node_id, a)
        # the eviction planes ride on the template and are delta-
        # maintained with every other node plane
        self.template = self._tz.pack(self.nodes, self.probe_asks, by_node,
                                      evict_e=self.evict_e)
        # the template packs EVERY node; readiness (status, drain,
        # eligibility) lives in the valid mask instead of list filtering
        for i, n in enumerate(self.nodes):
            self.template.valid[i] = n.ready()
        self.node_index = {n.id: i for i, n in enumerate(self.nodes)}
        self.last_index = snapshot.index
        self.drv_cache.clear()
        self.row_cache.clear()
        self.counters["repack_fallbacks"] += 1

    def feed(self, delta: ClusterDelta) -> bool:
        """Apply an eagerly-fed changeset (plan-apply results).  The
        live map was already updated by the caller; only the tensors
        move here.  Returns False if the delta was inexpressible (the
        caller drops the world; the next solve rebuilds)."""
        nd = self._tz.delta_pack(self.template, self.node_index, delta)
        if nd is None:
            return False
        apply_node_delta_host(self.template, nd, self.nodes,
                              self.node_index)
        if nd.touches_nodes():
            self.drv_cache.clear()
            self.row_cache.clear()
        return True

    def sync(self, snapshot) -> None:
        """Advance the world to `snapshot.index` via the store change
        log, building an exact ClusterDelta from the changed entities
        only."""
        if snapshot.index == self.last_index:
            return
        if snapshot.index < self.last_index:
            self.rebuild(snapshot)       # state moved backwards: a new
            return                       # snapshot from another store
        entries = self.store.changes_since(self.last_index,
                                           snapshot.index)
        if entries is None:              # ring truncated past us
            self.rebuild(snapshot)
            return
        delta = ClusterDelta()
        seen: set = set()
        for _ix, kind, key in reversed(entries):
            if (kind, key) in seen:      # newest entry per key wins
                continue
            seen.add((kind, key))
            if kind == "node":
                n = snapshot.node_by_id(key)
                if n is None:
                    if key in self.node_index:
                        delta.remove_node_ids.append(key)
                else:
                    delta.upsert_nodes.append(n)
            else:
                a = snapshot.alloc_by_id(key)
                live_now = a is not None and not a.terminal_status()
                tracked = self.live.get(key)
                if live_now and tracked is None:
                    delta.place.append((a.node_id, a))
                    self.live[key] = (a.node_id, a)
                elif tracked is not None and not live_now:
                    delta.stop.append(tracked)
                    del self.live[key]
                elif tracked is not None and live_now:
                    old_nid, old = tracked
                    if (old_nid != a.node_id
                            or not np.array_equal(
                                alloc_usage_vector(old),
                                alloc_usage_vector(a))):
                        delta.stop.append(tracked)
                        delta.place.append((a.node_id, a))
                    self.live[key] = (a.node_id, a)
        self.counters["delta_syncs"] += 1
        global_metrics.incr_counter("solver.resident.delta_sync")
        if delta.empty():
            self.last_index = snapshot.index
            return
        nd = self._tz.delta_pack(self.template, self.node_index, delta)
        if nd is not None:
            ratio = nd.ratio(self.template.n_real)
            self.counters["last_delta_ratio"] = round(ratio, 6)
            if nd.touches_nodes() and ratio > DELTA_THRESHOLD:
                nd = None
        if nd is None:
            self.rebuild(snapshot)
            return
        apply_node_delta_host(self.template, nd, self.nodes,
                              self.node_index)
        if nd.touches_nodes():
            self.drv_cache.clear()
            self.row_cache.clear()
        self.last_index = snapshot.index


def _overlay_usage(world: _ResidentWorld, pb: PackedBatch,
                   proposed_delta) -> PackedBatch:
    """Copy-on-read overlay: apply this plan's proposed stops/probes to
    COPIES of the resident template's carried usage (and, for stops, its
    eviction candidate rows), leaving `world` bit-identical."""
    pb = copy.copy(pb)
    t = world.template
    used0 = t.used0.copy()
    dev_used0 = t.dev_used0.copy()
    stops, probes = proposed_delta or ((), ())
    D = dev_used0.shape[1]
    ev_gone: Dict[int, set] = {}
    for sign, group in ((-1.0, stops), (1.0, probes)):
        for a in group:
            i = world.node_index.get(a.node_id)
            if i is None:
                continue
            used0[i] += sign * alloc_usage_vector(a)
            drow = alloc_device_usage(t.dev_pattern_ids, D, a)
            if drow is not None:
                dev_used0[i] += sign * drow
            if sign < 0 and t.ev_lists is not None:
                ev_gone.setdefault(i, set()).add(a.id)
    pb.used0, pb.dev_used0 = used0, dev_used0
    if ev_gone and pb.ev_prio is not None:
        # a stopped alloc's usage already left the overlay; it must not
        # also be selectable as a victim (its capacity would count
        # twice).  Rebuild the touched rows on copies; sticky probes are
        # additions and never candidates.
        ev_prio = pb.ev_prio.copy()
        ev_res = pb.ev_res.copy()
        ev_ids = list(pb.ev_ids)
        E = ev_prio.shape[1]
        for i, gone in ev_gone.items():
            cands = [c for c in t.ev_lists[i] if c[2] not in gone]
            ev_prio[i], ev_res[i], ev_ids[i] = _evict_row(cands, E)
        pb.ev_prio, pb.ev_res, pb.ev_ids = ev_prio, ev_res, ev_ids
    return pb


def _private_planes(pb: PackedBatch) -> PackedBatch:
    """`pb` with a copy of every array and list it holds: a what-if
    plan's batch shares nothing with the resident template, so neither
    the solve (its planes, their uploads to the card) nor a plan result
    fed into the template while it runs can touch the other."""
    pb = copy.copy(pb)
    for f in dataclasses.fields(pb):
        v = getattr(pb, f.name)
        if isinstance(v, np.ndarray):
            setattr(pb, f.name, v.copy())
        elif isinstance(v, list):
            setattr(pb, f.name, [list(r) if isinstance(r, list) else r
                                 for r in v])
    return pb


@dataclass
class Placement:
    ask_index: int
    node: Optional[Node]
    score: float
    metrics: AllocMetric
    resources: Optional[AllocatedResources] = None
    failed_reason: str = ""
    #: alloc ids the in-kernel eviction pass chose as this placement's
    #: victims (empty for a normal placement); the scheduler turns them
    #: into the plan's node_preemptions
    evicted: List[str] = field(default_factory=list)


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
      t_dispatched     perf_counter stamp when the launch returned
      fetch_wall_s     wall blocked inside wait() on the device result
      finish_wall_s    host fixup walk wall
    """

    __slots__ = ("_solver", "packed", "_nodes", "_asks", "_allocs_by_node",
                 "_by_dc", "_used_resident", "_res", "_backend", "_t0",
                 "_out",
                 "pack_wall_s", "dispatch_wall_s", "t_dispatched",
                 "fetch_wall_s", "finish_wall_s")

    def __init__(self, solver, pb=None, nodes=None, asks=None,
                 allocs_by_node=None, by_dc=None,
                 used_resident: bool = False, res=None,
                 backend: str = "device", t0: float = 0.0,
                 out: Optional[SolveOutput] = None):
        self._solver = solver
        #: the batch this solve packed (resident or full); kept after
        #: wait() so a caller can re-solve exactly what was solved
        self.packed = pb
        self._nodes = nodes
        self._asks = asks
        self._allocs_by_node = allocs_by_node
        self._by_dc = by_dc
        self._used_resident = used_resident
        self._res = res
        #: the route that answered (`_run_kernel_routed`)
        self._backend = backend
        self._t0 = t0
        self._out = out
        self.pack_wall_s = 0.0
        self.dispatch_wall_s = 0.0
        self.t_dispatched = t0
        self.fetch_wall_s = 0.0
        self.finish_wall_s = 0.0

    def wait(self) -> SolveOutput:
        """Block until the device result lands, then run the host fixup.
        Safe to call again after completion (returns the cached output);
        not safe to call concurrently from two threads."""
        if self._out is not None:
            return self._out
        t0 = time.perf_counter()
        backend = self._backend
        res = _to_host(self._res)
        t1 = time.perf_counter()
        self.fetch_wall_s = t1 - t0
        out = self._solver._finish_solve(self.packed, self._nodes, self._asks,
                                         res, self._used_resident,
                                         self._allocs_by_node,
                                         self._by_dc, self._t0, backend)
        self.finish_wall_s = time.perf_counter() - t1
        out.trace["pack_wall_s"] = round(self.pack_wall_s, 6)
        out.trace["dispatch_wall_s"] = round(self.dispatch_wall_s, 6)
        out.trace["fetch_wall_s"] = round(self.fetch_wall_s, 6)
        self._out = out
        self._res = self._nodes = self._asks = None
        self._allocs_by_node = self._by_dc = None
        return out


def _to_host(res):
    """SolveResult with every tensor fetched to a numpy array (a host
    twin's result holds numpy arrays and passes through as it is)."""
    return res._replace(**{
        k: v.cpu().numpy() for k, v in res._asdict().items()
        if isinstance(v, torch.Tensor)})


class Solver:
    """Stateful wrapper owning tensorizer memoization. One per scheduler
    worker (reference analog: the Stack owned by each scheduler).
    `device` is where the solve runs: `cuda` when None.

    With a `store` attached, solves that pass their `snapshot` take the
    resident-world path once the cluster has `resident_min_nodes` nodes
    (`RESIDENT_MIN_NODES` by default): the world is built on the first
    such solve and advanced by `note_plan_result` and the store's change
    log; a sync whose delta touches more than `DELTA_THRESHOLD` of the
    nodes rebuilds it instead.  A store-less Solver always full-packs.
    `evict_e` is the width of the world's eviction planes (slots per
    node; 0 packs none, so preemption stays with the scheduler's host
    walk).

    `host` picks the compute route: "auto" (default) solves small
    problems with the numpy twin of the device solve (`host.py`, the
    same placements without the device round trip), "never" / "always"
    pin a route."""

    def __init__(self, device=None, store=None,
                 resident_min_nodes: Optional[int] = None,
                 evict_e: int = EVICT_E, host: str = "auto") -> None:
        if not isinstance(evict_e, int) or evict_e < 0:
            raise ValueError(f"evict_e={evict_e!r}: use a non-negative "
                             "slot width (0 packs no eviction planes)")
        if host not in HOST_MODES:
            raise ValueError(f"host={host!r}: use one of {HOST_MODES}")
        self._device = resolve_device(device)
        self._host = host
        self._tensorizer = Tensorizer()
        self._store = store
        self._evict_e = evict_e
        self._resident_min_nodes = (RESIDENT_MIN_NODES
                                    if resident_min_nodes is None
                                    else resident_min_nodes)
        self._world: Optional[_ResidentWorld] = None
        self._degraded = False
        #: serializes resident-world access between the thread that
        #: solves, the one that feeds plan results and the telemetry
        #: beat's health sample
        self._world_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def evict_e(self) -> int:
        return self._evict_e

    # ---------------------------------------------------------- brownout
    def set_degraded(self, degraded: bool) -> None:
        """Serving-tier brownout: solve with the reduced
        BROWNOUT_MAX_WAVES budget while set (leftovers stay
        retryable)."""
        with self._world_lock:
            self._degraded = bool(degraded)

    @property
    def degraded(self) -> bool:
        with self._world_lock:
            return self._degraded

    # ------------------------------------------------- resident world
    def resident_active(self, snapshot=None) -> bool:
        """Whether the next solve against `snapshot` can take the
        resident-delta path (callers use this to pick the lazy allocs
        view over the eager world walk)."""
        if self._store is None:
            return False
        if self._world is not None:
            return True
        if snapshot is None:
            return False
        return len(snapshot.nodes()) >= self._resident_min_nodes

    def note_plan_result(self, plan, result) -> None:
        """Feed an applied plan's outcome into the resident world — the
        planner calls this right after applying a plan, so the next
        eval's solve starts from already-advanced tensors and the
        change-log sync degenerates to a no-op dedup."""
        with self._world_lock:
            world = self._world
            if world is None or result is None:
                return
            delta = ClusterDelta()
            for allocs in (result.node_update or {}).values():
                for a in allocs:
                    tracked = world.live.pop(a.id, None)
                    if tracked is not None:
                        delta.stop.append(tracked)
            for allocs in (result.node_preemptions or {}).values():
                for a in allocs:
                    tracked = world.live.pop(a.id, None)
                    if tracked is not None:
                        delta.stop.append(tracked)
            for nid, allocs in (result.node_allocation or {}).items():
                for a in allocs:
                    if a.id not in world.live \
                            and not a.terminal_status():
                        delta.place.append((nid, a))
                        world.live[a.id] = (nid, a)
            if delta.empty():
                return
            world.counters["plan_feeds"] += 1
            if not world.feed(delta):
                # inexpressible eagerly (e.g. alloc on an unknown
                # node): drop the world; the next solve rebuilds from
                # its snapshot
                self._world = None

    def resident_counters(self) -> Optional[Dict]:
        with self._world_lock:
            world = self._world
            return dict(world.counters) if world else None

    def health_counters(self):
        """Fleet health sample over the resident world's delta-
        maintained host template (the server's telemetry beat), by the
        numpy reduction `health_host`, so the beat never touches the
        device.  None while no resident world is active."""
        with self._world_lock:
            world = self._world
            if world is None:
                return None
            from ..telemetry.health import health_host
            t = world.template
            return health_host(t, t.used0, t.dev_used0)

    def plan_view(self) -> "PlanSolverView":
        """Facade for dry-run (what-if) schedulers: same resident
        template, overlay-only solves, zero writes to carried state."""
        return PlanSolverView(self)

    def _resident_pack(self, snapshot, asks, proposed_delta,
                       overlay_only: bool = False):
        """The steady-state pack: sync the world to the snapshot via
        the change log, repack ONLY the ask side against the resident
        template, and overlay this plan's proposed stops/probes onto a
        copy of the maintained usage.  None -> caller full-packs.

        `overlay_only` (the what-if plan path): NEVER create, sync,
        rebuild, or grow the world — read the current template under
        the lock and overlay onto copies, so carried state stays
        bit-identical no matter how many plan solves interleave.  The
        batch then holds copies of every plane (taken under the lock),
        so a plan result fed into the world by another thread while
        this solve uploads and runs changes nothing it reads.
        Returns (pb, nodes) so callers never re-read self._world."""
        if any(a.property_limits for a in asks):
            return None          # host-side walk the resident path skips
        with self._world_lock:
            if self._world is None:
                if overlay_only:
                    return None
                if len(snapshot.nodes()) < self._resident_min_nodes:
                    return None
                self._world = _ResidentWorld(
                    self._tensorizer, self._store, snapshot, asks,
                    self._evict_e)
            world = self._world
            if not overlay_only:
                world.sync(snapshot)
            gp = max(self._pad(len(asks)), 1)
            kp = max(self._pad(sum(max(a.count, 1) for a in asks)), 1)
            pb = self._tensorizer.repack_asks(
                world.nodes, asks, world.template, gp=gp, kp=kp,
                drv_cache=world.drv_cache, row_cache=world.row_cache)
            if pb is None:
                if overlay_only:
                    return None
                # ask universe escape: grow the probes and rebuild once
                if not world.add_probes(asks):
                    return None
                world.rebuild(snapshot)
                pb = self._tensorizer.repack_asks(
                    world.nodes, asks, world.template, gp=gp, kp=kp,
                    drv_cache=world.drv_cache, row_cache=world.row_cache)
                if pb is None:
                    return None
            pb = _overlay_usage(world, pb, proposed_delta)
            if overlay_only:
                pb = _private_planes(pb)
            return pb, list(world.nodes)

    @staticmethod
    def _pad(n: int) -> int:
        return 1 << max(0, (n - 1).bit_length())

    def solve(self, nodes: Sequence[Node], asks: Sequence[PlacementAsk],
              allocs_by_node: Optional[Dict[str, list]] = None,
              by_dc: Optional[Dict[str, int]] = None, *,
              snapshot=None, proposed_delta=None,
              preempt: bool = False,
              _overlay_only: bool = False) -> SolveOutput:
        """`snapshot` (the state the scheduler read) lets a
        store-attached solver take the resident path; `proposed_delta`
        is (stopped allocs, sticky probes) of the plan being built: the
        only places the proposed usage differs from the store's.
        `preempt`: the scheduler found preemption enabled for this eval,
        so a batch with eviction planes runs the kernel's eviction pass
        and a placement may come back with `Placement.evicted`.
        `_overlay_only`: what-if plan mode (see PlanSolverView)."""
        return self.solve_async(nodes, asks, allocs_by_node, by_dc,
                                snapshot=snapshot,
                                proposed_delta=proposed_delta,
                                preempt=preempt,
                                _overlay_only=_overlay_only).wait()

    def solve_async(self, nodes: Sequence[Node],
                    asks: Sequence[PlacementAsk],
                    allocs_by_node: Optional[Dict[str, list]] = None,
                    by_dc: Optional[Dict[str, int]] = None, *,
                    snapshot=None, proposed_delta=None,
                    preempt: bool = False,
                    _overlay_only: bool = False) -> PendingSolve:
        """Dispatch phase of `solve`: pack and launch the solve without
        fetching the result; `wait()` on the returned PendingSolve
        fetches and runs the host fixup walk.  A solve routed to the
        host twin runs to completion here (numpy has no asynchrony), and
        `wait()` only runs the fixup."""
        t0 = time.perf_counter()
        if not asks:
            return PendingSolve(self, out=SolveOutput(placements=[]), t0=t0)
        pb = None
        sol_nodes = nodes
        if snapshot is not None and self.resident_active(snapshot):
            packed = self._resident_pack(snapshot, asks, proposed_delta,
                                         overlay_only=_overlay_only)
            if packed is not None:
                pb, sol_nodes = packed
        used_resident = pb is not None
        if pb is None:
            with self._world_lock:
                # the tensorizer's interners are shared with concurrent
                # plan-view solves: every pack through it is serialized
                pb = self._tensorizer.pack(nodes, asks, allocs_by_node)
        t_pack = time.perf_counter()
        res, backend = _run_kernel_routed(
            pb, self._device,
            max_waves=BROWNOUT_MAX_WAVES if self._degraded else 0,
            preempt=preempt, host_mode=self._host)
        pending = PendingSolve(self, pb=pb, nodes=sol_nodes,
                               asks=list(asks),
                               allocs_by_node=allocs_by_node, by_dc=by_dc,
                               used_resident=used_resident, res=res,
                               backend=backend, t0=t0)
        pending.t_dispatched = time.perf_counter()
        pending.pack_wall_s = t_pack - t0
        pending.dispatch_wall_s = pending.t_dispatched - t_pack
        return pending

    def _finish_solve(self, pb: PackedBatch, sol_nodes, asks, res,
                      used_resident: bool, allocs_by_node, by_dc,
                      _solve_t0: float, backend: str) -> SolveOutput:
        """Fetch-side half of `solve`: walks the host fixup over the
        fetched (numpy) result and builds the SolveOutput."""
        trace_attrs = solve_trace_attrs(pb, res, self._device,
                                        backend=backend)
        trace_attrs["kernel_wall_s"] = round(
            time.perf_counter() - _solve_t0, 6)
        trace_attrs["resident"] = used_resident
        if used_resident:
            world = self._world
            if world is not None:
                trace_attrs["world"] = dict(world.counters)
        choice, choice_ok, score = res.choice, res.choice_ok, res.score
        n_feasible, n_exhausted = res.n_feasible, res.n_exhausted
        dim_exhausted, feas = res.dim_exhausted, res.feas
        cons_filtered, unfinished = res.cons_filtered, res.unfinished
        evict = res.evict

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

        # with the eviction pass, replay commits in the kernel's wave
        # order: evictions make in-batch usage non-monotone, so an
        # ask-order replay can transiently exceed `avail` on a node
        # whose eviction the kernel sequenced earlier.  Without them
        # usage only grows and ask order is exact (commit_wave is None).
        order = list(range(pb.n_place))
        if res.commit_wave is not None:
            cwave = res.commit_wave
            order.sort(key=lambda p: (int(cwave[p]) if cwave[p] >= 0
                                      else np.iinfo(np.int32).max, p))
        by_p: Dict[int, Placement] = {}
        for p in order:
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
            if (evict is not None and evict[p].any()
                    and bool(choice_ok[p, 0])):
                # committed by the eviction pass: slot 0 is its one node;
                # check the discrete leftovers with the victims removed
                # and charge host_used the net usage (ask minus freed)
                placed = self._evict_commit(
                    int(choice[p, 0]), g, ask, pb, sol_nodes,
                    allocs_by_node, evict[p], host_used,
                    float(score[p, 0]), m)
                if placed is not None:
                    by_p[p] = placed
                    continue
                # ports or a stale victim view: a normal failure below,
                # and the scheduler's host preemption walk takes over
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
            by_p[p] = placed
        # in ask order whatever the replay order: the scheduler maps
        # placements back to its asks by position
        placements = [by_p[p] for p in range(pb.n_place)]

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

    def _evict_commit(self, ni: int, g: int, ask: PlacementAsk,
                      pb: PackedBatch, sol_nodes, allocs_by_node,
                      ev_row: np.ndarray, host_used: np.ndarray,
                      score: float, m: AllocMetric
                      ) -> Optional[Placement]:
        """Host fixup of a kernel-committed (place, evict) pair: map the
        victim-slot mask to alloc ids through the packed `ev_ids` rows,
        re-check capacity net of the freed usage, and run the discrete
        port/device assignment against the node minus its victims (fresh
        accounting: the shared caches still hold the victims'
        reservations).  None when that fails; the caller falls back to
        the host preemption walk."""
        if pb.ev_ids is None or ni >= len(pb.ev_ids):
            return None
        node = sol_nodes[ni]
        victim_ids = [pb.ev_ids[ni][e] for e in np.nonzero(ev_row)[0]
                      if e < len(pb.ev_ids[ni]) and pb.ev_ids[ni][e]]
        if not victim_ids:
            return None
        vset = set(victim_ids)
        proposed = (list(allocs_by_node.get(node.id, ()))
                    if allocs_by_node is not None else [])
        victims = [a for a in proposed if a.id in vset]
        if len(victims) != len(vset):
            # the allocs view and the packed planes disagree (a stale
            # world): refuse rather than evict the wrong alloc
            return None
        freed = np.zeros(NUM_R, np.float32)
        for a in victims:
            freed += alloc_usage_vector(a)
        ask_vec = pb.ask_res[g]
        if not np.all(host_used[ni] + ask_vec - freed <= pb.avail[ni]):
            return None
        remaining = [a for a in proposed if a.id not in vset]
        resources = self._host_commit(node, ni, ask, {}, {},
                                      {node.id: remaining})
        if resources is None:
            return None
        host_used[ni] += ask_vec - freed
        m.score_meta = [{"node_id": pb.node_ids[ni],
                         "normalized_score": score}]
        return Placement(ask_index=g, node=node, score=score,
                         metrics=m, resources=resources,
                         evicted=sorted(victim_ids))

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
        # `is not None`, not truthiness: bool() of a LazyAllocsView
        # takes its length, which materializes the whole cluster
        idx = net_cache.get(node_ix)
        if idx is None:
            idx = NetworkIndex()
            idx.set_node(node)
            if allocs_by_node is not None:
                idx.add_allocs(allocs_by_node.get(node.id, ()))
            net_cache[node_ix] = idx
        acct = dev_cache.get(node_ix)
        if acct is None:
            acct = DeviceAccounter(node)
            if allocs_by_node is not None:
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


class PlanSolverView:
    """Read-only facade over a worker's Solver for what-if planning
    (`/v1/job/:id/plan`): dry-run schedulers share the resident
    template — plan solves answer at steady-state speed instead of
    re-walking the cluster — but every solve goes through the
    copy-on-read overlay with `overlay_only` pinned, so the world is
    never created, synced, rebuilt, grown, or fed from a plan.  Carried
    usage stays bit-identical under any plan/solve interleaving
    (tests/test_torch_plan_overlay.py).  A plan solve on `cuda` runs
    the same kernels as the worker's."""

    def __init__(self, inner: Solver):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def resident_active(self, snapshot=None) -> bool:
        # only ride a world that already exists; a plan never builds one
        return self._inner._world is not None

    def note_plan_result(self, plan, result) -> None:
        return None              # dry-run plans never feed the world

    def set_degraded(self, degraded: bool) -> None:
        return None              # brownout belongs to the worker

    def solve(self, *args, **kw) -> SolveOutput:
        kw["_overlay_only"] = True
        return self._inner.solve(*args, **kw)


def solve_trace_attrs(pb: PackedBatch, res, device,
                      lane_counters: Optional[Dict] = None,
                      backend: str = "device") -> Dict:
    """Solve-span attributes of one kernel run (fetched result): the
    batch shape, the wave / rescore counters and the placements the
    eviction pass committed, and which route ran it (`backend`: "host"
    for the numpy twin, "device" for the device solve, "host_failover" /
    "host_quarantine" for the twin answering under the watchdog).
    `lane_counters` (a lane stream's `ResidentSolver.lane_counters()`)
    adds the lane width and the cross-lane revalidation's bounce
    accounting."""
    waves = int(res.n_waves)
    rescore = int(res.n_rescore)
    evicted = (int(np.asarray(res.evict).any(axis=1).sum())
               if res.evict is not None else 0)
    attrs = {"n_asks": int(pb.n_asks), "n_place": int(pb.n_place),
             "n_nodes": int(pb.n_real), "device": torch.device(device).type,
             "backend": backend,
             "waves": waves, "rescore_waves": rescore,
             "shortlist_waves": waves - rescore,
             "evict_commits": evicted,
             "unfinished": int(np.asarray(res.unfinished).sum())}
    if lane_counters is not None:
        attrs["lanes"] = int(lane_counters.get("lanes", 1))
        attrs["lane_chunks"] = int(lane_counters.get("chunks", 0))
        attrs["lane_bounced"] = int(lane_counters.get("bounced", 0))
        attrs["lane_committed"] = int(lane_counters.get("committed", 0))
        attrs["lane_bounce_rate"] = float(
            lane_counters.get("bounce_rate", 0.0))
    return attrs


def _run_kernel(pb: PackedBatch, device, max_waves: int = 0,
                preempt: bool = False, host_mode: str = "auto"):
    """The solve of a packed batch (`_run_kernel_routed` without the
    route): a SolveResult of numpy arrays from the host twin, of
    tensors on `device` (not fetched) from the device solve, or of numpy
    arrays when the watchdog answered (it fetches under its deadline)."""
    return _run_kernel_routed(pb, device, max_waves, preempt, host_mode)[0]


def _run_kernel_routed(pb: PackedBatch, device, max_waves: int = 0,
                       preempt: bool = False, host_mode: str = "auto"):
    """Run the solve for a packed batch; returns (result, backend).

    On the host twin ("host") when `host_mode` is "always", or "auto"
    and `prefer_host` holds for the batch's size (a SolveResult of numpy
    arrays), else launched on `device` ("device", not fetched).  On the
    device the fused wave kernel mode resolves from the shape ("auto":
    the CUDA kernel on a GPU, the torch scorer on the CPU), and batches
    without distinct_hosts groups drop the blocking planes, which turns
    on the shortlist-resident contention waves.  With `preempt`, a batch
    that carries eviction planes and no distinct_hosts group runs the
    eviction pass (cross-group blocking is invisible to it), with twice
    the default wave budget: eviction commits serialize one per node per
    wave.  Both routes get the same decision.

    The device route consults the chaos site "device_solve" just before
    `solve_kernel`.  With the solve watchdog armed (a chaos harness set
    `global_watchdog.deadline_s`) the device solve runs on the
    watchdog's thread, on the caller's CUDA stream, and fetches its
    result inside the deadline; an injected stall past the deadline or
    an injected poison is answered by the host twin over the batch's
    numpy planes ("host_failover", or "host_quarantine" while the
    device path backs off), which never touches the card.  Any other
    device error propagates.  `solve_kernel` writes into none of its
    arguments, so a device call abandoned at the deadline and finishing
    late leaves the batch and the planes a later solve reads as they
    were."""
    has_spread = bool((pb.sp_col[:, 0] >= 0).any())
    has_distinct = bool((pb.distinct >= 0).any())
    evicting = preempt and pb.ev_prio is not None and not has_distinct
    if evicting and max_waves == 0:
        max_waves = 2 * MAX_WAVES
    host_ev_kw = (dict(has_preempt=True, ev_res=pb.ev_res,
                       ev_prio=pb.ev_prio, ask_prio=pb.ask_prio)
                  if evicting else {})

    def _host():
        return host_solve_kernel(*_plane_args(pb), pb.n_place,
                                 has_spread=has_spread,
                                 max_waves=max_waves, **host_ev_kw)

    if host_mode == "always" or (host_mode == "auto" and prefer_host(
            pb.avail.shape[0], pb.n_asks, pb.n_place)):
        return _host(), "host"

    def _device(fetch: bool):
        inj = global_injections.get("device_solve")
        if inj is not None:
            inj.fire()
        ev_kw = {}
        if evicting:
            ev_res, ev_prio, ask_prio = _to_device(
                (pb.ev_res, pb.ev_prio, pb.ask_prio), device)
            ev_kw = dict(has_preempt=True, ev_res=ev_res, ev_prio=ev_prio,
                         ask_prio=ask_prio)
        res = solve_kernel(*_kernel_args(pb, device), has_spread=has_spread,
                           has_distinct=has_distinct, pallas_mode="auto",
                           max_waves=max_waves, **ev_kw)
        return _to_host(res) if fetch else res

    if global_watchdog.deadline_s is None:
        return _device(False), "device"
    dev = torch.device(device)
    # the watchdog's thread starts on the default stream: enter the
    # caller's, so the solve stays ordered after its earlier scatters
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def _on_thread():
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return _device(True)

    return global_watchdog.run(_on_thread, _host,
                               label=f"solve:{pb.n_asks}x{pb.n_real}")


def _to_device(planes, device):
    """Planes as tensors on `device` (numpy planes are copied there;
    tensors are moved)."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)
    return tuple(t(x) for x in planes)


def _plane_args(pb: PackedBatch):
    """The solve's plane arguments for `pb`, in `solve_kernel`'s order
    (the host twin takes them as they are)."""
    return (
        pb.avail, pb.reserved, pb.used0, pb.valid, pb.node_dc, pb.attr_rank,
        pb.ask_res, pb.ask_desired, pb.distinct, pb.dc_ok, pb.host_ok,
        pb.coll0,
        pb.penalty, pb.c_op, pb.c_col, pb.c_rank, pb.a_op, pb.a_col,
        pb.a_rank, pb.a_weight, pb.a_host, pb.sp_col, pb.sp_weight,
        pb.sp_targeted,
        pb.sp_desired, pb.sp_implicit, pb.sp_used0, pb.dev_cap, pb.dev_used0,
        pb.dev_ask, pb.p_ask)


def _kernel_args(pb: PackedBatch, device="cpu"):
    """The solve_kernel argument tuple for `pb`, planes as tensors on
    `device` (numpy planes are copied there; tensors are moved)."""
    return _to_device(_plane_args(pb), device) + (pb.n_place,)
