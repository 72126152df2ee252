"""Serving tier: admission control + adaptive micro-batching.

Sits between the eval broker and the solver dispatch.  A closed-loop
driver (fixed batches, wait for the answer) hides what production
traffic is: open-loop job churn, where a fixed
`batch_size` dequeue either starves the device (tiny batches pay the
per-dispatch overhead over and over) or blows the tail (deep backlogs
capped at 8 evals per solve).  Three cooperating pieces:

  EwmaSolveModel     EWMA solve-time model per batch-size bucket, fed
                     by the worker after every single-lane batch and
                     by each fused round's device stage.
  BatchController    sizes each dequeue_batch from queue depth, the
                     oldest ready eval's age, and the model: close the
                     batch early when age + predicted solve time
                     approaches the SLO budget, grow toward max_batch
                     when the backlog is deep.
  AdmissionController bounded broker ingress with priority-aware
                     shedding (shed evals land in BlockedEvals.shed —
                     never dropped, readmitted on drain), per-namespace
                     token-bucket fairness, and brownout mode (degrade
                     the solve wave budget under sustained overload,
                     restore on drain).

All controller state is shared across worker threads and the leader's
eval-ingress path, so every class here owns its lock and keeps writes
under it.

The counterpart of `nomad_tpu.server.serving`, with the cross-region
admission tier (`RegionServingState`, `WanLatencyModel`,
`SpilloverRouter`); as `ServingTier`, the router takes its knobs from
`overrides` only (the reference's `NOMAD_TPU_*` environment layer joins
the agent configuration, ROADMAP.md Queue 1 item 15).  The four lane knobs
(`fused_lanes`, `max_lanes`, `lane_widen_below`, `lane_narrow_above`)
are the reference's, with its defaults; as there, the server builds no
lane former yet (item 21), so their one reader is `lane_controller()`,
the `LaneWidthController` they configure for the lane stream of
`solver.resident.ResidentSolver`.
"""
from __future__ import annotations

import random
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from ..structs import JOB_TYPE_CORE, Evaluation

#: default SLO budget for an eval's queue-age + solve time (50ms: the
#: open-loop bench's p99 acceptance bar)
DEFAULT_SLO_BUDGET_S = 0.05
#: adaptive ceiling — how far the controller may grow a micro-batch
DEFAULT_MAX_BATCH = 64
#: evals at or above this priority ride the bypass lane: dequeued work
#: is solved singly ahead of the fused bulk batch, and admission never
#: sheds them (interactive / operator-driven evals)
DEFAULT_BYPASS_PRIORITY = 80
#: bounded broker ingress (ready + waiting evals) before shedding
DEFAULT_MAX_PENDING = 4096
#: per-namespace token-bucket refill rate / burst (fairness is only
#: enforced above the fairness watermark — work-conserving under light
#: load, so a lone tenant may use the whole queue)
DEFAULT_NS_RATE = 512.0
DEFAULT_NS_BURST = 1024.0


class EwmaSolveModel:
    """EWMA of observed solve wall time per batch-size bucket.

    Buckets are pow2 (1, 2, 4, ... max): solve cost is dominated by the
    per-dispatch overhead plus a per-eval marginal term, both smooth in
    log-batch-size, so a handful of buckets with linear interpolation
    between them predicts well after a few dozen observations.
    """

    def __init__(self, alpha: float = 0.25,
                 default_fixed_s: float = 0.004,
                 default_per_eval_s: float = 0.0005):
        self._lock = threading.Lock()
        self._ewma: Dict[int, float] = {}     # bucket pow2 -> seconds
        self.alpha = alpha
        self.default_fixed_s = default_fixed_s
        self.default_per_eval_s = default_per_eval_s
        self._observations = 0

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, (max(n, 1) - 1).bit_length())

    def observe(self, n_evals: int, wall_s: float) -> None:
        if n_evals <= 0 or wall_s <= 0:
            return
        b = self._bucket(n_evals)
        with self._lock:
            prev = self._ewma.get(b)
            self._ewma[b] = (wall_s if prev is None
                             else prev + self.alpha * (wall_s - prev))
            self._observations += 1

    def predict(self, n_evals: int) -> float:
        """Predicted wall seconds to solve a batch of `n_evals`."""
        n = max(n_evals, 1)
        b = self._bucket(n)
        with self._lock:
            if not self._ewma:
                return self.default_fixed_s + n * self.default_per_eval_s
            v = self._ewma.get(b)
            if v is not None:
                return v
            # nearest observed buckets below/above, linear in n between
            lo = max((k for k in self._ewma if k < b), default=None)
            hi = min((k for k in self._ewma if k > b), default=None)
            if lo is not None and hi is not None:
                flo, fhi = self._ewma[lo], self._ewma[hi]
                t = (n - lo) / max(hi - lo, 1)
                return flo + t * (fhi - flo)
            if lo is not None:
                # extrapolate with the default marginal slope
                return self._ewma[lo] + (n - lo) * self.default_per_eval_s
            return max(self._ewma[hi]          # smaller than anything seen
                       - (hi - n) * self.default_per_eval_s, 1e-5)

    def observations(self) -> int:
        with self._lock:
            return self._observations

    def snapshot(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._ewma)


class BatchController:
    """Size the next dequeue_batch under the SLO budget.

    Close rule: pick the largest candidate batch size n (pow2 up to
    max_batch) such that the oldest ready eval's age plus the model's
    predicted solve time for n stays inside `slo_budget_s * margin`.
    The margin absorbs model error and the dequeue/ack overhead the
    model doesn't see.  When nothing fits — the oldest eval has already
    blown the budget — the controller flips to DRAIN mode and returns
    max_batch: the late eval is late under any decision, and maximum
    evals/s clears the backlog (and restores the SLO) soonest.  Deep
    backlogs grow the batch naturally: queue depth caps the candidate
    from below, the SLO budget from above.
    """

    def __init__(self, model: EwmaSolveModel,
                 slo_budget_s: float = DEFAULT_SLO_BUDGET_S,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 min_batch: int = 1, margin: float = 0.6):
        self._lock = threading.Lock()
        self.model = model
        self.slo_budget_s = slo_budget_s
        self.max_batch = max(int(max_batch), 1)
        self.min_batch = max(int(min_batch), 1)
        self.margin = margin
        self._last_target = self.min_batch

    def target_batch(self, ready: int, oldest_age_s: float) -> int:
        """Batch size for the next dequeue given queue state."""
        budget = self.slo_budget_s * self.margin - max(oldest_age_s, 0.0)
        best = None
        n = self.min_batch
        while n <= self.max_batch:
            if self.model.predict(n) <= budget:
                best = n
            n <<= 1
        if best is None:
            best = self.max_batch      # drain mode (see class note)
        # no point sizing past the backlog: dequeue_batch is
        # opportunistic, but a tight target keeps the controller's
        # decisions (and the recorded histogram) honest
        best = max(self.min_batch, min(best, max(ready, 1)))
        with self._lock:
            self._last_target = best
        return best

    def last_target(self) -> int:
        with self._lock:
            return self._last_target


class TokenBucket:
    """Classic token bucket; take() under the owner's call-site lock is
    fine, but the bucket carries its own lock so direct use is safe."""

    def __init__(self, rate: float, burst: float):
        self._lock = threading.Lock()
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = _time.monotonic()

    def take(self, n: float = 1.0) -> bool:
        now = _time.monotonic()
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp)
                               * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def level(self) -> float:
        with self._lock:
            return self._tokens


class AdmissionController:
    """Bounded ingress + fairness + brownout for the eval broker.

    `offer_ex` decides admit/shed for one arriving eval given the broker's
    current ready count; shed evals are the CALLER's responsibility to
    park in BlockedEvals.shed (never dropped).  `readmit_quota` hands
    drain capacity back: when the queue falls under the low watermark
    the caller pops that many shed evals back into the broker.
    Brownout trips after the queue has been above the high watermark
    for `brownout_after_s` straight, and restores on drain; while
    active, workers degrade the solve (reduced wave budget — leftovers
    follow the normal retry path) and the protect threshold is the only
    admission lane.
    """

    def __init__(self, max_pending: int = DEFAULT_MAX_PENDING,
                 protect_priority: int = DEFAULT_BYPASS_PRIORITY,
                 ns_rate: float = DEFAULT_NS_RATE,
                 ns_burst: float = DEFAULT_NS_BURST,
                 fairness_watermark: float = 0.5,
                 brownout_high: float = 0.75,
                 brownout_low: float = 0.25,
                 brownout_after_s: float = 1.0):
        self._lock = threading.Lock()
        self.max_pending = max(int(max_pending), 1)
        self.protect_priority = int(protect_priority)
        self.ns_rate = float(ns_rate)
        self.ns_burst = float(ns_burst)
        self.fairness_watermark = fairness_watermark
        self.brownout_high = brownout_high
        self.brownout_low = brownout_low
        self.brownout_after_s = brownout_after_s
        self._buckets: Dict[str, TokenBucket] = {}
        self._brownout = False
        self._over_since: Optional[float] = None
        self._offered = 0
        self._admitted = 0
        self._shed = 0
        self._shed_by_ns: Dict[str, int] = {}
        self._brownouts = 0

    # ------------------------------------------------------------ ingress
    def offer(self, ev: Evaluation, ready_count: int) -> bool:
        """True = admit (the caller enqueues), False = shed (the caller
        parks the eval in BlockedEvals.shed)."""
        return self.offer_ex(ev, ready_count)[0]

    def offer_ex(self, ev: Evaluation, ready_count: int
                 ) -> "Tuple[bool, str]":
        """Admit (the caller enqueues) or shed (the caller parks the
        eval in BlockedEvals.shed), with the shed cause — "max_pending",
        "brownout" or "fairness" when shedding, "" when admitted.  The cause lands on
        the eval's admit trace span (shed causality)."""
        now = _time.monotonic()
        protected = (ev.priority >= self.protect_priority
                     or ev.type == JOB_TYPE_CORE)
        with self._lock:
            # every offer is either admitted or shed — the invariant
            # harness checks offered == admitted + shed holds exactly
            self._offered += 1
            self._track_overload_locked(ready_count, now)
            if protected:
                self._admitted += 1
                return True, ""
            if ready_count >= self.max_pending:
                self._shed_locked(ev)
                return False, "max_pending"
            if self._brownout:
                self._shed_locked(ev)
                return False, "brownout"
            if ready_count >= self.fairness_watermark * self.max_pending:
                b = self._buckets.get(ev.namespace)
                if b is None:
                    b = TokenBucket(self.ns_rate, self.ns_burst)
                    self._buckets[ev.namespace] = b
                if not b.take():
                    self._shed_locked(ev)
                    return False, "fairness"
            self._admitted += 1
            return True, ""

    def _shed_locked(self, ev: Evaluation) -> None:
        self._shed += 1
        self._shed_by_ns[ev.namespace] = \
            self._shed_by_ns.get(ev.namespace, 0) + 1

    def _track_overload_locked(self, ready_count: int, now: float) -> None:
        if ready_count >= self.brownout_high * self.max_pending:
            if self._over_since is None:
                self._over_since = now
            elif (not self._brownout
                  and now - self._over_since >= self.brownout_after_s):
                self._brownout = True
                self._brownouts += 1
        else:
            self._over_since = None

    # -------------------------------------------------------------- drain
    def readmit_quota(self, ready_count: int, batch: int = 0) -> int:
        """How many shed evals the caller may pop back into the broker
        right now.  Non-zero only under the low watermark; also clears
        brownout there (restore on drain)."""
        with self._lock:
            self._track_overload_locked(ready_count, _time.monotonic())
            if ready_count > self.brownout_low * self.max_pending:
                return 0
            if self._brownout:
                self._brownout = False
            room = self.max_pending - ready_count
            return max(0, min(room, batch or DEFAULT_MAX_BATCH))

    def brownout_active(self) -> bool:
        with self._lock:
            return self._brownout

    def stats(self) -> dict:
        with self._lock:
            return {
                "offered": self._offered,
                "admitted": self._admitted,
                "shed": self._shed,
                "shed_by_namespace": dict(self._shed_by_ns),
                "brownout": self._brownout,
                "brownouts_entered": self._brownouts,
            }


class ServingTier:
    """Bundle of the serving-tier controllers plus their knobs, hung off
    the Server and shared by every worker.  `overrides` (agent config
    `server { serving { ... } }` stanza) win over the defaults below.
    The reference also reads each knob from a `NOMAD_TPU_*` environment
    variable; the port has no agent config loader yet (ROADMAP.md
    Queue 1), so its only configuration path is `overrides`."""

    #: knob -> default (an override is cast to the default's type)
    KNOBS = {
        "slo_budget_s": DEFAULT_SLO_BUDGET_S,
        "max_batch": DEFAULT_MAX_BATCH,
        "bypass_priority": DEFAULT_BYPASS_PRIORITY,
        "max_pending": DEFAULT_MAX_PENDING,
        "ns_rate": DEFAULT_NS_RATE,
        "ns_burst": DEFAULT_NS_BURST,
        "brownout_high": 0.75,
        "brownout_low": 0.25,
        "brownout_after_s": 1.0,
        "margin": 0.6,
        # SLO burn-rate accounting: the availability
        # objective over "batch met the p99 latency target", and the
        # SRE-workbook fast/slow window pair
        "slo_objective": 0.999,
        "slo_fast_window_s": 60.0,
        "slo_fast_burn": 14.0,
        "slo_slow_window_s": 600.0,
        "slo_slow_burn": 2.0,
        # scale-out plane: broker sharding, dequeue worker
        # count, raft group-commit width, cross-worker solve fusion
        "broker_shards": 1,
        "num_workers": 2,
        "group_commit": 8,
        "coordinator": 1,
        # double-buffered coordinator pipelining: dispatch
        # round b+1 while round b's device solve is in flight
        "pipeline": 1,
        # leader soft-pause fraction of workers; -1 = auto (0 once the
        # broker is sharded — pausing dequeue parallelism defeats shard
        # homing — else the reference's 3/4)
        "worker_pause_fraction": -1.0,
        # lane-parallel stream solve: the starting lane width (1 = the
        # serial stream), the width controller's pow2 ceiling, and its
        # widen / narrow bounce-rate thresholds (fractions of lane
        # placements the cross-lane revalidation bounced to a retry)
        "fused_lanes": 1,
        "max_lanes": 8,
        "lane_widen_below": 0.05,
        "lane_narrow_above": 0.25,
        # eviction-plane width of every worker's resident world (slots
        # per node for the in-kernel preemption pass; 0 = none, and
        # preemption takes the scheduler's host walk)
        "evict_e": 8,
    }

    def __init__(self, adaptive: bool = True,
                 overrides: Optional[dict] = None):
        o = overrides or {}
        k = {name: (type(default)(o[name]) if name in o else default)
             for name, default in self.KNOBS.items()}
        self.adaptive = bool(o.get("adaptive", adaptive))
        self.bypass_priority = k["bypass_priority"]
        self.slo_budget_s = k["slo_budget_s"]
        self.max_batch = k["max_batch"]
        self.broker_shards = max(1, k["broker_shards"])
        self.num_workers = max(1, k["num_workers"])
        self.group_commit = max(1, k["group_commit"])
        self.coordinator = bool(k["coordinator"])
        self.pipeline = bool(k["pipeline"])
        self.worker_pause_fraction = k["worker_pause_fraction"]
        self.fused_lanes = max(1, k["fused_lanes"])
        self.max_lanes = max(1, k["max_lanes"])
        self.lane_widen_below = k["lane_widen_below"]
        self.lane_narrow_above = k["lane_narrow_above"]
        self.evict_e = max(0, k["evict_e"])
        self.solve_model = EwmaSolveModel()
        self.batch_controller = BatchController(
            self.solve_model, slo_budget_s=k["slo_budget_s"],
            max_batch=k["max_batch"], margin=k["margin"])
        self.admission = AdmissionController(
            max_pending=k["max_pending"],
            protect_priority=k["bypass_priority"],
            ns_rate=k["ns_rate"], ns_burst=k["ns_burst"],
            brownout_high=k["brownout_high"],
            brownout_low=k["brownout_low"],
            brownout_after_s=k["brownout_after_s"])
        from ..telemetry.slo import SloBurnTracker
        from ..utils.metrics import global_metrics
        from ..utils.tracing import global_mesh_events
        self.burn = SloBurnTracker(
            objective=k["slo_objective"],
            fast_window_s=int(k["slo_fast_window_s"]),
            fast_burn=k["slo_fast_burn"],
            slow_window_s=int(k["slo_slow_window_s"]),
            slow_burn=k["slo_slow_burn"],
            events=global_mesh_events, metrics=global_metrics)

    def lane_controller(self):
        """The lane width controller these knobs configure: it starts
        at `fused_lanes`, steps by powers of two up to `max_lanes`, and
        is fed `ResidentSolver.lane_counters()` bounce rates."""
        from ..scheduler.fleet import LaneWidthController
        return LaneWidthController(max_width=self.max_lanes,
                                   start=self.fused_lanes,
                                   widen_below=self.lane_widen_below,
                                   narrow_above=self.lane_narrow_above)

    def note_device_solve(self, n_evals: int, device_s: float) -> None:
        """Feed the batch-sizing model the DEVICE-solve time of a fused
        round, not its end-to-end wall.  Under the pipelined coordinator
        a round's wall clock includes waiting out the previous round's
        device occupancy plus reconcile/pack/plan-build overlap — feeding
        that into `EwmaSolveModel` would make `predict()` roughly 2x the
        marginal cost of one more batch, and the `BatchController` close
        rule would over-drain (every candidate blows the inflated budget,
        flipping to DRAIN mode under moderate load).  The SLO burn
        accounting (`observe_batch`) still sees end-to-end wall — the
        eval's latency is what it is — only the *sizing* model narrows
        to the device stage."""
        self.solve_model.observe(n_evals, device_s)

    def observe_batch(self, n_evals: int, wall_s: float) -> None:
        """One solved batch's SLO verdict: every eval in a batch that
        lands inside the latency budget is `good`, a blown batch
        charges all its evals to the error budget (the batch IS the
        latency unit — its evals waited on the same dispatch)."""
        n = max(int(n_evals), 1)
        if wall_s <= self.slo_budget_s:
            self.burn.observe(good=n)
        else:
            self.burn.observe(bad=n)

    def stats(self) -> dict:
        return {
            "adaptive": self.adaptive,
            "slo_budget_s": self.slo_budget_s,
            "max_batch": self.max_batch,
            "broker_shards": self.broker_shards,
            "num_workers": self.num_workers,
            "group_commit": self.group_commit,
            "coordinator": self.coordinator,
            "pipeline": self.pipeline,
            "fused_lanes": self.fused_lanes,
            "max_lanes": self.max_lanes,
            "last_target_batch": self.batch_controller.last_target(),
            "model_observations": self.solve_model.observations(),
            "admission": self.admission.stats(),
            "slo": self.burn.status(),
        }


# ===================================================================
# Cross-region admission spillover
# ===================================================================

#: spillover SLO margin: a region "meets SLO" when its predicted
#: backlog-clear time fits inside slo_budget_s * margin
DEFAULT_SPILL_MARGIN = 0.8
#: relative cost of placing one eval in a region (WAN egress, energy,
#: $/chip-hour); the router prefers cheaper regions at equal health
DEFAULT_REGION_COST = 1.0


class RegionServingState:
    """One region's serving-tier view for the spillover router: its
    own EWMA solve model (regions differ in mesh width and load) and
    admission controller, plus the last reported ready-queue depth."""

    def __init__(self, name: str, cost: float = DEFAULT_REGION_COST,
                 model: Optional[EwmaSolveModel] = None,
                 admission: Optional[AdmissionController] = None):
        self.name = str(name)
        self.cost = float(cost)
        self.model = model if model is not None else EwmaSolveModel()
        self.admission = (admission if admission is not None
                          else AdmissionController())
        self._lock = threading.Lock()
        self._ready = 0
        self.live = True

    def note_ready(self, n: int) -> None:
        with self._lock:
            self._ready = max(int(n), 0)

    def ready(self) -> int:
        with self._lock:
            return self._ready

    def browned_out(self) -> bool:
        """Brownout watermark view: the controller's latched state OR
        the instantaneous high watermark (the router must not keep
        feeding a region in the `brownout_after_s` grace window)."""
        a = self.admission
        return (a.brownout_active()
                or self.ready() >= a.brownout_high * a.max_pending)

    def meets_slo(self, n_evals: int, budget_s: float) -> bool:
        return self.model.predict(self.ready() + max(n_evals, 1)) \
            <= budget_s


class WanLatencyModel:
    """Modeled per-region-pair WAN round-trip latency, seeded jitter.

    Cross-region placement in the real federation pays a WAN RPC
    before the eval lands in the remote broker; the router's SLO math
    and a multi-region simulation should pay that cost too, or
    spillover looks free and the router over-spills.  Latency is
    symmetric per unordered pair, zero within a region, and jittered
    from a seeded RNG so two runs with the same seed see identical
    delay sequences (the chaos plane's determinism rule: no wall
    clocks, no unseeded randomness).

    `expected()` is the jitter-free base — what the ROUTING decision
    subtracts from the SLO budget when weighing a remote region.
    `sample()` draws one jittered delay — what the SIMULATION adds to
    an eval's completion time after routing."""

    def __init__(self, default_s: float = 0.08, jitter: float = 0.25,
                 seed: int = 0x3A21):
        self.default_s = float(default_s)
        self.jitter = float(jitter)
        self._pairs: Dict[frozenset, float] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._samples = 0

    def set_pair(self, a: str, b: str, base_s: float) -> None:
        with self._lock:
            self._pairs[frozenset((str(a), str(b)))] = float(base_s)

    def expected(self, src: Optional[str], dst: str) -> float:
        """Jitter-free base latency for routing math (0 in-region or
        when the source region is unknown — no WAN hop to model)."""
        if not src or src == dst:
            return 0.0
        with self._lock:
            return self._pairs.get(frozenset((str(src), str(dst))),
                                   self.default_s)

    def sample(self, src: Optional[str], dst: str) -> float:
        """One jittered delay draw for the latency simulation."""
        base = self.expected(src, dst)
        if base <= 0.0:
            return 0.0
        with self._lock:
            self._samples += 1
            return base * (1.0 + self.jitter
                           * (2.0 * self._rng.random() - 1.0))

    def stats(self) -> dict:
        with self._lock:
            return {"default_s": self.default_s, "jitter": self.jitter,
                    "pairs": {"|".join(sorted(k)): v
                              for k, v in self._pairs.items()},
                    "samples": self._samples}


class SpilloverRouter:
    """Admission-tier cross-region spillover.

    Stock Nomad's region forwarding (nomad/rpc.go `forward`) ships an
    RPC to the job's HOME region and stops there — a browned-out home
    region just queues deeper.  This router places NEW work across the
    federation: the home region keeps the job while it is healthy and
    meets SLO (per-region EWMA solve model over the reported backlog),
    overflow goes to the cheapest sibling region meeting SLO when the
    home brownout watermark trips, and only when EVERY live region is
    browned out does the eval land in the router's shed lane — parked,
    never dropped, readmitted by `drain_shed` once any region drains.

    Region membership is gossip-driven: plug `on_join` / `on_fail`
    into the serf WAN pool (membership.gossip.GossipAgent); they feed
    the optional RegionDirectory (the federation membership table) and
    flip region liveness here.  Knobs follow the ServingTier pattern:
    `overrides` win over the defaults (no environment)."""

    #: knob -> default (an override is cast to the default's type)
    KNOBS = {
        "slo_budget_s": DEFAULT_SLO_BUDGET_S,
        "spill_margin": DEFAULT_SPILL_MARGIN,
        "region_cost": DEFAULT_REGION_COST,
        "max_pending": DEFAULT_MAX_PENDING,
    }

    def __init__(self, regions: Optional[Dict[str, float]] = None,
                 overrides: Optional[dict] = None,
                 directory=None, event_log=None, wan_model=None):
        o = overrides or {}
        k = {name: (type(default)(o[name]) if name in o else default)
             for name, default in self.KNOBS.items()}
        self.slo_budget_s = k["slo_budget_s"]
        self.spill_margin = k["spill_margin"]
        self.default_cost = k["region_cost"]
        self.max_pending = k["max_pending"]
        self.directory = directory
        #: optional WanLatencyModel — when set, remote candidates are
        #: judged against the SLO budget minus the modeled WAN hop, and
        #: wan_delay() lets simulations charge the jittered transfer
        self.wan_model = wan_model
        if event_log is None:
            from ..utils.tracing import global_mesh_events
            event_log = global_mesh_events
        self.event_log = event_log
        self._lock = threading.Lock()
        self._regions: Dict[str, RegionServingState] = {}
        self._shed_lane: List = []
        self._counts = {"home": 0, "cheapest": 0, "spillover": 0,
                        "slo_miss": 0, "shed": 0, "readmitted": 0}
        for name, cost in (regions or {}).items():
            self.add_region(name, cost)

    # ------------------------------------------------------ membership
    def add_region(self, name: str,
                   cost: Optional[float] = None) -> RegionServingState:
        with self._lock:
            rs = self._regions.get(name)
            if rs is None:
                rs = RegionServingState(
                    name, self.default_cost if cost is None else cost,
                    admission=AdmissionController(
                        max_pending=self.max_pending))
                self._regions[name] = rs
            elif cost is not None:
                rs.cost = float(cost)
            rs.live = True
            return rs

    def region(self, name: str) -> RegionServingState:
        with self._lock:
            return self._regions[name]

    def regions(self) -> List[str]:
        with self._lock:
            return sorted(r for r, rs in self._regions.items()
                          if rs.live)

    def on_join(self, member) -> None:
        """Serf WAN-gossip join: a member of region X comes up — the
        region (re)enters the routing table."""
        region = getattr(member, "region", None) or "global"
        if self.directory is not None:
            self.directory.on_join(member)
        self.add_region(str(region))

    def on_fail(self, member) -> None:
        """Serf WAN-gossip fail: when a region's LAST member dies the
        region leaves the routing table (individual member loss keeps
        it live — the mesh supervisor handles shard recovery)."""
        region = str(getattr(member, "region", None) or "global")
        if self.directory is not None:
            self.directory.on_fail(member)
            gone = region not in self.directory.regions()
        else:
            gone = True                # no membership view: fail fast
        if gone:
            with self._lock:
                rs = self._regions.get(region)
                if rs is not None:
                    rs.live = False

    # --------------------------------------------------------- routing
    def route(self, ev, home: Optional[str] = None,
              n_evals: int = 1) -> Tuple[Optional[str], str]:
        """Pick the region for one arriving eval.  Returns
        (region_name, cause); cause is "home" (healthy home region),
        "cheapest" (no home given), "spillover" (home browned out or
        past SLO — cheapest sibling meeting SLO), "slo_miss" (no
        region meets SLO but one is un-browned: admit late rather
        than park), or "shed" with region None (every live region
        browned out: the eval is in the shed lane — never dropped)."""
        budget = self.slo_budget_s * self.spill_margin
        with self._lock:
            live = sorted((rs for rs in self._regions.values()
                           if rs.live),
                          key=lambda rs: (rs.cost, rs.name))
        if not live:
            with self._lock:
                self._shed_lane.append(ev)
                self._counts["shed"] += 1
            return None, "shed"
        home_rs = next((rs for rs in live if rs.name == home), None)
        if home_rs is not None and not home_rs.browned_out() \
                and home_rs.meets_slo(n_evals, budget):
            return self._picked(home_rs, "home")
        # remote candidates must clear SLO with the modeled WAN hop
        # already spent — otherwise spillover looks free and a distant
        # region wins over a slightly-loaded near one
        fits = [rs for rs in live if not rs.browned_out()
                and rs.meets_slo(n_evals,
                                 budget - self._wan_s(home, rs.name))]
        if fits:
            cause = "cheapest" if home_rs is None else "spillover"
            return self._picked(fits[0], cause)
        unbrowned = [rs for rs in live if not rs.browned_out()]
        if unbrowned:
            # admit late at the least-loaded un-browned region: an
            # SLO miss beats parking the eval behind a drain
            pick = min(unbrowned,
                       key=lambda rs: (rs.model.predict(
                           rs.ready() + max(n_evals, 1)), rs.cost,
                           rs.name))
            return self._picked(pick, "slo_miss")
        with self._lock:
            self._shed_lane.append(ev)
            self._counts["shed"] += 1
        self.event_log.record("region.shed",
                              home=home or "", depth=len(
                                  self._shed_lane))
        return None, "shed"

    def _wan_s(self, home: Optional[str], region: str) -> float:
        if self.wan_model is None:
            return 0.0
        return self.wan_model.expected(home, region)

    def wan_delay(self, src: Optional[str], dst: str) -> float:
        """One jittered WAN transfer-delay draw for the chosen route
        (0 without a model or for in-region placement) — charged by
        the latency simulation, not by routing."""
        if self.wan_model is None:
            return 0.0
        return self.wan_model.sample(src, dst)

    def _picked(self, rs: RegionServingState,
                cause: str) -> Tuple[str, str]:
        with self._lock:
            self._counts[cause] = self._counts.get(cause, 0) + 1
        if cause == "spillover":
            self.event_log.record("region.spill", region=rs.name)
        return rs.name, cause

    # ----------------------------------------------------------- drain
    def drain_shed(self, max_n: int = DEFAULT_MAX_BATCH
                   ) -> List[Tuple[object, str]]:
        """Readmit parked evals once any region has drained: returns
        up to max_n (eval, region) pairs routed to un-browned regions
        meeting SLO (the shed lane keeps the rest — still never
        dropped)."""
        out: List[Tuple[object, str]] = []
        budget = self.slo_budget_s * self.spill_margin
        while len(out) < max_n:
            with self._lock:
                if not self._shed_lane:
                    break
                live = sorted(
                    (rs for rs in self._regions.values()
                     if rs.live and not rs.browned_out()),
                    key=lambda rs: (rs.cost, rs.name))
                fits = [rs for rs in live
                        if rs.meets_slo(1, budget)] or live
                if not fits:
                    break
                ev = self._shed_lane.pop(0)
                self._counts["readmitted"] += 1
            out.append((ev, fits[0].name))
        return out

    def shed_depth(self) -> int:
        with self._lock:
            return len(self._shed_lane)

    def note_solve(self, region: str, n_evals: int,
                   wall_s: float) -> None:
        """Feed one region's observed solve into its EWMA model."""
        self._regions[region].model.observe(n_evals, wall_s)

    def stats(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            shed_depth = len(self._shed_lane)
            regions = {
                name: {"cost": rs.cost, "live": rs.live,
                       "ready": rs.ready(),
                       "browned_out": rs.browned_out(),
                       "model_observations":
                           rs.model.observations()}
                for name, rs in self._regions.items()}
        out = {"slo_budget_s": self.slo_budget_s,
               "spill_margin": self.spill_margin,
               "routed": counts, "shed_lane_depth": shed_depth,
               "regions": regions}
        if self.wan_model is not None:
            out["wan"] = self.wan_model.stats()
        return out
