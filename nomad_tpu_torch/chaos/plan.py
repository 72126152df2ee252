"""Fault schedules: scripted or seeded, always deterministic.  The
counterpart of `nomad_tpu.chaos.plan`: the same (seed, horizon, rates,
targets) give the same plan in both packages, `wire()` for `wire()`.

A `FaultPlan` is an ordered list of `FaultEvent`s keyed on LOGICAL
steps — the driving loop's iteration counter, never wall time — so the
same plan replays the same storm bit-for-bit regardless of host speed.
`FaultPlan.generate` derives a schedule from (seed, horizon, rates)
with every fault paired to its recovery inside the horizon, and
non-overlapping per fault family (the shard/region state machines
refuse a second kill while degraded, so overlap would just be skipped
noise).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# fault kinds and their paired recovery kinds (None = self-clearing)
KIND_RECOVERY: Dict[str, Optional[str]] = {
    "shard_kill": "shard_recover",
    "region_kill": "region_recover",
    "gossip_flap": None,          # fail+join pair applied as one event
    "leader_stepdown": None,
    "stuck_solve": None,          # one-shot injection, watchdog clears
    "slow_solve": None,
    "poison_solve": None,
    "corrupt_delta": None,
}

FAULT_KINDS = tuple(KIND_RECOVERY)
RECOVERY_KINDS = tuple(k for k in KIND_RECOVERY.values() if k)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault (or recovery) at a logical step.

    `target` names the victim where the hook needs one (shard id,
    region name, member id); `args` carries kind-specific knobs
    (e.g. ``{"sleep_s": 2.0}`` for slow_solve, ``{"rows": 3}`` for
    corrupt_delta)."""
    step: int
    kind: str
    target: Optional[object] = None
    args: Dict = field(default_factory=dict)

    def wire(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "target": self.target, "args": dict(self.args)}

    @staticmethod
    def from_wire(d: dict) -> "FaultEvent":
        return FaultEvent(step=int(d["step"]), kind=d["kind"],
                          target=d.get("target"),
                          args=dict(d.get("args", {})))


class FaultPlan:
    """An immutable, step-ordered fault schedule."""

    def __init__(self, events: Sequence[FaultEvent],
                 seed: Optional[int] = None, horizon: int = 0):
        for ev in events:
            if ev.kind not in KIND_RECOVERY \
                    and ev.kind not in RECOVERY_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.kind,
                                          str(e.target))))
        self.seed = seed
        self.horizon = int(horizon) if horizon else (
            max((e.step for e in self.events), default=0) + 1)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def due(self, step: int) -> List[FaultEvent]:
        """Events scheduled exactly at `step` (the supervisor's tick
        granularity — callers advance step monotonically)."""
        return [e for e in self.events if e.step == step]

    def wire(self) -> dict:
        return {"seed": self.seed, "horizon": self.horizon,
                "events": [e.wire() for e in self.events]}

    @staticmethod
    def from_wire(d: dict) -> "FaultPlan":
        return FaultPlan([FaultEvent.from_wire(e)
                          for e in d.get("events", [])],
                         seed=d.get("seed"),
                         horizon=int(d.get("horizon", 0)))

    # ------------------------------------------------------- generator
    @staticmethod
    def generate(seed: int, horizon: int,
                 rates: Dict[str, float],
                 shards: Sequence[int] = (),
                 regions: Sequence[str] = (),
                 members: Sequence[str] = (),
                 min_dwell: int = 2,
                 max_dwell: int = 8) -> "FaultPlan":
        """Seeded schedule: for each kind in `rates`, expected
        ``rates[kind] * horizon`` occurrences uniformly over the
        horizon.  Paired kinds (shard/region kills) get a recovery
        after a dwell of [min_dwell, max_dwell] steps, clamped inside
        the horizon, and never overlap another kill of the same family
        (the degraded state machines are single-fault).  Identical
        (seed, horizon, rates, targets) inputs produce the identical
        plan."""
        if isinstance(shards, int):   # count → shard-id range
            shards = range(shards)
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for kind in sorted(rates):
            if kind not in KIND_RECOVERY:
                raise ValueError(f"unknown fault kind {kind!r}")
            n = max(0, round(rates[kind] * horizon))
            recovery = KIND_RECOVERY[kind]
            busy_until = -1      # same-family non-overlap watermark
            for _ in range(n):
                step = rng.randrange(max(1, horizon - max_dwell - 1))
                if recovery is not None and step <= busy_until:
                    step = busy_until + 1
                    if step >= horizon - min_dwell - 1:
                        break
                target: Optional[object] = None
                if kind == "shard_kill" and shards:
                    target = rng.choice(list(shards))
                elif kind == "region_kill" and regions:
                    target = rng.choice(list(regions))
                elif kind == "gossip_flap" and members:
                    target = rng.choice(list(members))
                args: Dict = {}
                if kind == "slow_solve":
                    args["sleep_s"] = round(rng.uniform(0.05, 0.3), 3)
                if kind == "corrupt_delta":
                    args["rows"] = rng.randrange(1, 4)
                events.append(FaultEvent(step, kind, target, args))
                if recovery is not None:
                    dwell = rng.randrange(min_dwell, max_dwell + 1)
                    rstep = min(step + dwell, horizon - 1)
                    events.append(FaultEvent(rstep, recovery, target))
                    busy_until = rstep
        return FaultPlan(events, seed=seed, horizon=horizon)
