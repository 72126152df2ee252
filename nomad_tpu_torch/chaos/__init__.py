"""Chaos plane: seeded, fully deterministic fault injection plus a
continuously-running invariant harness.  The counterpart of
`nomad_tpu.chaos`.

A `FaultPlan` is a schedule of `FaultEvent`s keyed on LOGICAL steps
(never wall time) — scripted explicitly or generated from (seed,
horizon, rates) — and a `ChaosSupervisor` replays it through the
recovery hooks the system already owns:

  * shard kill / recover        (ElasticShardedResidentSolver)
  * region kill / recover       (CrossRegionResidentSolver)
  * gossip membership flaps     (ElasticMeshSupervisor on_fail /
                                 on_join)
  * leader step-down            (RaftNode)
  * slow / stuck / poisoned device solves and delta-row corruption
                                (the `global_injections` site registry,
                                 consulted by solver code)

While a storm runs, an `InvariantHarness` checks end-to-end properties
continuously: no eval lost through broker/shed lanes, no
double-placement, per-node usage conservation bit-identical to a
from-scratch recompute, shed/admission accounting balanced, and the
card-resident planes checksum-verified against the raft-fed template.

Every applied event lands in the mesh event log (`chaos.*` kinds) so a
storm is auditable after the fact; the same seed replays the same
storm.  A stuck or poisoned device solve is answered by the solve
watchdog (`solver/watchdog.py`), which is off unless a chaos harness
sets its deadline, and which fails over only for such an injected
fault.
"""
from .plan import FaultEvent, FaultPlan
from .injection import (ChaosInjected, Injection, InjectionRegistry,
                        global_injections)
from .supervisor import ChaosSupervisor
from .invariants import InvariantHarness, InvariantViolation

__all__ = ["FaultEvent", "FaultPlan", "ChaosInjected", "Injection",
           "InjectionRegistry", "global_injections", "ChaosSupervisor",
           "InvariantHarness", "InvariantViolation"]
