"""ChaosSupervisor: replays a FaultPlan through the system's own
recovery hooks, one logical step at a time.  The counterpart of
`nomad_tpu.chaos.supervisor`: the hooks are the port's elastic and
cross-region solvers, its mesh supervisor and its raft node.

The supervisor owns NO clock and NO thread — the driving loop (a test,
or chip_smoke.py's chaos phase) calls ``advance(step)`` at its own cadence
and the supervisor applies every event due at that step.  Faults that
the target's state machine refuses (a second shard kill while
degraded) are recorded as ``chaos.skipped`` instead of raising, so a
generated plan survives contact with guarded transitions.

Targets are all optional; an event whose target surface is absent is
skipped-and-recorded, which lets one plan drive differently shaped
harnesses (single-region tests vs the federated storm).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .injection import InjectionRegistry, global_injections
from .plan import FaultEvent, FaultPlan


class ChaosSupervisor:
    def __init__(self, plan: FaultPlan,
                 elastic=None,            # ElasticShardedResidentSolver
                 federated=None,          # CrossRegionResidentSolver
                 mesh_supervisor=None,    # ElasticMeshSupervisor
                 raft=None,               # RaftNode (leader step-down)
                 injections: Optional[InjectionRegistry] = None,
                 event_log=None,
                 watchdog_deadline_s: float = 0.5):
        if event_log is None:
            from ..utils.tracing import global_mesh_events
            event_log = global_mesh_events
        self.plan = plan
        self.elastic = elastic
        self.federated = federated
        self.mesh_supervisor = mesh_supervisor
        self.raft = raft
        self.injections = (global_injections if injections is None
                           else injections)
        self.event_log = event_log
        self.watchdog_deadline_s = watchdog_deadline_s
        self.applied: List[FaultEvent] = []
        self.skipped: List[FaultEvent] = []
        self.counters: Dict[str, int] = {}
        self._step = -1

    # ---------------------------------------------------------- drive
    def advance(self, step: int) -> List[FaultEvent]:
        """Apply every plan event due at `step` (steps must advance
        monotonically); returns the events actually applied."""
        if step <= self._step:
            return []
        applied = []
        for ev in self.plan.due(step):
            if self._apply(ev):
                applied.append(ev)
                self.applied.append(ev)
                self.counters[ev.kind] = \
                    self.counters.get(ev.kind, 0) + 1
            else:
                self.skipped.append(ev)
                self.event_log.record("chaos.skipped", fault=ev.kind,
                                      step=step, target=str(ev.target))
        self._step = step
        return applied

    def run_to(self, step: int) -> List[FaultEvent]:
        """Advance through every intermediate step (catch-up after a
        driving loop that batches several logical steps per tick)."""
        out = []
        for s in range(self._step + 1, step + 1):
            out.extend(self.advance(s))
        return out

    @property
    def done(self) -> bool:
        return self._step >= self.plan.horizon - 1

    # ---------------------------------------------------------- apply
    def _apply(self, ev: FaultEvent) -> bool:
        fn = getattr(self, f"_ev_{ev.kind}", None)
        if fn is None:
            return False
        ok = fn(ev)
        if ok:
            self.event_log.record(f"chaos.{ev.kind}", step=ev.step,
                                  target=str(ev.target), **ev.args)
        return ok

    def _ev_shard_kill(self, ev: FaultEvent) -> bool:
        sol = self.elastic or (self.federated.solver
                               if self.federated else None)
        if sol is None or sol.mesh_state != "healthy":
            return False
        shard = int(ev.target or 0) % sol.n_shards
        sol.fail_shard(shard)
        return True

    def _ev_shard_recover(self, ev: FaultEvent) -> bool:
        sol = self.elastic or (self.federated.solver
                               if self.federated else None)
        if sol is None or sol.mesh_state != "degraded":
            return False
        sol.recover()
        return True

    def _ev_region_kill(self, ev: FaultEvent) -> bool:
        fed = self.federated
        if fed is None or fed.mesh_state != "healthy":
            return False
        region = ev.target if ev.target is not None \
            else fed.region_names[0]
        fed.fail_region_shard(region,
                              int(ev.args.get("shard_in_region", 0)))
        return True

    def _ev_region_recover(self, ev: FaultEvent) -> bool:
        fed = self.federated
        if fed is None or fed.mesh_state != "degraded":
            return False
        fed.recover_region()
        return True

    def _ev_gossip_flap(self, ev: FaultEvent) -> bool:
        sup = self.mesh_supervisor
        if sup is None or ev.target is None:
            return False
        # a flap is the serf fail->rejoin pair delivered back to back:
        # the supervisor state machine fails the member's shard and
        # immediately rebuilds on the rejoin — the recovery path the
        # real gossip plane would drive over suspicion_timeout
        sup.on_fail(ev.target)
        sup.on_join(ev.target)
        return True

    def _ev_leader_stepdown(self, ev: FaultEvent) -> bool:
        if self.raft is None:
            return False
        return bool(self.raft.step_down())

    def _ev_stuck_solve(self, ev: FaultEvent) -> bool:
        # a sleep comfortably past the watchdog deadline: the device
        # dispatch wedges, the watchdog fails over to the host twin
        stall = float(ev.args.get("sleep_s",
                                  4.0 * self.watchdog_deadline_s))
        self.injections.arm("device_solve", "sleep",
                            budget=int(ev.args.get("budget", 1)),
                            sleep_s=stall)
        return True

    def _ev_slow_solve(self, ev: FaultEvent) -> bool:
        self.injections.arm("device_solve", "sleep",
                            budget=int(ev.args.get("budget", 1)),
                            sleep_s=float(ev.args.get("sleep_s", 0.05)))
        return True

    def _ev_poison_solve(self, ev: FaultEvent) -> bool:
        self.injections.arm("device_solve", "raise",
                            budget=int(ev.args.get("budget", 1)))
        return True

    def _ev_corrupt_delta(self, ev: FaultEvent) -> bool:
        self.injections.arm("delta_row", "mutate",
                            budget=int(ev.args.get("budget", 1)),
                            rows=int(ev.args.get("rows", 1)))
        return True

    # ---------------------------------------------------------- report
    def report(self) -> dict:
        return {"seed": self.plan.seed, "horizon": self.plan.horizon,
                "planned": len(self.plan),
                "applied": len(self.applied),
                "skipped": len(self.skipped),
                "by_kind": dict(sorted(self.counters.items()))}
