"""The port's chaos plane and solve watchdog against the JAX package's,
on the CPU, after tests/test_chaos.py.

Each mirrored case runs on both packages (`pkg` = "ref" / "port") and
must reach the same outcome: the fault schedule is a pure value (the
same seed gives the same `FaultPlan.wire()` in both packages), the
injection registry is an atomic budget claim, the watchdog fails over
to the host twin with placement-identical answers, quarantines the
device behind capped jittered backoff and recovers on a clean probe (the
clock injected where the test steps it), the supervisor drives the
elastic mesh's state machines, and the invariant harness catches lost
evals, double placements, usage drift and corrupt delta rows.  The rpc
retry loop is driven through the "rpc_transport" site.

The port's watchdog is narrower than the reference's, on purpose: it
fails over only for an injected fault (a stall past the deadline, or
`ChaosInjected`), and a real device error propagates; it is off by
default and reads no environment.  The port-only cases pin that, the
`backend` a failed-over solve reports, and a device call abandoned at
the deadline that finishes late without touching the next solve.

Both packages run with `pallas="off"` where a solver takes it, on the
conftest's eight virtual CPU devices (the reference's mesh) and on
shards that all sit on `cpu` (the port's).
"""
import random
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import chaos as ref_chaos
from nomad_tpu import mock as ref_mock
from nomad_tpu.chaos import injection as ref_injection
from nomad_tpu.parallel import sharded as ref_sh
from nomad_tpu.rpc import RpcClient as RefRpcClient
from nomad_tpu.rpc import RpcServer as RefRpcServer
from nomad_tpu.server import eval_broker as ref_broker
from nomad_tpu.server import serving as ref_serving
from nomad_tpu.solver import resident as ref_resident
from nomad_tpu.solver import solve as ref_solve
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.solver import watchdog as ref_watchdog
from nomad_tpu.utils import metrics as ref_metrics
from nomad_tpu.utils import tracing as ref_tracing
from nomad_tpu_torch import chaos as port_chaos
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.chaos import injection as port_injection
from nomad_tpu_torch.parallel import sharded as port_sh
from nomad_tpu_torch.rpc import RpcClient, RpcServer
from nomad_tpu_torch.server import eval_broker as port_broker
from nomad_tpu_torch.server import serving as port_serving
from nomad_tpu_torch.solver import resident as port_resident
from nomad_tpu_torch.solver import solve as port_solve
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.solver import watchdog as port_watchdog
from nomad_tpu_torch.utils import metrics as port_metrics
from nomad_tpu_torch.utils import tracing as port_tracing
from tests.test_torch_resident import ENV_KNOBS

REPO = __file__.rsplit("/tests/", 1)[0]
CPU = [torch.device("cpu")]


class Pkg:
    """One package's chaos plane, watchdog and the surfaces they drive."""

    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)

    def __repr__(self):
        return self.name


PKGS = {
    "ref": Pkg("ref", mock=ref_mock, chaos=ref_chaos,
               injection=ref_injection, sh=ref_sh, broker=ref_broker,
               serving=ref_serving, resident=ref_resident,
               solve=ref_solve, tz=ref_tz, watchdog=ref_watchdog,
               metrics=ref_metrics, tracing=ref_tracing,
               RpcClient=RefRpcClient, RpcServer=RefRpcServer),
    "port": Pkg("port", mock=port_mock, chaos=port_chaos,
                injection=port_injection, sh=port_sh, broker=port_broker,
                serving=port_serving, resident=port_resident,
                solve=port_solve, tz=port_tz, watchdog=port_watchdog,
                metrics=port_metrics, tracing=port_tracing,
                RpcClient=RpcClient, RpcServer=RpcServer),
}
PORT = PKGS["port"]


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def _reset_globals():
    for P in PKGS.values():
        P.injection.global_injections.reset()
        wd = P.watchdog.global_watchdog
        wd.deadline_s = None
        wd.quarantined = False
        wd._failures = 0
        wd._probing = False
        wd._probe_at = 0.0
        log = P.tracing.global_mesh_events
        with log._lock:
            log._events.clear()


@pytest.fixture(autouse=True)
def _clean_chaos_globals(monkeypatch):
    """The injection registries, watchdogs and mesh event logs are
    process-wide (the production consult sites read the globals): each
    test starts and leaves them pristine, in both packages."""
    for k in ENV_KNOBS + ("NOMAD_TPU_SOLVE_DEADLINE_S",):
        monkeypatch.delenv(k, raising=False)
    _reset_globals()
    yield
    _reset_globals()


class FakeMember:
    def __init__(self, mid):
        self.id = mid

    def __repr__(self):
        return f"FakeMember({self.id})"


STORM_RATES = {"shard_kill": 0.10, "gossip_flap": 0.05,
               "stuck_solve": 0.05, "slow_solve": 0.05,
               "corrupt_delta": 0.05}
#: bench.py run_chaos's rates (chip_smoke.py phase 14's storm)
BENCH_RATES = {"shard_kill": 0.06, "region_kill": 0.06,
               "gossip_flap": 0.08, "stuck_solve": 0.05,
               "slow_solve": 0.08, "poison_solve": 0.05}


# ------------------------------------------------------------ builders
def make_node(P, i, cpu=4000):
    nd = P.mock.node(id=f"node-{i:03d}", name=f"node-{i}",
                     datacenter=f"dc{i % 2}")
    nd.attributes["rack"] = f"r{i % 4}"
    nd.node_resources.cpu = cpu
    nd.node_resources.memory_mb = 16384
    nd.node_resources.disk_mb = 100_000
    nd.compute_class()
    return nd


def make_ask(P, count=3, cpu=500, jid="job-a"):
    job = P.mock.job()
    job.id = job.name = jid
    job.datacenters = ["dc0", "dc1"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = cpu
    return P.tz.PlacementAsk(job=job, tg=tg, count=count)


def make_alloc(P, aid, cpu=300, mem=256):
    a = P.mock.alloc()
    a.id = aid
    tr = a.allocated_resources.tasks["web"]
    tr.cpu = cpu
    tr.memory_mb = mem
    tr.networks = []
    a.allocated_resources.shared.networks = []
    a.allocated_resources.shared.disk_mb = 100
    return a


def resident_solver(P, nodes, asks):
    kw = dict(gp=4, kp=16, pallas="off")
    if P is PORT:
        kw["device"] = "cpu"
    return P.resident.ResidentSolver(nodes, asks, **kw)


def elastic_solver(P, nodes, asks):
    """An elastic mesh of 4 hosts x 2 shards."""
    devices = {"devices": CPU} if P is PORT else {}
    return P.sh.ElasticShardedResidentSolver(
        nodes, asks, gp=4, kp=16, pallas="off",
        mesh=P.sh.make_two_tier_mesh(4, 8, **devices))


def run_kernel(P, pb):
    """The device route's answer, fetched: (choice, choice_ok, score)."""
    if P is PORT:
        res = P.solve._to_host(P.solve._run_kernel(pb, "cpu",
                                                   host_mode="never"))
    else:
        res = P.solve._run_kernel(pb, host_mode="never")
    return tuple(np.asarray(getattr(res, f))
                 for f in ("choice", "choice_ok", "score"))


def assert_answer_equal(a, b):
    """assert_same's placement half: ok flags and choices equal, scores
    within rtol 2e-5 where ok."""
    (ca, oa, sa), (cb, ob, sb) = a, b
    np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(np.where(oa, ca, -1), np.where(ob, cb, -1))
    np.testing.assert_allclose(np.where(oa, sa, 0.0), np.where(ob, sb, 0.0),
                               rtol=2e-5, atol=2e-5)


def counter(P, key):
    return P.metrics.global_metrics.dump()["counters"].get(key, 0)


def wd_threads():
    return [t for t in threading.enumerate()
            if t.name == "solve-watchdog" and t.is_alive()]


# ------------------------------------------------------------------
# FaultPlan: deterministic schedules
# ------------------------------------------------------------------
def test_fault_plan_generate_deterministic(pkg):
    mk = lambda seed: pkg.chaos.FaultPlan.generate(  # noqa: E731
        seed, 60, STORM_RATES, shards=4, members=["m1", "m2"])
    a, b = mk(7), mk(7)
    assert a.events == b.events and len(a) > 0
    assert mk(7).wire() == mk(7).wire()
    assert mk(7).events != mk(8).events


@pytest.mark.parametrize("seed,horizon,rates", [
    (7, 60, STORM_RATES), (3, 40, STORM_RATES), (14, 36, BENCH_RATES),
    (11, 80, {"shard_kill": 0.1, "corrupt_delta": 0.2,
              "leader_stepdown": 0.05})])
def test_fault_plan_same_in_both_packages(seed, horizon, rates):
    """The same (seed, horizon, rates, targets) give the identical plan
    in both packages, compared by `wire()`."""
    targets = dict(shards=8, regions=["region0", "region1", "region2",
                                      "region3"], members=["host-r1", "m2"])
    ref = ref_chaos.FaultPlan.generate(seed, horizon, rates, **targets)
    port = port_chaos.FaultPlan.generate(seed, horizon, rates, **targets)
    assert len(port) > 0
    assert port.wire() == ref.wire()
    # and each package reads the other's wire form back
    assert port_chaos.FaultPlan.from_wire(ref.wire()).wire() == ref.wire()


def test_fault_plan_wire_roundtrip(pkg):
    FaultPlan, FaultEvent = pkg.chaos.FaultPlan, pkg.chaos.FaultEvent
    p = FaultPlan.generate(3, 40, STORM_RATES, shards=4, members=["m1"])
    q = FaultPlan.from_wire(p.wire())
    assert q.events == p.events
    assert (q.seed, q.horizon) == (p.seed, p.horizon)
    s = FaultPlan([FaultEvent(2, "slow_solve", args={"sleep_s": 0.1})])
    assert FaultPlan.from_wire(s.wire()).events == s.events


def test_fault_plan_kills_paired_and_non_overlapping(pkg):
    """Every shard_kill recovers inside the horizon, and no second kill
    of the family lands while the first is still outstanding."""
    p = pkg.chaos.FaultPlan.generate(11, 80, {"shard_kill": 0.1}, shards=8)
    kills = [e for e in p.events if e.kind == "shard_kill"]
    recovers = [e for e in p.events if e.kind == "shard_recover"]
    assert kills and len(kills) == len(recovers)
    open_until = -1
    for e in p.events:
        if e.kind == "shard_kill":
            assert e.step > open_until, "overlapping kill"
            rec = min(r.step for r in recovers if r.step > e.step
                      or (r.step >= e.step and r.target == e.target))
            assert rec < p.horizon
            open_until = rec
    for e in p.events:
        assert e in p.due(e.step)


def test_fault_plan_rejects_unknown_kind(pkg):
    with pytest.raises(ValueError):
        pkg.chaos.FaultPlan([pkg.chaos.FaultEvent(0, "meteor_strike")])
    with pytest.raises(ValueError):
        pkg.chaos.FaultPlan.generate(1, 10, {"meteor_strike": 1.0})


# ------------------------------------------------------------------
# InjectionRegistry: atomic budget claims
# ------------------------------------------------------------------
def test_injection_budget_claim_and_counters(pkg):
    reg = pkg.chaos.InjectionRegistry()
    reg.arm("device_solve", "sleep", budget=2, sleep_s=0.0)
    assert reg.armed("device_solve")
    assert reg.get("device_solve") is not None
    assert reg.get("device_solve") is not None
    assert reg.get("device_solve") is None
    assert not reg.armed("device_solve")
    assert reg.counters["device_solve"] == 2
    reg.arm("delta_row", "mutate", rows=3)
    reg.reset()
    assert not reg.armed("delta_row") and reg.counters == {}


def test_injection_fire_kinds(pkg):
    reg = pkg.chaos.InjectionRegistry()
    reg.arm("x", "raise")
    with pytest.raises(pkg.injection.ChaosInjected):
        reg.get("x").fire()
    reg.arm("y", "sleep", sleep_s=0.0)
    inj = reg.get("y")
    inj.fire()
    assert inj.fired == 1
    reg.arm("z", "mutate", rows=2)
    inj = reg.get("z")
    inj.fire()
    assert inj.args["rows"] == 2


def test_injection_claim_is_atomic_across_threads(pkg):
    """Eight threads race for a budget of 5: exactly 5 claims win."""
    reg = pkg.chaos.InjectionRegistry()
    reg.arm("device_solve", "sleep", budget=5, sleep_s=0.0)
    wins = []
    go = threading.Barrier(8)

    def claim():
        go.wait()
        for _ in range(4):
            if reg.get("device_solve") is not None:
                wins.append(1)
    ts = [threading.Thread(target=claim) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert len(wins) == 5 and reg.counters["device_solve"] == 5
    assert not reg.armed("device_solve")


# ------------------------------------------------------------------
# SolveWatchdog: deadline, failover, quarantine, probe recovery
# ------------------------------------------------------------------
def test_watchdog_failover_quarantine_and_probe_recovery(pkg):
    log = pkg.tracing.MeshEventLog()
    wd = pkg.watchdog.SolveWatchdog(deadline_s=0.05, base_backoff_s=0.05,
                                    max_backoff_s=0.2, event_log=log)

    def stuck():
        time.sleep(1.0)
        return "dev"

    assert wd.run(stuck, lambda: "host", label="t") == ("host",
                                                        "host_failover")
    assert wd.quarantined and wd.stats()["consecutive_failures"] == 1
    assert wd.run(lambda: "dev", lambda: "host") == ("host",
                                                     "host_quarantine")
    wd._probe_at = 0.0
    assert wd.run(lambda: "dev", lambda: "host") == ("dev", "device")
    assert not wd.quarantined
    kinds = [e["kind"] for e in log.events(limit=100)]
    assert "watchdog.failover" in kinds and "watchdog.recovered" in kinds
    fo = log.events(kind="watchdog.failover")[0]
    assert fo["failures"] == 1 and fo["retry_in_s"] > 0


def test_watchdog_injected_poison_fails_over_with_cause(pkg):
    log = pkg.tracing.MeshEventLog()
    wd = pkg.watchdog.SolveWatchdog(deadline_s=0.5, event_log=log)
    reg = pkg.chaos.InjectionRegistry()
    reg.arm("device_solve", "raise")

    def poisoned():
        reg.get("device_solve").fire()
        return "dev"

    assert wd.run(poisoned, lambda: "host") == ("host", "host_failover")
    errs = log.events(kind="watchdog.device_error")
    assert errs and "ChaosInjected" in errs[0]["error"]
    assert wd.quarantined


def test_watchdog_real_device_error(pkg):
    """The deliberate difference: on a device error that no fault plan
    injected, the reference fails over to the host twin; the port raises
    it to the caller, stays out of quarantine and counts no failover."""
    log = pkg.tracing.MeshEventLog()
    wd = pkg.watchdog.SolveWatchdog(deadline_s=0.5, event_log=log)

    def broken():
        raise ValueError("device died")

    if pkg is PORT:
        with pytest.raises(ValueError, match="device died"):
            wd.run(broken, lambda: "host")
        assert not wd.quarantined
        assert not log.events(kind="watchdog.failover")
        # the device path is not held: the next call runs on it
        assert wd.run(lambda: "dev", lambda: "host") == ("dev", "device")
    else:
        assert wd.run(broken, lambda: "host") == ("host", "host_failover")
        assert wd.quarantined
    errs = log.events(kind="watchdog.device_error")
    assert errs and "device died" in errs[0]["error"]


def test_watchdog_backoff_grows_capped_and_jittered(pkg):
    wd = pkg.watchdog.SolveWatchdog(deadline_s=0.01, base_backoff_s=0.1,
                                    max_backoff_s=0.4, seed=1,
                                    event_log=pkg.tracing.MeshEventLog(),
                                    clock=lambda: 0.0)
    delays = []
    for _ in range(4):
        wd.run(lambda: time.sleep(0.5), lambda: "host")
        delays.append(wd._probe_at)
        wd._probe_at = -1.0
    expect_rng = random.Random(1)
    for i, d in enumerate(delays):
        base = min(0.4, 0.1 * 2 ** i)
        jit = 0.5 + expect_rng.random() / 2.0
        assert d == pytest.approx(base * jit)
        assert 0.5 * base <= d <= base


def test_watchdog_probe_waits_for_the_injected_clock(pkg):
    """A stepped clock: the device path stays quarantined until the
    clock passes the backoff, then exactly one caller wins the probe."""
    now = [100.0]
    log = pkg.tracing.MeshEventLog()
    wd = pkg.watchdog.SolveWatchdog(deadline_s=0.02, base_backoff_s=1.0,
                                    max_backoff_s=4.0, seed=3,
                                    event_log=log, clock=lambda: now[0])
    assert wd.run(lambda: time.sleep(0.3), lambda: "host")[1] \
        == "host_failover"
    retry = log.events(kind="watchdog.failover")[0]["retry_in_s"]
    assert 0.5 <= retry <= 1.0
    now[0] += retry * 0.9
    assert wd.run(lambda: "dev", lambda: "host")[1] == "host_quarantine"
    now[0] += retry * 0.2
    # the probe is claimed: a second caller meanwhile stays on the host
    assert wd._claim_probe()
    assert not wd._claim_probe()
    wd._probing = False
    assert wd.run(lambda: "dev", lambda: "host") == ("dev", "device")
    assert not wd.quarantined and log.events(kind="watchdog.recovered")


def test_watchdog_disabled_is_inline(pkg):
    wd = pkg.watchdog.SolveWatchdog(deadline_s=None,
                                    event_log=pkg.tracing.MeshEventLog())
    assert not wd.enabled
    assert wd.run(lambda: "dev", lambda: "host") == ("dev", "device")
    assert not pkg.watchdog.global_watchdog.enabled


def test_run_kernel_watchdog_failover_placement_identical(pkg):
    """A stuck device solve (armed injection past the deadline) fails
    over to the host twin with placement-identical results, lands
    watchdog.failover in the mesh event log, and a later clean probe
    returns to the device path."""
    nodes = [make_node(pkg, i) for i in range(16)]
    pb = pkg.tz.Tensorizer().pack(nodes, [make_ask(pkg, count=4)])
    base = run_kernel(pkg, pb)
    wd, inj = pkg.watchdog.global_watchdog, pkg.injection.global_injections
    events = pkg.tracing.global_mesh_events
    wd.deadline_s = 1.0
    inj.arm("device_solve", "sleep", budget=1, sleep_s=3.0)
    assert_answer_equal(run_kernel(pkg, pb), base)
    assert wd.quarantined
    assert events.events(kind="watchdog.failover", limit=4096)
    assert_answer_equal(run_kernel(pkg, pb), base)      # backoff pending
    wd._probe_at = 0.0
    assert_answer_equal(run_kernel(pkg, pb), base)      # the probe
    assert not wd.quarantined
    assert events.events(kind="watchdog.recovered", limit=4096)
    assert inj.counters["device_solve"] == 1


def test_run_kernel_answers_equal_across_packages():
    """The port's device route and its failover answer equal the
    reference's device route on the same cluster and ask."""
    answers = {}
    for name, P in PKGS.items():
        nodes = [make_node(P, i) for i in range(16)]
        pb = P.tz.Tensorizer().pack(nodes, [make_ask(P, count=4)])
        answers[name] = run_kernel(P, pb)
        if P is PORT:
            P.watchdog.global_watchdog.deadline_s = 5.0
            P.injection.global_injections.arm("device_solve", "raise")
            answers["failover"] = run_kernel(P, pb)
            assert P.watchdog.global_watchdog.quarantined
    assert_answer_equal(answers["port"], answers["ref"])
    assert_answer_equal(answers["failover"], answers["ref"])


# ------------------------------------------------------------------
# ChaosSupervisor: replay through the real recovery hooks
# ------------------------------------------------------------------
def test_supervisor_scripted_storm_drives_state_machines(pkg):
    C = pkg.chaos
    nodes = [make_node(pkg, i) for i in range(40)]
    es = elastic_solver(pkg, nodes, [make_ask(pkg)])
    msup = pkg.sh.ElasticMeshSupervisor(es)
    msup.register_host("host-a", 1)
    log = pkg.tracing.MeshEventLog()
    reg = C.InjectionRegistry()
    plan = C.FaultPlan([
        C.FaultEvent(0, "shard_kill", 1),
        C.FaultEvent(1, "shard_kill", 3),        # refused: degraded
        C.FaultEvent(2, "shard_recover", 1),
        C.FaultEvent(3, "gossip_flap", FakeMember("host-a")),
        C.FaultEvent(4, "stuck_solve"),
        C.FaultEvent(5, "leader_stepdown"),      # no raft: skipped
    ], horizon=8)
    cs = C.ChaosSupervisor(plan, elastic=es, mesh_supervisor=msup,
                           injections=reg, event_log=log,
                           watchdog_deadline_s=0.1)
    assert cs.advance(0) and es.mesh_state == "degraded"
    assert cs.advance(1) == [] and es.mesh_state == "degraded"
    cs.advance(2)
    assert es.mesh_state == "healthy"
    cs.advance(3)
    assert es.mesh_state == "healthy"
    cs.advance(4)
    assert reg.armed("device_solve")
    assert reg.get("device_solve").args["sleep_s"] == pytest.approx(0.4)
    cs.advance(5)
    rep = cs.report()
    assert rep["planned"] == 6
    assert rep["applied"] == 4 and rep["skipped"] == 2
    assert rep["by_kind"]["shard_kill"] == 1
    kinds = [e["kind"] for e in log.events(limit=100)]
    assert "chaos.shard_kill" in kinds and "chaos.skipped" in kinds
    assert not cs.done
    cs.run_to(plan.horizon - 1)
    assert cs.done


def test_supervisor_steps_down_a_raft_leader():
    """leader_stepdown reaches the raft node's step_down: applied when it
    steps down, skipped (the transition refused) when it does not."""
    C = port_chaos

    class Leader:
        calls = 0

        def step_down(self):
            Leader.calls += 1
            return Leader.calls == 1

    log = port_tracing.MeshEventLog()
    plan = C.FaultPlan([C.FaultEvent(0, "leader_stepdown"),
                        C.FaultEvent(1, "leader_stepdown")])
    cs = C.ChaosSupervisor(plan, raft=Leader(), event_log=log)
    cs.run_to(1)
    assert cs.report()["applied"] == 1 and cs.report()["skipped"] == 1
    assert Leader.calls == 2
    assert [e["kind"] for e in log.events()] == ["chaos.leader_stepdown",
                                                 "chaos.skipped"]


@pytest.mark.parametrize("seed", [5, 19])
def test_supervisor_generated_storm_ends_consistent(pkg, seed):
    """A seeded storm of kills and flaps, driven to the horizon with
    solves interleaved, leaves the mesh with planes checksum-identical
    to the template, and the same seed replays the same applied
    sequence."""
    def run_storm():
        nodes = [make_node(pkg, i) for i in range(40)]
        asks = [make_ask(pkg, count=3)]
        es = elastic_solver(pkg, nodes, [make_ask(pkg)])
        msup = pkg.sh.ElasticMeshSupervisor(es)
        msup.register_host("host-a", 1)
        log = pkg.tracing.MeshEventLog()
        plan = pkg.chaos.FaultPlan.generate(
            seed, 30, {"shard_kill": 0.1, "gossip_flap": 0.07},
            shards=es.n_shards, members=[FakeMember("host-a")])
        cs = pkg.chaos.ChaosSupervisor(
            plan, elastic=es, mesh_supervisor=msup,
            injections=pkg.chaos.InjectionRegistry(), event_log=log)
        harness = pkg.chaos.InvariantHarness(event_log=log)
        for step in range(plan.horizon):
            cs.advance(step)
            if step % 7 == 3:
                es.solve_stream([es.pack_batch(asks)])
        if es.mesh_state == "degraded":
            es.recover()
        harness.check_plane_checksums(es)
        harness.raise_if_violated()
        assert cs.report()["applied"] > 0
        return [(e.step, e.kind, str(e.target)) for e in cs.applied]

    assert run_storm() == run_storm()


# ------------------------------------------------------------------
# Invariant harness: detection paths
# ------------------------------------------------------------------
def _upsert_delta(P, node, cpu):
    node.node_resources.cpu = cpu
    node.compute_class()
    d = P.tz.ClusterDelta()
    d.upsert_nodes.append(node)
    return d


def test_corrupt_delta_detected_by_plane_checksum(pkg):
    """The "delta_row" site corrupts the card-bound scatter rows while
    the host template takes the clean apply: plane checksums diverge and
    the harness flags it; a clean apply is the control, a repack
    heals."""
    nodes = [make_node(pkg, i) for i in range(16)]
    rs = resident_solver(pkg, nodes, [make_ask(pkg)])
    log = pkg.tracing.MeshEventLog()
    h = pkg.chaos.InvariantHarness(event_log=log)
    assert h.check_plane_checksums(rs)
    assert rs.apply_delta(_upsert_delta(pkg, nodes[3], 4500)) == "delta"
    assert h.check_plane_checksums(rs) and h.ok
    pkg.injection.global_injections.arm("delta_row", "mutate", budget=1,
                                        rows=1)
    assert rs.apply_delta(_upsert_delta(pkg, nodes[5], 5000)) == "delta"
    assert not h.check_plane_checksums(rs)
    assert not h.ok
    assert h.report()["violations_by_check"]["plane_checksum"] == 1
    assert log.events(kind="chaos.invariant_violation")
    with pytest.raises(pkg.chaos.InvariantViolation):
        h.raise_if_violated()
    rs.repack()
    assert pkg.chaos.InvariantHarness(event_log=log).check_plane_checksums(rs)


def test_corrupt_delta_healed_by_clean_reapply(pkg):
    """Two corrupted rows, then the same upsert applied clean: the rows
    bound for the card are right again, and the next solve equals a
    clean solver's."""
    nodes = [make_node(pkg, i) for i in range(16)]
    clean_nodes = [make_node(pkg, i) for i in range(16)]
    rs = resident_solver(pkg, nodes, [make_ask(pkg)])
    clean = resident_solver(pkg, clean_nodes, [make_ask(pkg)])
    h = pkg.chaos.InvariantHarness(event_log=pkg.tracing.MeshEventLog())
    pkg.injection.global_injections.arm("delta_row", "mutate", rows=2)
    d = pkg.tz.ClusterDelta()
    d.upsert_nodes.extend([nodes[2], nodes[9]])
    for n in d.upsert_nodes:
        n.node_resources.cpu += 1
        n.compute_class()
    assert rs.apply_delta(d) == "delta"
    assert not h.check_plane_checksums(rs)
    d2 = pkg.tz.ClusterDelta()
    d2.upsert_nodes.extend([nodes[2], nodes[9]])
    assert rs.apply_delta(d2) == "delta"
    assert pkg.chaos.InvariantHarness(
        event_log=pkg.tracing.MeshEventLog()).check_plane_checksums(rs)
    d3 = pkg.tz.ClusterDelta()
    d3.upsert_nodes.extend([clean_nodes[2], clean_nodes[9]])
    for n in d3.upsert_nodes:
        n.node_resources.cpu += 1
        n.compute_class()
    clean.apply_delta(d3)
    ask = [make_ask(pkg, count=6, jid="job-b")]
    got = rs.solve_stream([rs.pack_batch(ask)])
    want = clean.solve_stream([clean.pack_batch(ask)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_usage_conservation_bit_identical(pkg):
    nodes = [make_node(pkg, i) for i in range(16)]
    rs = resident_solver(pkg, nodes, [make_ask(pkg)])
    h = pkg.chaos.InvariantHarness(event_log=pkg.tracing.MeshEventLog())
    d = pkg.tz.ClusterDelta()
    for k, nid in enumerate([nodes[1].id, nodes[4].id, nodes[1].id]):
        a = make_alloc(pkg, f"alloc-{k}")
        d.place.append((nid, a))
        h.note_usage(nid, pkg.tz.alloc_usage_vector(a))
    rs.apply_delta(d)
    assert h.check_usage_conservation(rs)
    h.note_usage(nodes[4].id, np.ones(
        pkg.tz.alloc_usage_vector(make_alloc(pkg, "x")).shape, np.float32))
    assert not h.check_usage_conservation(rs)
    assert h.report()["violations_by_check"]["usage_conservation"] >= 1


def test_harness_detects_lost_eval_and_double_placement(pkg):
    H = pkg.chaos.InvariantHarness
    h = H(event_log=pkg.tracing.MeshEventLog())
    h.note_enqueued("ev-1")
    h.note_outcome("ev-1", "acked")
    h.note_enqueued("ev-lost")
    assert not h.check_eval_conservation(broker=None)
    h.note_placement("a1", "n1")
    h.note_placement("a1", "n1")
    assert h.check_no_double_placement()
    h.note_placement("a1", "n2")
    assert not h.check_no_double_placement()
    assert h.report()["violations_by_check"] == {"eval_conservation": 1,
                                                 "double_placement": 1}
    h2 = H(event_log=pkg.tracing.MeshEventLog())
    h2.note_enqueued("ev-2")
    h2.note_outcome("ev-2", "shed")
    h2.note_outcome("ev-2", "acked")
    assert h2.ok


def test_eval_conservation_and_shed_accounting_end_to_end(pkg):
    """Offered work funnels through admission into the broker or the
    shed lane; after a drain every eval is accounted for and offered ==
    admitted + shed holds on the admission tier."""
    broker = pkg.broker.EvalBroker(initial_nack_delay_s=0.001,
                                   delivery_limit=5)
    broker.set_enabled(True)
    adm = pkg.serving.AdmissionController(
        max_pending=4, protect_priority=101, brownout_high=0.9,
        brownout_low=0.5, brownout_after_s=0.001, ns_rate=500.0,
        ns_burst=50.0)
    h = pkg.chaos.InvariantHarness(event_log=pkg.tracing.MeshEventLog())
    shed = []
    for i in range(12):
        ev = pkg.mock.eval_(job_id=f"job-{i}", priority=50)
        h.note_enqueued(ev.id)
        if adm.offer(ev, broker.ready_count()):
            broker.enqueue(ev)
        else:
            shed.append(ev)
            h.note_outcome(ev.id, "shed")
    assert shed

    def drain():
        while True:
            ev, tok = broker.dequeue(["service"], 0.0)
            if ev is None:
                return
            broker.ack(ev.id, tok)
            h.note_outcome(ev.id, "acked")
    assert h.check_eval_conservation(broker)
    drain()
    for ev in shed:
        broker.enqueue(ev)
    drain()
    assert h.check_eval_conservation(broker, shed_pending=0)
    assert h.check_shed_accounting(admission=adm)
    st = adm.stats()
    assert st["offered"] == st["admitted"] + st["shed"]
    h.raise_if_violated()
    assert h.report()["evals_seen"] == 12


# ------------------------------------------------------------------
# Broker nack redelivery backoff
# ------------------------------------------------------------------
def test_broker_nack_delay_exponential_capped_jittered(pkg):
    b = pkg.broker.EvalBroker(initial_nack_delay_s=0.2, max_nack_delay_s=0.5,
                              delivery_limit=10, nack_jitter_seed=123)
    b.set_enabled(True)
    ev = pkg.mock.eval_()
    b.enqueue(ev)
    expect_rng = random.Random(123)
    for n in (1, 2, 3):
        got, tok = b.dequeue(["service"], 2.0)
        assert got is not None and got.id == ev.id
        b.nack(ev.id, tok)
        shard = b.shard_of(ev)
        with shard._lock:
            deadline, eid = shard._delay_heap[0]
        assert eid == ev.id
        delay = deadline - time.time()
        base = min(0.5, 0.2 * 2 ** (n - 1))
        expect = base * (0.5 + expect_rng.random() / 2.0)
        assert delay == pytest.approx(expect, abs=0.08)
        assert delay <= base + 0.01
    b.export_metrics()
    dump = pkg.metrics.global_metrics.dump()
    assert dump["gauges"].get(f"broker.deliveries.{ev.id}", 0) >= 2
    assert "broker.redelivering" in dump["gauges"]


# ------------------------------------------------------------------
# The rpc client's retry loop under the "rpc_transport" site
# ------------------------------------------------------------------
def test_rpc_retry_recovers_from_injected_transport_fault(pkg):
    srv = pkg.RpcServer()
    srv.register("Echo.Upper", lambda p: p[0].upper())
    srv.start()
    try:
        c = pkg.RpcClient(srv.addr)
        assert c.call("Echo.Upper", ["hi"]) == "HI"
        r0 = counter(pkg, "rpc.client.retries")
        pkg.injection.global_injections.arm("rpc_transport", "sleep",
                                            budget=1, sleep_s=0.0)
        assert c.call("Echo.Upper", ["ok"]) == "OK"
        assert counter(pkg, "rpc.client.retries") > r0
        assert pkg.injection.global_injections.counters["rpc_transport"] == 1
    finally:
        srv.stop()


def test_rpc_injected_faults_exhaust_the_retries(pkg):
    """More injected faults than attempts: the call fails as a transport
    error after 1 + retries attempts, each one a claim on the site."""
    srv = pkg.RpcServer()
    srv.register("Echo.Upper", lambda p: p[0].upper())
    srv.start()
    try:
        c = pkg.RpcClient(srv.addr)
        reg = pkg.injection.global_injections
        e0 = counter(pkg, "rpc.client.retries_exhausted")
        reg.arm("rpc_transport", "sleep", budget=10, sleep_s=0.0)
        with pytest.raises(ConnectionError, match="injected"):
            c.call("Echo.Upper", ["x"], retries=2)
        assert reg.counters["rpc_transport"] == 3
        assert counter(pkg, "rpc.client.retries_exhausted") == e0 + 1
        reg.disarm("rpc_transport")
        assert c.call("Echo.Upper", ["y"]) == "Y"
    finally:
        srv.stop()


def test_rpc_retry_exhaustion_and_deadline(pkg):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_addr = s.getsockname()
    s.close()
    c = pkg.RpcClient(dead_addr)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        c.call("Echo.Upper", ["x"], timeout=0.5, retries=2)
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(ConnectionError):
        c.call("Echo.Upper", ["x"], timeout=0.2, retries=0)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        c.call("Echo.Upper", ["x"], timeout=0.2, retries=50,
               deadline_s=0.4)
    assert time.monotonic() - t0 < 3.0


# ------------------------------------------------------------------
# Modeled WAN latency
# ------------------------------------------------------------------
def test_wan_latency_model_deterministic_and_routed(pkg):
    S = pkg.serving

    def mk():
        m = S.WanLatencyModel(default_s=0.08, jitter=0.25, seed=9)
        m.set_pair("us", "eu", 0.12)
        return m

    m = mk()
    assert m.expected("us", "us") == 0.0
    assert m.expected(None, "eu") == 0.0
    assert m.expected("us", "eu") == m.expected("eu", "us") == 0.12
    assert m.expected("us", "ap") == 0.08
    seq = [m.sample("us", "eu") for _ in range(6)]
    m2 = mk()
    assert seq == [m2.sample("us", "eu") for _ in range(6)]
    for s in seq:
        assert 0.12 * 0.75 <= s <= 0.12 * 1.25
    assert len(set(seq)) > 1
    assert m.stats()["samples"] == 6
    r = S.SpilloverRouter(regions={"us": 1.0, "eu": 2.0},
                          overrides={"slo_budget_s": 0.1,
                                     "spill_margin": 1.0},
                          wan_model=mk(),
                          event_log=pkg.tracing.MeshEventLog())
    assert r.wan_delay("us", "us") == 0.0
    assert r.wan_delay("us", "eu") > 0.0
    assert "wan" in r.stats()


# ------------------------------------------------------------------
# The port's narrowed watchdog
# ------------------------------------------------------------------
def _port_pack(n_nodes=16, count=4):
    nodes = [make_node(PORT, i) for i in range(n_nodes)]
    return nodes, port_tz.Tensorizer().pack(nodes, [make_ask(PORT,
                                                             count=count)])


def test_port_real_device_error_propagates_under_armed_watchdog(
        monkeypatch):
    """A RuntimeError from the device path (as a CUDA error or a failed
    kernel build would raise) reaches the caller of `_run_kernel` even
    with the watchdog armed: no failover, no quarantine, no counter."""
    _nodes, pb = _port_pack()

    def broken(*a, **kw):
        raise RuntimeError("fused_wave: kernel launch failed with CUDA "
                           "error 700")
    monkeypatch.setattr(port_solve, "solve_kernel", broken)
    wd = port_watchdog.global_watchdog
    wd.deadline_s = 1.0
    f0 = counter(PORT, "watchdog.host_failover")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port_solve._run_kernel(pb, "cpu", host_mode="never")
    assert not wd.quarantined
    assert counter(PORT, "watchdog.host_failover") == f0
    assert not port_tracing.global_mesh_events.events(
        kind="watchdog.failover")
    # and with the watchdog off, the same error, inline
    wd.deadline_s = None
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port_solve._run_kernel(pb, "cpu", host_mode="never")


def test_port_failover_backend_in_solve_trace():
    """The route that answered shows on the solve itself: a failed-over
    solve's `SolveOutput.trace["backend"]` reads "host_failover", the
    next (backoff pending) "host_quarantine", the probe "device"; the
    placements equal a clean solve's."""
    nodes = [make_node(PORT, i) for i in range(16)]
    asks = [make_ask(PORT, count=4)]
    solver = port_solve.Solver(device="cpu", host="never")

    def solve():
        out = solver.solve(nodes, asks)
        return out.trace["backend"], sorted(
            (p.ask_index, p.node.id if p.node else "") for p in
            out.placements)

    clean_backend, clean = solve()
    assert clean_backend == "device"
    wd = port_watchdog.global_watchdog
    wd.deadline_s = 1.0
    port_injection.global_injections.arm("device_solve", "sleep",
                                         sleep_s=3.0)
    assert solve() == ("host_failover", clean)
    assert solve() == ("host_quarantine", clean)
    wd._probe_at = 0.0
    assert solve() == ("device", clean)
    fo = port_tracing.global_mesh_events.events(kind="watchdog.failover")
    assert len(fo) == 1 and fo[0]["label"] == "solve:1x16"


def test_port_watchdog_off_by_default_ignores_environment(monkeypatch):
    """`NOMAD_TPU_SOLVE_DEADLINE_S` (the reference's switch) changes
    nothing in the port: a new watchdog and the process-wide one (read
    in a fresh interpreter) stay off, and a solve runs inline on the
    device route with no watchdog thread."""
    monkeypatch.setenv("NOMAD_TPU_SOLVE_DEADLINE_S", "0.5")
    assert not port_watchdog.SolveWatchdog().enabled
    code = ("import nomad_tpu_torch.solver.watchdog as w\n"
            "assert w.global_watchdog.deadline_s is None\n"
            "assert not w.SolveWatchdog().enabled\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    _nodes, pb = _port_pack()
    before = len(wd_threads())
    res, backend = port_solve._run_kernel_routed(pb, "cpu",
                                                 host_mode="never")
    assert backend == "device" and isinstance(res.choice, torch.Tensor)
    assert len(wd_threads()) == before
    assert not port_tracing.global_mesh_events.events(limit=4096)


def test_port_late_abandoned_device_call_leaves_next_solve_clean():
    """A device call abandoned at the deadline runs on and finishes late;
    it writes into none of the batch's planes, and the next solve equals
    a clean one."""
    _nodes, pb = _port_pack()
    before = {k: np.array(v) for k, v in pb.__dict__.items()
              if isinstance(v, np.ndarray)}
    clean = run_kernel(PORT, pb)
    wd = port_watchdog.global_watchdog
    wd.deadline_s = 0.2
    port_injection.global_injections.arm("device_solve", "sleep",
                                         sleep_s=1.0)
    assert_answer_equal(run_kernel(PORT, pb), clean)
    assert wd.abandoned()
    assert wd.join_abandoned(30.0) == 0
    assert not wd_threads()
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(pb, k), v, err_msg=k)
    wd._probe_at = 0.0
    assert_answer_equal(run_kernel(PORT, pb), clean)
    assert not wd.quarantined
    wd.deadline_s = None
    assert_answer_equal(run_kernel(PORT, pb), clean)
