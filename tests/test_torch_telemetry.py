"""The port's serving-tier counterparts in the solver and its telemetry
(`Solver.set_degraded` / `BROWNOUT_MAX_WAVES`, `Solver.health_counters`,
`nomad_tpu_torch.telemetry.slo` and `.series`) against the JAX
package's, on the CPU.

A degraded (brownout) solve of a merged config-3 batch stops at the
brownout wave budget with the reference's placements (by node index)
and undecided count.  After one eval on a store-attached solver in each
package the fleet health sample is the same `HealthCounters`: with no
eviction planes (the reference with `NOMAD_TPU_EVICT_E=0`, the port
with `evict_e=0`) and with both at the default width 8.  The SLO burn tracker and the time-series rings, fed
the same observations on an injected clock, report the same status,
events and points."""
import pytest

import chip_smoke
from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler.harness import Harness as RefHarness
from nomad_tpu.solver import solve as ref_solve
from nomad_tpu.solver.tensorize import PlacementAsk as RefAsk
from nomad_tpu.telemetry.series import TimeSeriesStore as RefSeries
from nomad_tpu.telemetry.slo import SloBurnTracker as RefBurn
from nomad_tpu.utils.tracing import MeshEventLog as RefEvents
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler.harness import Harness as PortHarness
from nomad_tpu_torch.solver import solve as port_solve
from nomad_tpu_torch.solver.tensorize import PlacementAsk as PortAsk
from nomad_tpu_torch.telemetry.series import TimeSeriesStore as PortSeries
from nomad_tpu_torch.telemetry.slo import SloBurnTracker as PortBurn
from nomad_tpu_torch.utils.tracing import MeshEventLog as PortEvents

PKGS = {"ref": (ref_mock, ref_structs, ref_solve, RefAsk, RefHarness),
        "port": (port_mock, port_structs, port_solve, PortAsk,
                 PortHarness)}


def merged_problem(pkg, n_nodes=512, n_jobs=16, per_node=5):
    """tests/test_torch_fused_batch.py's merged batch, built with one
    package's own mock and structs."""
    mock, st, _solve, Ask, _h = PKGS[pkg]
    nodes = chip_smoke.make_nodes(mock, n_nodes)
    res_job = mock.job()
    by_node = {}
    cpu, mem, disk = chip_smoke.R_VEC
    for k in range(n_nodes * per_node):
        nd = nodes[k % n_nodes]
        a = mock.alloc(job=res_job, node_id=nd.id)
        a.allocated_resources = st.AllocatedResources(
            tasks={"web": st.AllocatedTaskResources(cpu=cpu,
                                                    memory_mb=mem)},
            shared=st.AllocatedSharedResources(disk_mb=disk))
        by_node.setdefault(nd.id, []).append(a)
    jobs = [chip_smoke.make_job(mock, st, e, chip_smoke.COUNT)
            for e in range(n_jobs)]
    asks = [Ask(job=j, tg=tg, count=tg.count)
            for j in jobs for tg in j.task_groups]
    return nodes, asks, by_node


def test_brownout_budget_matches_reference():
    out = {}
    for pkg in ("ref", "port"):
        solve_mod = PKGS[pkg][2]
        solver = (solve_mod.Solver(host="never") if pkg == "ref"
                  else solve_mod.Solver(device="cpu", host="never"))
        assert not solver.degraded
        solver.set_degraded(True)
        assert solver.degraded
        nodes, asks, by_node = merged_problem(pkg)
        res = solver.solve(nodes, asks, by_node)
        index = {n.id: i for i, n in enumerate(nodes)}
        out[pkg] = ([(p.ask_index, index[p.node.id] if p.node else None)
                     for p in res.placements],
                    res.trace["waves"], res.trace["unfinished"])
    assert port_solve.BROWNOUT_MAX_WAVES == ref_solve.BROWNOUT_MAX_WAVES
    assert out["port"] == out["ref"]
    assert out["port"][1] == port_solve.BROWNOUT_MAX_WAVES
    assert out["port"][2] > 0


def health_sample(pkg, evict_e):
    """The health sample after one eval on a store-attached solver whose
    world packs eviction planes of width `evict_e` (the reference's from
    the environment, the port's from its argument)."""
    mock, st, solve_mod, _ask, Harness = PKGS[pkg]
    h = Harness()
    kw = {} if pkg == "ref" else {"device": "cpu", "evict_e": evict_e}
    h.solver = solve_mod.Solver(store=h.store, resident_min_nodes=1, **kw)
    assert h.solver.health_counters() is None       # no world yet
    for i in range(12):
        n = mock.node(id=f"node-{i:02d}", name=f"node-{i}",
                      datacenter=f"dc{i % 2}")
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
    job = mock.job(id="job-health")
    job.datacenters = ["dc0", "dc1"]
    job.task_groups[0].count = 9
    job.task_groups[0].tasks[0].resources.cpu = 3200
    h.store.upsert_job(h.next_index(), job)
    ev = mock.eval_(job_id=job.id)
    h.store.upsert_evals(h.next_index(), [ev])
    h.process("service", ev)
    hc = h.solver.health_counters()
    return hc.report(), hc.nodes_busy, hc.util_ge, hc.ev_slots


def test_health_counters_match_reference(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_EVICT_E", "0")
    out = {pkg: health_sample(pkg, 0) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0
    assert out["port"][3] == 0


def test_health_counters_match_reference_evict8(monkeypatch):
    """At the default width the placed allocs fill eviction slots, which
    the sample counts the same in both packages."""
    monkeypatch.delenv("NOMAD_TPU_EVICT_E", raising=False)
    out = {pkg: health_sample(pkg, 8) for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    assert out["port"][3] == 9


def feed(burn, series):
    """The same observations for both packages, on the injected clock."""
    for t in range(0, 120, 3):
        burn.observe(good=9, bad=1 if 30 <= t < 60 else 0, now=float(t))
        series.record("broker.ready_depth", float(t % 7), now=t + 0.5)
    series.flush(now=125.0)


@pytest.mark.parametrize("now", [59.0, 119.0])
def test_slo_burn_and_series_match_reference(now):
    out = {}
    for pkg, (Burn, Series, Events) in {
            "ref": (RefBurn, RefSeries, RefEvents),
            "port": (PortBurn, PortSeries, PortEvents)}.items():
        events = Events()
        burn = Burn(fast_window_s=30, slow_window_s=90, events=events)
        series = Series(resolutions=((1, 60), (10, 20)))
        feed(burn, series)
        out[pkg] = (burn.status(now=now),
                    [{k: v for k, v in e.items()
                      if k not in ("t_wall", "t_mono")}
                     for e in events.events()],
                    series.points("broker.ready_depth", res=1),
                    series.points("broker.ready_depth", res=10),
                    series.stats())
    assert out["port"] == out["ref"]
    assert any(e["kind"] == "slo.burn" for e in out["port"][1])
