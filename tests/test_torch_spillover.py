"""The port's cross-region admission tier (`RegionServingState`,
`WanLatencyModel`, `SpilloverRouter` in `nomad_tpu_torch.server.serving`)
and `MeshEventLog.region_table`, against the JAX package's.

The same call sequence through both packages' router, region states and
WAN model gives equal routes, stats, shed depth and seeded WAN samples;
the same events give equal region tables; the gossip-driven directory
and router cases of the reference's `tests/test_multiregion.py` hold on
the port; the port's router reads no environment.  `chip_smoke.py`'s
spillover leg (phase 11 L5) is bench.py `run_multiregion`'s: its queue
simulation equals `bench._region_queue_sim` on the same arrivals and
router, and the leg gives the same figures through either package's
router.  All exact."""
import pytest

import bench
import chip_smoke
from nomad_tpu.membership.gossip import GossipAgent as RefGossipAgent
from nomad_tpu.membership.gossip import Member as RefMember
from nomad_tpu.parallel import federated as ref_fed
from nomad_tpu.server import serving as ref_serving
from nomad_tpu.utils import tracing as ref_tracing
from nomad_tpu_torch.membership.gossip import GossipAgent, Member
from nomad_tpu_torch.parallel import federated as port_fed
from nomad_tpu_torch.server import serving as port_serving
from nomad_tpu_torch.server.serving import SpilloverRouter
from nomad_tpu_torch.utils import tracing as port_tracing
from nomad_tpu_torch.utils.tracing import MeshEventLog

PKGS = {"ref": (ref_serving, ref_fed, ref_tracing),
        "port": (port_serving, port_fed, port_tracing)}
ENV_KNOBS = ("NOMAD_TPU_SLO_BUDGET_S", "NOMAD_TPU_SPILL_MARGIN",
             "NOMAD_TPU_REGION_COST", "NOMAD_TPU_MAX_PENDING")


@pytest.fixture(autouse=True)
def _no_env_knobs(monkeypatch):
    """The reference reads these; the comparisons run at the defaults."""
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


class M:
    def __init__(self, mid, region):
        self.id, self.region = mid, region


def brown(rs):
    rs.note_ready(int(rs.admission.brownout_high
                      * rs.admission.max_pending) + 1)


def script(pkg):
    """One scripted session of the admission tier; every observable
    output, in order."""
    serving, fed, tracing = PKGS[pkg]
    log = tracing.MeshEventLog()
    wan = serving.WanLatencyModel(default_s=0.03, jitter=0.25, seed=7)
    wan.set_pair("us", "eu", 0.02)
    r = serving.SpilloverRouter(
        regions={"us": 1.0, "eu": 2.0, "ap": 3.0},
        overrides={"slo_budget_s": 0.1, "spill_margin": 1.0,
                   "max_pending": 64},
        directory=fed.RegionDirectory(event_log=log), event_log=log,
        wan_model=wan)
    out = []
    for name in ("us", "eu", "ap"):
        for b, wall in ((1, 0.004), (8, 0.01), (16, 0.02), (8, 0.012)):
            r.note_solve(name, b, wall)
    for k in range(6):
        out.append(r.route(k, home=("us", "eu", "ap", None)[k % 4]))
    r.region("eu").note_ready(20)
    out.append(r.route("deep", home="eu", n_evals=30))
    brown(r.region("us"))
    out += [r.route(f"b{k}", home="us") for k in range(3)]
    for name in ("eu", "ap"):
        r.region(name).model.observe(8, 5.0)
        r.region(name).note_ready(10)
    out.append(r.route("late", home="us"))
    for name in ("eu", "ap"):
        brown(r.region(name))
    out += [r.route(f"s{k}", home="eu") for k in range(4)]
    out.append(r.shed_depth())
    r.region("ap").note_ready(0)
    out.append(r.drain_shed(max_n=2))
    out.append(r.shed_depth())
    r.on_join(M("x1", "sa"))
    r.on_fail(M("x1", "sa"))
    out.append(r.regions())
    r.on_join(M("y1", "ap"))
    out.append(r.drain_shed())
    out.append([(r.wan_delay("us", d), wan.expected("us", d))
                for d in ("us", "eu", "ap", "eu", "ap")])
    out.append([r.region(n).browned_out() for n in ("us", "eu", "ap")])
    out.append([r.region(n).meets_slo(4, 0.05) for n in ("us", "eu", "ap")])
    out.append(r.stats())
    out.append([(e["kind"], {k: v for k, v in e.items()
                             if k not in ("seq", "t_wall", "t_mono")})
                for e in log.events()])
    out.append(log.region_table())
    return out


def test_spillover_session_matches_reference():
    assert script("port") == script("ref")


def test_wan_samples_match_reference():
    draws = {}
    for pkg, (serving, _fed, _tr) in PKGS.items():
        m = serving.WanLatencyModel(default_s=0.08, jitter=0.25, seed=9)
        m.set_pair("a", "b", 0.05)
        draws[pkg] = ([m.sample(s, d) for s, d in
                       (("a", "b"), ("a", "c"), ("a", "a"), (None, "b"),
                        ("b", "a"), ("c", "d"))] + [m.stats()])
    assert draws["port"] == draws["ref"]
    assert draws["port"][2] == 0.0 and draws["port"][3] == 0.0


def test_region_table_matches_reference():
    events = [("region.join", {"region": "us", "member": "us-1"}),
              ("region.join", {"region": "us", "member": "us-2"}),
              ("region.join", {"region": "eu", "n_nodes": 10}),
              ("region.join", {"region": "eu", "member": "eu-1"}),
              ("region.degraded", {"region": "eu"}),
              ("region.spill", {"region": "us"}),
              ("region.fail", {"region": "us", "member": "us-1"}),
              ("region.recovered", {}),
              ("region.join", {"region": "ap", "member": "ap-1"}),
              ("region.fail", {"region": "ap", "member": "ap-1"}),
              ("region.leave", {"region": "ap"}),
              ("slo.burn", {"region": "us"}),
              ("region.degraded", {"region": "us"})]
    tables = {}
    for pkg, (_s, _f, tracing) in PKGS.items():
        log = tracing.MeshEventLog()
        for kind, attrs in events:
            log.record(kind, **attrs)
        tables[pkg] = log.region_table()
    assert tables["port"] == tables["ref"]
    assert tables["port"]["us"] == {"members": ["us-2"],
                                    "state": "degraded"}
    assert tables["port"]["eu"]["state"] == "up"
    assert tables["port"]["ap"] == {"members": [], "state": "left"}


# -------------------------------------------- tests/test_multiregion.py
def test_gossip_region_join_leave_drives_directory():
    """RegionDirectory's callbacks plug straight into GossipAgent's
    on_join / on_fail; join and leave replay through the event log's
    region_table, as in the reference."""
    class _R:
        def register(self, *_a, **_k):
            pass

    tables = {}
    for pkg, Agent, Mem in (("port", GossipAgent, Member),
                            ("ref", RefGossipAgent, RefMember)):
        log = PKGS[pkg][2].MeshEventLog()
        d = PKGS[pkg][1].RegionDirectory(event_log=log)
        agent = Agent(Mem(id="me", region="us", addr=("127.0.0.1", 0)),
                      _R(), on_join=d.on_join, on_fail=d.on_fail)
        for mid, region, port in (("us-1", "us", 1), ("us-2", "us", 2),
                                  ("eu-1", "eu", 3)):
            agent.on_join(Mem(id=mid, region=region,
                              addr=("127.0.0.1", port)))
        assert d.regions() == ["eu", "us"]
        assert d.members_of("us") == ["us-1", "us-2"]
        agent.on_fail(Mem(id="eu-1", region="eu", addr=("127.0.0.1", 3)))
        assert d.regions() == ["us"]          # last member gone: left
        tables[pkg] = log.region_table()
    assert tables["port"] == tables["ref"]
    assert tables["port"]["us"]["state"] == "up"
    assert tables["port"]["eu"] == {"members": [], "state": "left"}


def seeded_router(**overrides):
    log = MeshEventLog()
    d = port_fed.RegionDirectory(event_log=log)
    r = SpilloverRouter(regions={"us": 1.0, "eu": 2.0, "ap": 3.0},
                        overrides={"slo_budget_s": 0.1,
                                   "spill_margin": 1.0, **overrides},
                        directory=d, event_log=log)
    for name in ("us", "eu", "ap"):
        r.note_solve(name, 8, 0.01)
        r.note_solve(name, 16, 0.02)
    return r, log


def test_spillover_prefers_healthy_home_then_cheapest():
    r, _log = seeded_router()
    ev = object()
    assert r.route(ev, home="eu") == ("eu", "home")
    assert r.route(ev) == ("us", "cheapest")
    assert r.stats()["routed"]["home"] == 1


def test_spillover_overflows_on_home_brownout():
    r, log = seeded_router()
    brown(r.region("eu"))
    assert r.route(object(), home="eu") == ("us", "spillover")
    assert any(e["kind"] == "region.spill" for e in log.events())


def test_spillover_slo_miss_admits_late_not_parked():
    r, _log = seeded_router()
    brown(r.region("eu"))
    for name in ("us", "ap"):
        rs = r.region(name)
        rs.model.observe(8, 5.0)
        rs.model.observe(16, 9.0)
        rs.note_ready(10)
    reg, cause = r.route(object(), home="eu")
    assert cause == "slo_miss" and reg in ("us", "ap")


def test_spillover_all_browned_sheds_then_readmits():
    r, log = seeded_router()
    for name in ("us", "eu", "ap"):
        brown(r.region(name))
    ev = object()
    assert r.route(ev, home="eu") == (None, "shed")
    assert r.shed_depth() == 1
    assert any(e["kind"] == "region.shed" for e in log.events())
    r.region("ap").note_ready(0)
    assert r.drain_shed() == [(ev, "ap")]
    assert r.shed_depth() == 0
    s = r.stats()
    assert s["routed"]["shed"] == 1 and s["routed"]["readmitted"] == 1
    assert s["shed_lane_depth"] == 0


def test_spillover_membership_follows_gossip():
    log = MeshEventLog()
    r = SpilloverRouter(directory=port_fed.RegionDirectory(event_log=log),
                        event_log=log, overrides={"slo_budget_s": 0.1})
    r.on_join(M("s1", "us"))
    r.on_join(M("s2", "eu"))
    assert r.regions() == ["eu", "us"]
    r.note_solve("us", 8, 0.001)
    r.note_solve("eu", 8, 0.001)
    assert r.route(object())[0] == "eu"      # equal cost: name order
    r.on_fail(M("s2", "eu"))
    assert r.regions() == ["us"]
    assert r.route(object())[0] == "us"
    r.on_fail(M("s1", "us"))
    assert r.regions() == []
    assert r.route(object()) == (None, "shed")
    assert r.shed_depth() == 1


def test_spillover_reads_no_environment(monkeypatch):
    """Both routers read NOMAD_TPU_SPILL_MARGIN and friends when built,
    and `overrides` win over them (the name is kept from when the port's
    router read no environment)."""
    monkeypatch.setenv("NOMAD_TPU_SPILL_MARGIN", "0.5")
    monkeypatch.setenv("NOMAD_TPU_MAX_PENDING", "128")
    monkeypatch.setenv("NOMAD_TPU_REGION_COST", "not-a-number")

    def knobs(cls, **kw):
        r = cls(regions={"us": 1.0}, **kw)
        return (r.spill_margin, r.max_pending, r.default_cost,
                r.slo_budget_s, r.region("us").admission.max_pending)

    ref = knobs(ref_serving.SpilloverRouter)
    assert knobs(SpilloverRouter) == ref
    assert ref == (0.5, 128, port_serving.DEFAULT_REGION_COST,
                   port_serving.DEFAULT_SLO_BUDGET_S, 128)
    over = {"spill_margin": 0.9, "max_pending": 32}
    assert (knobs(SpilloverRouter, overrides=over)
            == knobs(ref_serving.SpilloverRouter, overrides=over))
    assert knobs(SpilloverRouter, overrides=over)[:2] == (0.9, 32)


# ------------------------------------------------ chip_smoke phase 11 L5
def ref_router(svc, regions):
    r = ref_serving.SpilloverRouter(
        regions={n: 1.0 + 0.1 * i for i, n in enumerate(regions)},
        overrides={"slo_budget_s": 2.5 * svc, "spill_margin": 1.0,
                   "max_pending": 64},
        wan_model=ref_serving.WanLatencyModel(default_s=0.5 * svc,
                                              jitter=0.25))
    for n in regions:
        for b in (1, 2, 4, 8, 16, 32, 64):
            r.note_solve(n, b, b * svc)
    return r


@pytest.mark.parametrize("policy", ["isolated", "router"])
def test_smoke_queue_sim_is_the_bench_sim(policy):
    """chip_smoke.region_queue_sim is bench._region_queue_sim: the same
    latencies, brownouts and completions on the same arrivals (with the
    reference's router, fresh for each)."""
    svc = 0.004
    regions = ["r0", "r1", "r2", "r3"]
    arrivals = [(0.0005 * k, regions[0] if k % 10 < 7 else
                 regions[1 + k % 3]) for k in range(300)]
    kw = ({"watermark": 48} if policy == "isolated" else {})
    runs = []
    for sim in (bench._region_queue_sim, chip_smoke.region_queue_sim):
        if policy == "router":
            kw = {"router": ref_router(svc, regions)}
        runs.append(sim(arrivals, regions, svc, **kw))
    assert runs[0] == runs[1]
    assert runs[0][2] == len(arrivals)


def test_smoke_spillover_leg_same_through_both_routers():
    """Leg L5 at a fixed per-eval time gives the same figures through
    the port's router as through the reference's, and meets the
    reference's acceptance (spill_ok, nothing lost, the shed lane
    accounted for)."""
    svc = 0.0073
    port = chip_smoke.spillover_leg(svc, 4, port_serving.SpilloverRouter,
                                    port_serving.WanLatencyModel)
    ref = chip_smoke.spillover_leg(svc, 4, ref_serving.SpilloverRouter,
                                   ref_serving.WanLatencyModel)
    assert port == ref
    assert port["spill_ok"] and port["evals_lost"] == 0
    assert port["shed_accounting_intact"]
    assert port["isolated_browned_regions"]
    assert port["p99_spillover_s"] <= 2 * port["p99_balanced_s"]
