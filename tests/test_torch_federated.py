"""The port's federated and cross-region solvers against the JAX
package's, on the CPU.

Both packages get the same regions (fixed node and job ids, each
package's own mock) and the same batches; the reference's mesh runs on
the conftest's eight virtual CPU devices, the port's on shards that all
sit on `cpu`; `pallas="off"` on both sides.  The federated stream equals
the reference's and each region's own ResidentSolver, region by region;
the cross-region solver equals the reference's and a flat ResidentSolver
over the union fleet, also through a shard loss inside a region (against
a from-scratch pack of the surviving nodes) and its recovery.  Scores
agree with the reference within the binpack bound (4 ulp) and with the
port's own flat solvers bit for bit.
"""
import numpy as np
import pytest

from nomad_tpu.parallel import federated as ref_fed
from nomad_tpu_torch.parallel import federated as port_fed
from nomad_tpu_torch.solver.tensorize import ClusterDelta
from nomad_tpu_torch.utils.tracing import MeshEventLog
from tests.test_torch_elastic_mesh import (assert_same_stream,
                                           lost_node_ids, solve_ids)
from tests.test_torch_resident import (SIDES, host, make_alloc, make_ask,
                                       make_node, make_nodes, probes)

REF, PORT = SIDES


def regions(side, sizes, start=0):
    out, i = [], start
    for n in sizes:
        out.append([make_node(side, i + k) for k in range(n)])
        i += n
    return out


def fed(side, region_nodes, **kw):
    kw.setdefault("gp", 4)
    kw.setdefault("kp", 16)
    if side.name == "ref":
        return ref_fed.FederatedResidentSolver(region_nodes, probes(side),
                                               **kw)
    return port_fed.FederatedResidentSolver(region_nodes, probes(side),
                                            device="cpu", pallas="off",
                                            **kw)


def region_asks(side, r, step):
    return [make_ask(side, f"r{r}-{step}a", 3, cpu=600 + 100 * step),
            make_ask(side, f"r{r}-{step}b", 2, spread=True,
                     constraint=bool(step % 2))]


# ------------------------------------------------------------ federated
@pytest.mark.parametrize("sizes", [(24, 24), (30, 70, 12)])
def test_federated_stream_matches_reference_and_regions(sizes):
    """Equal (and ragged) regions: the fused stream equals the
    reference's and every region's own ResidentSolver; usage carries."""
    seeds = [[1 + r, 5 + r] for r in range(len(sizes))]
    outs, solvers = [], []
    for side in SIDES:
        f = fed(side, regions(side, sizes))
        bs = [[f.pack_batch(r, region_asks(side, r, s)) for s in range(2)]
              for r in range(len(sizes))]
        outs.append(f.solve_stream(bs, seeds=seeds))
        solvers.append(f)
    rf, pf = solvers
    assert_same_stream(outs[0], outs[1], "federated")
    for a, b in zip(rf.usage(), pf.usage()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        [s.template.n_real for s in pf.solvers], list(sizes))
    assert len({s.template.avail.shape[0] for s in pf.solvers}) == 1
    port_regions = regions(PORT, sizes)
    for r, nodes in enumerate(port_regions):
        solo = PORT.solver(nodes, probes(PORT), gp=4, kp=16,
                           wave_mode="while", shortlist_c=-1)
        if solo.template.avail.shape != pf.solvers[r].template.avail.shape:
            # a padded region's candidate window is clamped by the wider
            # stacked axis, so only the reference speaks for it
            continue
        out = solo.solve_stream(
            [solo.pack_batch(region_asks(PORT, r, s)) for s in range(2)],
            seeds=seeds[r])
        c, ok, sc, st = out
        np.testing.assert_array_equal(ok, outs[1][1][r])
        np.testing.assert_array_equal(st, outs[1][3][r])
        np.testing.assert_array_equal(np.where(ok, c, -1),
                                      np.where(ok, outs[1][0][r], -1))
        np.testing.assert_array_equal(np.where(ok, sc, 0.0),
                                      np.where(ok, outs[1][2][r], 0.0))
        np.testing.assert_array_equal(
            solo.usage()[0], pf.usage()[0][r][:solo.usage()[0].shape[0]])
    # health over the stacked regions: the merged host twins, the port's
    # and the reference's (whose own `health_counters` raises a KeyError:
    # it builds the counters from the kernel's stacked buffers without
    # unpacking them; ROADMAP.md Queue 3)
    assert pf.health_counters() == pf.health_host_twin()
    assert vars(pf.health_counters()) == vars(rf.health_host_twin())


def test_federated_usage_carries_and_resets():
    f = fed(PORT, regions(PORT, (8, 8)), gp=2, kp=8)
    f.solve_stream([[f.pack_batch(0, [make_ask(PORT, "x0", 2)])],
                    [f.pack_batch(1, [make_ask(PORT, "x1", 2)])]])
    u1, _ = f.usage()
    f.solve_stream([[f.pack_batch(0, [make_ask(PORT, "y0", 2)])],
                    [f.pack_batch(1, [make_ask(PORT, "y1", 2)])]])
    u2, _ = f.usage()
    assert u2.sum() > u1.sum() and u1.shape[0] == 2
    mine = np.zeros_like(u2)
    f.reset_usage(used0=mine)
    mine += 1.0                                  # the carry is a copy
    assert f.usage()[0].sum() == 0


def test_federated_rejects_ragged_steps_and_guards_jobs_per_region():
    f = fed(PORT, regions(PORT, (8, 8)), gp=2, kp=8)
    with pytest.raises(ValueError, match="equal step counts"):
        f.solve_stream([[f.pack_batch(0, [make_ask(PORT, "a", 2)])], []])
    f.solve_stream([[f.pack_batch(0, [make_ask(PORT, "dup", 1)])],
                    [f.pack_batch(1, [make_ask(PORT, "dup", 1)])]])
    with pytest.raises(ValueError, match="multiple batches"):
        f.solve_stream(
            [[f.pack_batch(0, [make_ask(PORT, "dup", 1)]),
              f.pack_batch(0, [make_ask(PORT, "dup", 1)])],
             [f.pack_batch(1, [make_ask(PORT, "z1", 1)]),
              f.pack_batch(1, [make_ask(PORT, "z2", 1)])]])


def test_federated_universe_mismatch_names_region():
    a = [make_node(PORT, i) for i in range(8)]
    b = []
    for i in range(8):
        nd = make_node(PORT, 50 + i)
        if i % 3 == 2:
            nd.datacenter = "dc9"
        b.append(nd)
    with pytest.raises(ValueError, match=r"region 1 disagrees on dc_ok"):
        fed(PORT, [a, b])


@pytest.mark.parametrize("evict_e", [0, 4])
def test_federated_stack_cache_keyed_on_node_and_ev_epochs(evict_e):
    rs = regions(PORT, (12, 12))
    f = fed(PORT, rs, evict_e=evict_e)
    batches = [[f.pack_batch(r, [make_ask(PORT, f"c{r}", 2)])]
               for r in range(2)]
    first = f._stack_args(batches, 1)
    assert f._stack_args(batches, 1) is first
    delta = ClusterDelta()
    if evict_e:
        # a pure alloc place moves the eviction planes, not the nodes
        delta.place.append((rs[0][0].id, make_alloc(PORT, "ev", rs[0][0].id,
                                                   100, 128)))
        node_ep = f.solvers[0]._node_epoch
        f.solvers[0].apply_delta(delta)
        assert f.solvers[0]._node_epoch == node_ep
    else:
        delta.upsert_nodes.append(make_node(PORT, 0, cpu=9000))
        f.solvers[0].apply_delta(delta)
    assert f._stack_args(batches, 1) is not first


def test_federated_shares_one_template_for_one_node_list():
    nodes = [make_node(PORT, i) for i in range(16)]
    f = fed(PORT, [nodes, nodes, nodes])
    assert f.solvers[0] is f.solvers[2] and f.R == 3
    pb = f.pack_batch(0, [make_ask(PORT, "s", 3)])
    c, o, s, st = f.solve_stream([[pb], [pb], [pb]])
    for r in (1, 2):
        np.testing.assert_array_equal(c[0], c[r])
        np.testing.assert_array_equal(s[0], s[r])
    assert port_fed.FederatedResidentSolver.compile_count() == -1


# ---------------------------------------------------------- cross-region
def cross(side, nodes, **kw):
    parts = [nodes[r * 12:(r + 1) * 12] for r in range(4)]
    kw.setdefault("gp", 4)
    kw.setdefault("kp", 16)
    kw.setdefault("pallas", "off")
    if side.name == "ref":
        return ref_fed.CrossRegionResidentSolver(parts, probes(side), **kw)
    return port_fed.CrossRegionResidentSolver(
        parts, probes(side), devices=["cpu"], n_devices=8,
        event_log=MeshEventLog(), **kw)


@pytest.mark.parametrize("seed,shortlist_c,with_ref", [
    (3, 0, True), (11, -1, False), (5, 0, False)])
def test_cross_region_matches_flat_oracle(seed, shortlist_c, with_ref):
    """Four regions of 12 nodes on a 4 x 1 x 2 mesh: equal to a flat
    ResidentSolver over the union (and to the reference's cross-region
    solver), through a shard loss inside region 2 and its recovery."""
    nodes = make_nodes(PORT, 48)
    cr = cross(PORT, nodes, shortlist_c=shortlist_c)
    assert cr.solver.n_regions == 4 and cr.solver.three_tier
    assert cr.region_shards("region1") == [2, 3]
    flat = PORT.solver(nodes, probes(PORT), gp=4, kp=16,
                       shortlist_c=shortlist_c)
    if with_ref:
        rcr = cross(REF, make_nodes(REF, 48), shortlist_c=shortlist_c)

    def asks(side, step):
        return [make_ask(side, f"x{step}", 4),
                make_ask(side, f"y{step}", 3, cpu=600, spread=True)]
    for step in range(2):
        out = cr.solve_stream([cr.pack_batch(asks(PORT, step))],
                              seeds=[seed + step])
        out_f = flat.solve_stream([flat.pack_batch(asks(PORT, step))],
                                  seeds=[seed + step])
        for a, b in zip(out, out_f):
            np.testing.assert_array_equal(a, b)
        if with_ref:
            assert_same_stream(
                rcr.solve_stream([rcr.pack_batch(asks(REF, step))],
                                 seeds=[seed + step]), out, f"step {step}")
    np.testing.assert_array_equal(cr.usage()[0][:48], flat.usage()[0][:48])
    # a shard lost inside region 2: its nodes leave every solve
    lost = cr.fail_region_shard("region2")
    assert lost and cr.mesh_state == "degraded"
    lost_ids = lost_node_ids(cr.solver)
    assert lost_ids
    survivors = [n for n in nodes if n.id not in lost_ids]
    flat2 = PORT.solver(survivors, probes(PORT), gp=4, kp=16,
                        shortlist_c=shortlist_c)
    cr.reset_usage()
    got = solve_ids(cr, cr.pack_batch(asks(PORT, 5)))
    want = solve_ids(flat2, flat2.pack_batch(asks(PORT, 5)))
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    used = cr.usage()[0]
    mask = cr.health_row_mask()
    assert cr.health_counters() == PORT.health.health_host(
        cr.template, used, cr.usage()[1], row_mask=mask)
    cr.recover_region()
    assert cr.mesh_state == "healthy" and cr.solver.three_tier
    cr.reset_usage()
    flat.reset_usage()
    out = cr.solve_stream([cr.pack_batch(asks(PORT, 9))], seeds=[seed])
    out_f = flat.solve_stream([flat.pack_batch(asks(PORT, 9))],
                              seeds=[seed])
    for a, b in zip(out, out_f):
        np.testing.assert_array_equal(a, b)
    kinds = [e["kind"] for e in cr.event_log.events()]
    assert kinds.count("region.join") == 4
    assert "region.degraded" in kinds and "region.recovered" in kinds
    wt = cr.wave_traffic([cr.pack_batch(asks(PORT, 10))])
    assert wt["wan"]["n_regions"] == 4 and "dcn" in wt


def test_cross_region_bias_plane_and_directory():
    nodes = make_nodes(PORT, 48)
    log = MeshEventLog()
    d = port_fed.RegionDirectory(event_log=log)
    cr = cross(PORT, nodes, region_names=["us", "eu", "ap", "sa"],
               directory=d)
    assert cr.region_of[nodes[13].id] == "eu"
    plane = cr.region_bias_plane(4, "eu", weight=2.0)
    Np = cr.template.avail.shape[0]
    lo, hi = cr._region_slices["eu"]
    assert plane.shape == (4, Np) and (lo, hi) == (12, 24)
    assert (plane[:, lo:hi] == 2.0).all()
    assert plane.sum() == 4 * (hi - lo) * 2.0
    rcr = cross(REF, make_nodes(REF, 48),
                region_names=["us", "eu", "ap", "sa"])
    np.testing.assert_array_equal(rcr.region_bias_plane(4, 1, 2.0), plane)

    class Member:
        def __init__(self, mid, region):
            self.id, self.region = mid, region

    d.on_join(Member("us-1", "us"))
    d.on_join(Member("us-2", "us"))
    d.on_join(Member("eu-1", "eu"))
    assert d.regions() == ["eu", "us"]
    assert d.members_of("us") == ["us-1", "us-2"]
    d.on_fail(Member("eu-1", "eu"))
    assert d.regions() == ["us"]
    kinds = [e["kind"] for e in log.events()]
    assert kinds == ["region.join"] * 3 + ["region.fail", "region.leave"]
    assert log.events()[0]["new_region"] is True
    assert log.events()[1]["new_region"] is False


def test_region_bias_plane_feeds_the_solve():
    """The bias plane of one region steers a solve toward it (the
    torch scorer's `region` term, the shortlist off)."""
    import torch
    from nomad_tpu_torch.solver.kernel import solve_kernel
    from nomad_tpu_torch.solver.solve import _kernel_args
    nodes = make_nodes(PORT, 48)
    cr = cross(PORT, nodes)
    pb = cr.pack_batch([make_ask(PORT, "b", 6)])
    plane = cr.region_bias_plane(pb.ask_res.shape[0], "region3", 1.0)
    res = solve_kernel(*_kernel_args(pb, "cpu"),
                       region_bias=torch.as_tensor(plane))
    ok = host(res.choice_ok)[:pb.n_place, 0]
    chosen = host(res.choice)[:pb.n_place, 0][ok]
    assert ok.all() and (chosen >= 36).all() and (chosen < 48).all()
