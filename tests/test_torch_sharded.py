"""The port's mesh tiers against the JAX package's, on the CPU.

The reference runs its mesh solves under `shard_map` on the conftest's
eight virtual CPU devices (`pallas="off"` unless a case names a mode: its
Pallas kernel then runs in interpret mode); the port splits the same
numbers over a mesh of S shards that all sit on `cpu`, with the plain
wave scorer (the fused wave's modes run as `fused_wave_plain` on CPU
tensors).  Both packages get the same packed arrays: the reference's
`kernel_args` of one PackedBatch feed both solves.

Against the reference: choices, ok flags, statuses, wave and rescore
counts, every explainability counter, `feas`, the final usage equal;
scores within tests/test_score_spec.py's binpack bound (4 ulp).
Against the port's own flat solve: everything but the rescore count
(counted per shard on a mesh) bit for bit.
"""
import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.parallel import sharded as ref_sh
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.parallel import sharded as port_sh
from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver.tensorize import ARRAY_FIELDS, ClusterDelta
from tests.test_elastic_mesh import mesh_solve_two_tier
from tests.test_multiregion import mesh_solve_three_tier
from tests.test_sharded_resident import (contended_problem, mesh_solve,
                                         spread_problem)
from tests.test_torch_resident import (MAX_ULP, SIDES, assert_stream_equal,
                                       f32_layout, host, make_alloc,
                                       make_ask, make_node, make_nodes,
                                       mixed_batches, overcommit, probes)

CPU = [torch.device("cpu")]
REF, PORT = SIDES
#: SolveResult fields held equal to the reference / the flat solve
FIELDS = ("choice_ok", "unfinished", "n_feasible", "n_exhausted",
          "dim_exhausted", "feas", "cons_filtered", "used_final",
          "dev_used_final")


def port_mesh(grid):
    """A port mesh of CPU shards: ("nodes", S), ("hosts", H, C) or
    ("regions", Rg, H, C)."""
    kind, *dims = grid
    S = int(np.prod(dims))
    if kind == "nodes":
        return port_sh.make_node_mesh(S, devices=CPU)
    if kind == "hosts":
        return port_sh.make_two_tier_mesh(dims[0], S, devices=CPU)
    return port_sh.make_three_tier_mesh(dims[0], dims[1], S, devices=CPU)


def ref_mesh_solve(args, grid, **kw):
    kind, *dims = grid
    if kind == "nodes":
        return mesh_solve(args, dims[0], **kw)
    if kind == "hosts":
        return mesh_solve_two_tier(args, *dims, **kw)
    return mesh_solve_three_tier(args, *dims, **kw)


def ref_mesh(grid):
    kind, *dims = grid
    S = int(np.prod(dims))
    if kind == "nodes":
        return ref_sh.make_node_mesh(S)
    if kind == "hosts":
        return ref_sh.make_two_tier_mesh(dims[0], S)
    return ref_sh.make_three_tier_mesh(dims[0], dims[1], S)


def port_flat(args, seed=0, **kw):
    """The port's one-device solve of the reference's kernel args."""
    t = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in args[:-1])
    return port_kernel.solve_kernel(*t, int(args[-1]), seed, **kw)


def assert_like_reference(ref, port, rescore=True):
    ok = np.asarray(ref.choice_ok)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      host(getattr(port, f)), err_msg=f)
    np.testing.assert_array_equal(np.where(ok, np.asarray(ref.choice), -1),
                                  np.where(ok, host(port.choice), -1))
    np.testing.assert_array_max_ulp(
        np.where(ok, np.asarray(ref.score), 0.0),
        np.where(ok, host(port.score), 0.0), maxulp=MAX_ULP)
    assert int(ref.n_waves) == int(port.n_waves)
    if rescore:
        assert int(ref.n_rescore) == int(port.n_rescore)


def assert_like_flat(flat, mesh):
    for f in FIELDS + ("choice", "score"):
        assert torch.equal(getattr(flat, f), getattr(mesh, f)), f
    assert flat.n_waves == mesh.n_waves


# ------------------------------------------------- solve_steps, meshed
@pytest.mark.parametrize("mode,shortlist_c", [("off", -1), ("off", 0),
                                              ("score", 0), ("topk", 0)])
def test_mesh_solve_contended_matches_reference(mode, shortlist_c):
    """The contended shape (shortlists drain, escapes fire) on 8 flat
    shards, across wave-scorer modes and the shortlist on and off."""
    args = ref_sh.kernel_args(contended_problem())
    kw = dict(has_spread=False, has_distinct=False, pallas_mode=mode,
              shortlist_c=shortlist_c)
    ref = mesh_solve(args, 8, **kw)
    port = port_sh.sharded_solve_args(args, port_mesh(("nodes", 8)), **kw)
    assert_like_reference(ref, port)
    assert_like_flat(port_flat(args, **kw), port)


@pytest.mark.parametrize("grid", [("hosts", 4, 2), ("regions", 2, 2, 2)])
def test_tiered_mesh_solve_matches_reference(grid):
    """The two- and three-tier merges equal the reference's tiers."""
    args = ref_sh.kernel_args(contended_problem())
    kw = dict(has_spread=False, has_distinct=False, shortlist_c=0)
    ref = ref_mesh_solve(args, grid, **kw)
    port = port_sh.sharded_solve_args(args, port_mesh(grid), **kw)
    assert_like_reference(ref, port)


@pytest.mark.parametrize("grid", [
    ("nodes", 2), ("nodes", 4), ("hosts", 2, 4), ("hosts", 8, 1),
    ("hosts", 1, 8), ("regions", 2, 2, 2), ("regions", 4, 1, 2),
    ("regions", 2, 1, 4)])
@pytest.mark.parametrize("shortlist_c", [-1, 0])
def test_every_mesh_shape_equals_flat(grid, shortlist_c):
    """Every mesh shape and width gives the flat solve's placements,
    scores and counters bit for bit; without the shortlist every wave is
    a full pass on every shard."""
    args = ref_sh.kernel_args(contended_problem())
    kw = dict(has_spread=False, has_distinct=False, shortlist_c=shortlist_c)
    mesh = port_mesh(grid)
    port = port_sh.sharded_solve_args(args, mesh, **kw)
    assert_like_flat(port_flat(args, **kw), port)
    if shortlist_c == -1:
        assert port.n_rescore == port.n_waves * mesh.size


@pytest.mark.parametrize("mode", ["off", "topk"])
def test_mesh_spread_interleave_matches_reference(mode):
    """Spread groups ride the merged per-value tables; on 8 shards of 6
    nodes the topk mode falls to score (the tables outgrow a shard)."""
    args = ref_sh.kernel_args(spread_problem())
    kw = dict(has_spread=True, has_distinct=False, pallas_mode=mode,
              shortlist_c=0)
    ref = mesh_solve(args, 8, **kw)
    port = port_sh.sharded_solve_args(args, port_mesh(("nodes", 8)), **kw)
    assert_like_reference(ref, port)
    assert_like_flat(port_flat(args, **kw), port)


def test_mesh_seeded_jitter_matches_reference_and_flat():
    """Seeded jitter hashes the GLOBAL node id: the split of the node
    axis changes nothing."""
    args = ref_sh.kernel_args(contended_problem())
    kw = dict(has_spread=False, has_distinct=False)
    ref = mesh_solve(args, 8, seed=3, **kw)
    port = port_sh.sharded_solve_args(args, port_mesh(("nodes", 8)),
                                      seed=3, **kw)
    assert_like_reference(ref, port)
    for grid in (("nodes", 4), ("regions", 2, 2, 2)):
        assert_like_flat(port_flat(args, seed=3, **kw),
                         port_sh.sharded_solve_args(args, port_mesh(grid),
                                                    seed=3, **kw))


@pytest.mark.parametrize("mode", ["score", "topk"])
def test_mesh_wave_inputs_are_contiguous(mode, monkeypatch):
    """Every tensor a mesh shard hands the wave kernel is contiguous, as
    the CUDA wrapper requires (on the CPU the plain version would take a
    strided view without a word); Gp > 1, so a column cut of a
    [Gp, Np + 1] plane would not be."""
    from nomad_tpu_torch.solver import wave_kernel as wk
    args = ref_sh.kernel_args(spread_problem())
    seen = []
    real = wk.fused_wave

    def strict(**kw):
        for name, v in kw.items():
            for t in (v if isinstance(v, tuple) else (v,)):
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), (mode, name)
        seen.append(kw["mode"])
        return real(**kw)
    monkeypatch.setattr(wk, "fused_wave", strict)
    port = port_sh.sharded_solve_args(
        args, port_mesh(("nodes", 4)), has_spread=True, has_distinct=True,
        pallas_mode=mode)
    assert seen and set(seen) == {mode}
    assert_like_flat(port_flat(args, has_spread=True, has_distinct=True,
                               pallas_mode=mode), port)


def test_mesh_shortlist_waves_engage():
    """The per-shard shortlist serves waves: full passes stay below
    waves x shards."""
    args = ref_sh.kernel_args(contended_problem())
    kw = dict(has_spread=False, has_distinct=False)
    on = port_sh.sharded_solve_args(args, port_mesh(("nodes", 2)),
                                    shortlist_c=0, **kw)
    assert on.n_waves >= 2 and on.n_rescore < on.n_waves * 2
    off = port_sh.sharded_solve_args(args, port_mesh(("nodes", 2)),
                                     shortlist_c=-1, **kw)
    assert off.n_rescore == off.n_waves * 2


# --------------------------------------------- the stateless wrappers
def test_rich_solve_batch_packs_like_reference():
    ref = ref_mock.rich_solve_batch(96, 12, seed_ix=3)
    port = port_mock.rich_solve_batch(96, 12, seed_ix=3)
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ref, name),
                                      getattr(port, name), err_msg=name)
    assert (ref.n_place, ref.n_real) == (port.n_place, port.n_real)


def test_sharded_solve_rich_matches_reference_and_flat():
    """Constraint, affinity, spread and a device ask at 256 nodes through
    the stateless wrapper: equal to the reference's sharded solve and to
    the port's flat solve."""
    pb = ref_mock.rich_solve_batch(256, 16)
    args = ref_sh.kernel_args(pb)
    ref = ref_sh.sharded_solve(pb, ref_sh.make_mesh(8, n_regions=1))
    port = port_sh.sharded_solve_args(
        args, port_sh.make_mesh(8, n_regions=1, devices=CPU))
    assert_like_reference(ref, port, rescore=False)
    assert host(port.choice_ok)[:pb.n_place, 0].all()
    for S in (2, 4):
        assert_like_flat(port_flat(args),
                         port_sh.sharded_solve_args(
                             args, port_sh.make_mesh(S, devices=CPU)))


def test_federated_solve_matches_reference_per_region():
    mesh_r = ref_sh.make_mesh(8, n_regions=2)
    pbs = [ref_mock.rich_solve_batch(128, 12, seed_ix=r) for r in range(2)]
    ref = ref_sh.federated_solve(pbs, mesh_r)
    port = port_sh.federated_solve(
        pbs, port_sh.make_mesh(8, n_regions=2, devices=CPU))
    for r, pb in enumerate(pbs):
        ok = np.asarray(ref.choice_ok)[r]
        np.testing.assert_array_equal(ok, host(port.choice_ok)[r])
        np.testing.assert_array_equal(
            np.where(ok, np.asarray(ref.choice)[r], -1),
            np.where(ok, host(port.choice)[r], -1))
        for f in ("n_feasible", "n_exhausted", "dim_exhausted",
                  "unfinished", "feas", "cons_filtered"):
            np.testing.assert_array_equal(np.asarray(getattr(ref, f))[r],
                                          host(getattr(port, f))[r],
                                          err_msg=f"region {r}: {f}")
        one = port_flat(ref_sh.kernel_args(pb), wave_mode="while",
                        shortlist_c=-1)
        assert torch.equal(one.choice, port.choice[r])
        assert torch.equal(one.score, port.score[r])


# --------------------------------------------------------- byte models
@pytest.mark.parametrize("Gp,K,TK,TKl,V,TW,want_tables,has_spread", [
    (4, 16, 36, 32, 4, 8, True, True),
    (64, 512, 132, 132, 4, 27, True, True),
    (16, 2048, 1028, 1028, 1, 0, False, False),
    (32, 128, 132, 16, 1, 0, False, False),
])
@pytest.mark.parametrize("S,H,Rg", [(8, 1, 1), (8, 4, 1), (8, 2, 2),
                                    (8, 1, 4), (6, 3, 1), (12, 1, 3)])
def test_byte_models_equal_reference(Gp, K, TK, TKl, V, TW, want_tables,
                                     has_spread, S, H, Rg):
    A, R = 24, 6
    TKv = -(-TK // (V + 1)) if want_tables else 0
    assert (ref_sh.model_ici_bytes(Gp, K, A, R, TKl, S, want_tables, V, TW,
                                   has_spread)
            == port_sh.model_ici_bytes(Gp, K, A, R, TKl, S, want_tables, V,
                                       TW, has_spread))
    assert (ref_sh.model_ici_dcn_bytes(Gp, K, A, R, TK, TKl, S, H,
                                       want_tables, V, TKv, TW, has_spread)
            == port_sh.model_ici_dcn_bytes(Gp, K, A, R, TK, TKl, S, H,
                                           want_tables, V, TKv, TW,
                                           has_spread))
    if (S // Rg) % H == 0:
        assert (ref_sh.model_ici_dcn_wan_bytes(
            Gp, K, A, R, TK, TKl, S, Rg, H, want_tables, V, TKv, TW,
            has_spread)
            == port_sh.model_ici_dcn_wan_bytes(
            Gp, K, A, R, TK, TKl, S, Rg, H, want_tables, V, TKv, TW,
            has_spread))


# -------------------------------------------- the mesh-resident stream
STREAM_GRIDS = [("nodes", 8), ("hosts", 4, 2), ("regions", 2, 2, 2)]


def _stream(side, grid=None, seeds=(3, 5, 7, 11)):
    nodes = make_nodes(side, 384)
    if grid is None:
        rs = side.solver(nodes, probes(side), gp=4, kp=64)
    elif side.name == "ref":
        rs = ref_sh.ShardedResidentSolver(nodes, probes(side), gp=4, kp=64,
                                          pallas="off", mesh=ref_mesh(grid))
    else:
        rs = port_sh.ShardedResidentSolver(nodes, probes(side), gp=4, kp=64,
                                           pallas="off",
                                           mesh=port_mesh(grid))
    f32_layout(rs)
    bs = mixed_batches(side, rs, 4)
    return rs, bs, rs.solve_stream(bs, seeds=list(seeds))


@pytest.fixture(scope="module")
def port_flat_stream():
    return _stream(PORT)


@pytest.mark.parametrize("grid", STREAM_GRIDS)
def test_sharded_stream_matches_reference_and_flat(grid, port_flat_stream):
    rrs, rbs, rout = _stream(REF, grid)
    prs, pbs, pout = _stream(PORT, grid)
    assert prs.n_shards == 8 and prs._dev_node["avail"][0].shape[0] == 64
    for a, b in zip(rout[:2] + rout[3:], pout[:2] + pout[3:]):
        np.testing.assert_array_equal(host(a), host(b))
    np.testing.assert_array_max_ulp(np.where(rout[1], rout[2], 0.0),
                                    np.where(pout[1], pout[2], 0.0),
                                    maxulp=MAX_ULP)
    np.testing.assert_array_equal(rrs.last_waves, prs.last_waves)
    np.testing.assert_array_equal(rrs.last_rescore_waves,
                                  prs.last_rescore_waves)
    for a, b in zip(rrs.usage(), prs.usage()):
        np.testing.assert_array_equal(a, b)
    frs, _, fout = port_flat_stream
    for a, b in zip(fout, pout):
        np.testing.assert_array_equal(host(a), host(b))
    np.testing.assert_array_equal(frs.last_waves, prs.last_waves)
    for a, b in zip(frs.usage(), prs.usage()):
        np.testing.assert_array_equal(a, b)
    # the byte model and the measured counters, as the reference's
    rwt, pwt = rrs.wave_traffic(rbs), prs.wave_traffic(pbs)
    for key in ("ici", "dcn", "wan", "per_shard", "measured"):
        assert rwt.get(key) == pwt.get(key), key
    assert pwt["ici"]["bytes_ici_per_wave"] <= \
        pwt["ici"]["bound_candidate_keys"]
    assert rrs.measured_wave_counters() == prs.measured_wave_counters()


def test_sharded_stream_health_and_checksum(port_flat_stream):
    prs, _, _ = _stream(PORT, ("nodes", 8))
    used, dev_used = prs.usage()
    assert prs.health_counters() == PORT.health.health_host(
        prs.template, used, dev_used)
    assert prs.plane_checksum() == PORT.tz.template_checksum(prs.template)


@pytest.mark.parametrize("shortlist_c", [-1, 0])
def test_delta_interleavings_keep_mesh_equal_to_flat(shortlist_c):
    """Random place / stop / drain / join deltas applied to the mesh
    solver (owner-routed row scatters) and to the flat solver keep both
    solving alike, by node id."""
    rng = np.random.default_rng(11)
    nodes = make_nodes(PORT, 24)
    probe = probes(PORT)
    kw = dict(gp=4, kp=16, pallas="off", shortlist_c=shortlist_c)
    rs = port_sh.ShardedResidentSolver(nodes, probe, mesh=port_mesh(
        ("nodes", 8)), **kw)
    ss = PORT.solver(nodes, probe, **kw)
    live = {}
    join_seq = [n.id for n in nodes]
    next_i = len(nodes)
    for round_ in range(5):
        delta = ClusterDelta()
        for _ in range(int(rng.integers(1, 4))):
            op = rng.choice(["place", "stop", "drain", "join"])
            if op == "place":
                nid = join_seq[int(rng.integers(len(join_seq)))]
                a = make_alloc(PORT, f"a{round_}-{len(live)}-{nid}", nid,
                               int(rng.integers(100, 400)), 256)
                delta.place.append((nid, a))
                live[a.id] = (nid, a)
            elif op == "stop" and live:
                aid = list(live)[int(rng.integers(len(live)))]
                nid, a = live.pop(aid)
                delta.stop.append((nid, a))
            elif op == "drain" and len(join_seq) > 8:
                nid = join_seq.pop(int(rng.integers(len(join_seq))))
                delta.remove_node_ids.append(nid)
                for aid in [aid for aid, (n2, _) in live.items()
                            if n2 == nid]:
                    del live[aid]
            elif op == "join":
                n = make_node(PORT, next_i)
                next_i += 1
                delta.upsert_nodes.append(n)
                join_seq.append(n.id)
        assert rs.apply_delta(delta) == ss.apply_delta(delta)
        asks = [make_ask(PORT, f"j{round_}", 3,
                         cpu=int(rng.integers(200, 600)),
                         spread=bool(round_ % 2))]
        out_s = rs.solve_stream([rs.pack_batch(asks)])
        out_1 = ss.solve_stream([ss.pack_batch(asks)])
        for a, b in zip(out_s, out_1):
            np.testing.assert_array_equal(a, b, err_msg=f"round {round_}")
    for a, b in zip(rs.usage(), ss.usage()):
        np.testing.assert_array_equal(a, b)
    assert rs.plane_checksum() == ss.plane_checksum()


def preempting_stream(side, build):
    """Two overcommitted batches with evict_e=8 (tests/
    test_torch_resident.py overcommit): the first one's victims fed back
    before the second (the port: `apply_delta(evicted=True)`; the
    reference: a stop delta and its freed usage given back).  Returns
    (solver, outputs, victim masks)."""
    nodes, abn, asks = overcommit(side)
    rs = f32_layout(build(nodes, asks[0], abn))
    used0 = np.zeros_like(rs.template.used0)
    for i, n in enumerate(nodes):
        for a in abn[n.id]:
            used0[i] += side.tz.alloc_usage_vector(a)
    rs.reset_usage(used0=used0)
    live = {a.id: (n.id, a) for n in nodes for a in abn[n.id]}
    outs, evicts = [], []
    for b in range(2):
        out = rs.solve_stream([rs.pack_batch(asks[b])])
        ev = host(rs.last_evict)[0]
        outs.append(out)
        evicts.append(ev)
        d, freed = side.tz.ClusterDelta(), {}
        for p in range(out[0].shape[1]):
            if out[1][0][p, 0] and ev[p].any():
                ni = int(out[0][0][p, 0])
                for e in np.nonzero(ev[p])[0]:
                    aid = rs.template.ev_ids[ni][e]
                    if aid in live:
                        d.stop.append(live.pop(aid))
                        freed[ni] = freed.get(ni, 0) + \
                            side.tz.alloc_usage_vector(d.stop[-1][1])
        if d.empty():
            continue
        if side.name == "port":
            assert rs.apply_delta(d, evicted=True) == "delta"
        else:
            assert rs.apply_delta(d) == "delta"
            rs._used = rs._delta_add(
                rs._used, np.asarray(sorted(freed), np.int32),
                np.stack([freed[i] for i in sorted(freed)]))
    return rs, outs, evicts


@pytest.mark.parametrize("grid", [("nodes", 4), ("hosts", 2, 2)])
def test_preempting_mesh_stream_matches_reference_and_flat(grid):
    """The eviction pass on a mesh: each shard's best eviction key
    merges across shards and the owner applies its victim set; victims,
    choices and carried usage equal the reference's mesh and the port's
    flat solver, batch for batch."""
    kw = dict(evict_e=8, pallas="off", delta_threshold=1.0)
    rrs, routs, revs = preempting_stream(
        REF, lambda n, a, abn: ref_sh.ShardedResidentSolver(
            n, a, abn, mesh=ref_mesh(grid), **kw))
    prs, pouts, pevs = preempting_stream(
        PORT, lambda n, a, abn: port_sh.ShardedResidentSolver(
            n, a, abn, mesh=port_mesh(grid), **kw))
    frs, fouts, fevs = preempting_stream(
        PORT, lambda n, a, abn: PORT.solver(n, a, abn, **kw))
    assert any(e.any() for e in pevs), "the workload must evict"
    for ro, po, fo, re_, pe, fe in zip(routs, pouts, fouts, revs, pevs,
                                       fevs):
        assert_stream_equal(ro, po)
        for a, b in zip(fo, po):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(re_, pe)
        np.testing.assert_array_equal(fe, pe)
    for a, b, c in zip(rrs.usage(), prs.usage(), frs.usage()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert prs.plane_checksum() == rrs.plane_checksum()


def test_sharded_repack_fallback_keeps_parity():
    nodes = make_nodes(PORT, 16)
    probe = probes(PORT)
    kw = dict(gp=4, kp=16, pallas="off", delta_threshold=0.01)
    rs = port_sh.ShardedResidentSolver(nodes, probe,
                                       mesh=port_mesh(("nodes", 4)), **kw)
    ss = PORT.solver(nodes, probe, **kw)
    delta = ClusterDelta()
    for i, n in enumerate(nodes[:8]):
        delta.place.append((n.id, make_alloc(PORT, f"r{i}", n.id, 300,
                                             256)))
    assert rs.apply_delta(delta) == ss.apply_delta(delta) == "repack"
    asks = [make_ask(PORT, "after", 4)]
    for a, b in zip(rs.solve_stream([rs.pack_batch(asks)]),
                    ss.solve_stream([ss.pack_batch(asks)])):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the mesh itself
def test_arg_split_covers_solve_signature():
    assert len(port_sh._ARG_SPLIT) == port_sh._kernel_positional_count()
    pb = contended_problem()
    args = port_sh.kernel_args(pb)
    Np = pb.avail.shape[0]
    for i, (a, sp) in enumerate(zip(args, port_sh._ARG_SPLIT)):
        if sp is not None:
            assert np.shape(a)[sp] == Np, i


def test_one_device_mesh_repeats_the_device():
    mesh = port_sh.make_node_mesh(8, devices=CPU)
    assert mesh.size == 8 and set(mesh.flat_devices()) == set(CPU)
    assert mesh.shape == {"nodes": 8}
    two = port_sh._device_list(4, ["cpu", "meta"])
    assert [d.type for d in two] == ["cpu", "cpu", "meta", "meta"]
    with pytest.raises(ValueError):
        port_sh.make_two_tier_mesh(3, 8, devices=CPU)
    assert port_sh.mesh_node_axes(port_mesh(("regions", 2, 2, 2))) == (
        ("regions", "hosts", "chips"), 2)
    assert port_sh.mesh_region_count(port_mesh(("regions", 2, 2, 2))) == 2


def test_mesh_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sh.make_node_mesh(8)


def test_mesh_requests_need_solve_shards():
    args = ref_sh.kernel_args(contended_problem())
    t = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in args[:-1])
    with pytest.raises(ValueError, match="solve_shards"):
        port_kernel.solve_kernel(*t, int(args[-1]), mesh_axis="nodes",
                                 mesh_shards=2)
    steps = port_kernel.solve_steps(*t, int(args[-1]), mesh_axis="nodes",
                                    mesh_shards=2)
    with pytest.raises(RuntimeError, match="solve_shards"):
        port_kernel.solve_lanes([steps])


def test_drop_scatter_never_writes_the_last_row():
    """A pinned out-of-shard index (Np) is dropped, not clamped onto
    row Np - 1."""
    base = torch.zeros((4, 2))
    out = port_kernel._add_drop(base, (torch.tensor([3, 4, 4]),),
                                torch.ones((3, 2)))
    assert out.shape == (4, 2)
    assert out[3].tolist() == [1.0, 1.0] and out[:3].sum() == 0
    # on the node axis of a [Gp, Np] plane (the collocation counts)
    cols = port_kernel._add_drop(torch.zeros((2, 4)),
                                 (torch.tensor([0, 1, 1]),
                                  torch.tensor([4, 2, 3])),
                                 torch.tensor([5.0, 7.0, 1.0]), 1)
    assert cols.tolist() == [[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 7.0, 1.0]]
    assert cols.is_contiguous()
