"""The port's elastic mesh against the JAX package's, on the CPU.

`build_pair` makes the reference's and the port's
ElasticShardedResidentSolver from the same nodes (fixed ids, each
package's own mock) on the same mesh shape: the reference on the
conftest's eight virtual CPU devices, the port on shards that all sit on
`cpu`; both with `pallas="off"` and the reference's
`NOMAD_TPU_SHARD_TILE` / `NOMAD_TPU_RESHARD_SLACK` unset (the port's
defaults).  After the same grow, move, shrink,
fail and recover steps, interleaved with place / stop / drain / join
deltas, both hold the same TileLayout tables (owner, slot, node_gid),
the same reshard byte counters, the same carried usage and the same
stream results (scores within the binpack bound, 4 ulp); and every step's
stream equals the port's flat solver packed from scratch over the live
nodes.
"""
import numpy as np
import pytest

from nomad_tpu.parallel import sharded as ref_sh
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.utils.tracing import MeshEventLog as RefEventLog
from nomad_tpu_torch.parallel import sharded as port_sh
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.telemetry import health as port_health
from nomad_tpu_torch.utils.tracing import MeshEventLog
from tests.test_torch_resident import (MAX_ULP, SIDES, host, make_alloc,
                                       make_ask, make_node, make_nodes,
                                       probes)
from tests.test_torch_sharded import port_mesh, ref_mesh

REF, PORT = SIDES


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    for k in ("NOMAD_TPU_SHARD_TILE", "NOMAD_TPU_RESHARD_SLACK",
              "NOMAD_TPU_MESH_HOSTS", "NOMAD_TPU_MESH_REGIONS",
              "NOMAD_TPU_SHORTLIST_C", "NOMAD_TPU_FUSED_LANES",
              "NOMAD_TPU_DELTA_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)


def build_pair(n_nodes, grid, **kw):
    """(reference, port) elastic solvers over the same nodes and mesh
    shape, each with its own event log."""
    kw.setdefault("gp", 4)
    kw.setdefault("kp", 16)
    kw.setdefault("pallas", "off")
    ref = ref_sh.ElasticShardedResidentSolver(
        make_nodes(REF, n_nodes), probes(REF), mesh=ref_mesh(grid),
        event_log=RefEventLog(), **kw)
    port = port_sh.ElasticShardedResidentSolver(
        make_nodes(PORT, n_nodes), probes(PORT), mesh=port_mesh(grid),
        event_log=MeshEventLog(), **kw)
    return ref, port


def assert_same_layout(ref, port):
    rl, pl = ref._layout, port._layout
    assert (rl.tile_np, rl.n_shards, rl.n_tiles, rl.cap_tiles) == (
        pl.tile_np, pl.n_shards, pl.n_tiles, pl.cap_tiles)
    np.testing.assert_array_equal(rl.owner, pl.owner)
    np.testing.assert_array_equal(rl.slot, pl.slot)
    NT = ref.template.avail.shape[0]
    assert NT == port.template.avail.shape[0]
    np.testing.assert_array_equal(rl.node_gid(NT), pl.node_gid(NT))
    np.testing.assert_array_equal(np.asarray(ref._dev_gid),
                                  port._fetch_rows(port._dev_gid))
    assert ref.mesh_state == port.mesh_state
    assert ref.n_shards == port.n_shards
    # (degraded_solves counts solves, and the scenario below solves the
    # port twice a round)
    rc = dict(ref.reshard_counters, last_recovery_s=0, degraded_solves=0)
    pc = dict(port.reshard_counters, last_recovery_s=0, degraded_solves=0)
    assert rc == pc


def assert_same_stream(ref_out, port_out, what):
    rc, rok, rsc, rst = ref_out
    pc, pok, psc, pst = port_out
    np.testing.assert_array_equal(rok, pok, err_msg=what)
    np.testing.assert_array_equal(np.where(rok, rc, -1),
                                  np.where(pok, pc, -1), err_msg=what)
    np.testing.assert_array_equal(rst, pst, err_msg=what)
    np.testing.assert_array_max_ulp(np.where(rok, rsc, 0.0),
                                    np.where(pok, psc, 0.0),
                                    maxulp=MAX_ULP)


def solve_ids(solver, pb):
    choice, ok, score, status = solver.solve_stream([pb])
    n = pb.n_place
    ids = [solver.template.node_ids[int(choice[0, p, 0])]
           if ok[0, p, 0] else None for p in range(n)]
    return ids, score[0, :n, 0].copy(), status[0, :n].copy()


def lost_node_ids(es):
    out = set()
    tile = es.tile_np
    for t in es._lost_tiles:
        for i in range(t * tile, (t + 1) * tile):
            if i < len(es.template.node_ids) and es.template.valid[i]:
                out.add(es.template.node_ids[i])
    return out


def mirror_used(solver, live):
    used = np.zeros_like(solver.template.used0)
    for nid, alloc in live.values():
        i = solver.node_index.get(nid)
        if i is not None:
            used[i] += port_tz.alloc_usage_vector(alloc)
    return used


class Cluster:
    """The same random deltas for both packages (fixed ids)."""

    def __init__(self, n):
        self.join_seq = [f"node-{i}" for i in range(n)]
        self.next_i = n
        self.live = {}         # alloc id -> node id
        self.n_alloc = 0

    def delta(self, rng):
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            op = str(rng.choice(["place", "stop", "drain", "join"]))
            if op == "place":
                nid = self.join_seq[int(rng.integers(len(self.join_seq)))]
                aid = f"alloc-{self.n_alloc}"
                self.n_alloc += 1
                self.live[aid] = nid
                ops.append(("place", nid, aid,
                            int(rng.integers(100, 400))))
            elif op == "stop" and self.live:
                aid = sorted(self.live)[int(rng.integers(len(self.live)))]
                ops.append(("stop", self.live.pop(aid), aid))
            elif op == "drain" and len(self.join_seq) > 8:
                nid = self.join_seq.pop(int(rng.integers(
                    len(self.join_seq))))
                for aid in [a for a, n in self.live.items() if n == nid]:
                    del self.live[aid]
                ops.append(("drain", nid))
            elif op == "join":
                ops.append(("join", self.next_i))
                self.join_seq.append(f"node-{self.next_i}")
                self.next_i += 1
        return ops

    @staticmethod
    def build(side, ops, allocs):
        """A ClusterDelta of `side`; `allocs` keeps each side's alloc
        objects (a stop must carry the placed one)."""
        d = side.tz.ClusterDelta()
        for op in ops:
            if op[0] == "place":
                _, nid, aid, cpu = op
                a = make_alloc(side, aid, nid, cpu, 256)
                allocs[aid] = (nid, a)
                d.place.append((nid, a))
            elif op[0] == "stop":
                _, nid, aid = op
                d.stop.append(allocs.pop(aid))
            elif op[0] == "drain":
                d.remove_node_ids.append(op[1])
                for aid in [a for a, (n, _) in allocs.items()
                            if n == op[1]]:
                    del allocs[aid]
            else:
                d.upsert_nodes.append(make_node(side, op[1]))
        return d


def reshard_op(rng, es):
    """One random reshard step, decided on the reference solver's state
    (the port must take the same one)."""
    rop = str(rng.choice(["none", "grow", "shrink", "move", "kill",
                          "rejoin"]))
    arg = None
    if rop == "move":
        lay = es._layout
        owned = [t for t in range(lay.n_tiles) if lay.owner[t] >= 0]
        if owned:
            t = owned[int(rng.integers(len(owned)))]
            dsts = [s for s in range(lay.n_shards)
                    if s != lay.owner[t] and lay.free_slots(s) > 0]
            arg = (t, dsts[int(rng.integers(len(dsts)))]) if dsts else None
    elif rop == "kill":
        arg = int(rng.integers(es.n_shards))
    return rop, arg


def apply_reshard(es, rop, arg):
    if rop == "grow" and es.mesh_state == "healthy":
        try:
            es.grow_tiles(1)
        except ValueError:
            pass                        # slack exhausted
    elif rop == "shrink":
        es.shrink_tiles(1)
    elif rop == "move" and arg is not None:
        es.move_tile(*arg)
    elif rop == "kill" and es.mesh_state == "healthy":
        es.fail_shard(arg)
    elif rop == "rejoin" and es.mesh_state == "degraded":
        es.recover()


@pytest.mark.parametrize("grid,seed,shortlist_c", [
    (("hosts", 4, 2), 3, 0), (("nodes", 8), 11, -1),
    (("regions", 2, 2, 2), 29, 0)])
def test_reshard_fail_rejoin_follow_reference_and_from_scratch(
        grid, seed, shortlist_c):
    """Random reshard steps interleaved with deltas: layout tables,
    counters, usage and streams equal the reference's at every step, and
    the port's stream equals a flat solver packed from scratch over the
    live nodes (during a degraded step: the surviving nodes)."""
    rng = np.random.default_rng(seed)
    ref, port = build_pair(24, grid, shortlist_c=shortlist_c)
    assert_same_layout(ref, port)
    cl = Cluster(24)
    allocs = {"ref": {}, "port": {}}
    for round_ in range(6):
        ops = cl.delta(rng)
        kinds = [s.apply_delta(Cluster.build(side, ops, allocs[side.name]))
                 for s, side in ((ref, REF), (port, PORT))]
        assert kinds[0] == kinds[1], round_
        rop, arg = reshard_op(rng, ref)
        apply_reshard(ref, rop, arg)
        apply_reshard(port, rop, arg)
        assert_same_layout(ref, port)
        what = f"round {round_} ({rop})"
        # the same fresh usage on both, then one solve each
        live = {a: v for a, v in allocs["port"].items()}
        port.reset_usage(used0=mirror_used(port, live))
        ref.reset_usage(used0=mirror_used(port, live))
        asks = [make_ask(side, f"ask{round_}", 3,
                         cpu=300 + 100 * (round_ % 3),
                         spread=bool(round_ % 2)) for side in (REF, PORT)]
        outs = [s.solve_stream([s.pack_batch([a])])
                for s, a in zip((ref, port), asks)]
        assert_same_stream(*outs, what)
        for a, b in zip(ref.usage(), port.usage()):
            np.testing.assert_array_equal(a, b, err_msg=what)
        # the port against a from-scratch flat pack of the live nodes
        lost = lost_node_ids(port)
        cur = [n for n in port.nodes if n.id in set(cl.join_seq)
               and n.id not in lost]
        flat = PORT.solver(cur, probes(PORT), gp=4, kp=16,
                           shortlist_c=shortlist_c)
        flat.reset_usage(used0=mirror_used(flat, {
            a: v for a, v in live.items() if v[0] not in lost}))
        port.reset_usage(used0=mirror_used(port, live))
        ids_e, sc_e, st_e = solve_ids(port, port.pack_batch([asks[1]]))
        ids_f, sc_f, st_f = solve_ids(flat, flat.pack_batch([asks[1]]))
        assert ids_e == ids_f, what
        np.testing.assert_array_equal(sc_e, sc_f, err_msg=what)
        np.testing.assert_array_equal(st_e, st_f, err_msg=what)
        # the planes as the template holds them whenever every tile is
        # resident (a retired or lost tile's rows are not on the device)
        if (port._layout.owner >= 0).all():
            assert port.plane_checksum() == \
                port_tz.template_checksum(port.template), what
    if port.mesh_state == "degraded":
        ref.recover()
        port.recover()
        assert_same_layout(ref, port)


def test_reclaimed_tile_ships_every_plane():
    """Joining nodes in a retired tile re-own it, and the tile ships
    every plane from the template.  The reference loses the shipped
    `avail` rows (its delta scatter writes into the array it held before
    the ship), so its reclaimed tile keeps stale avail rows on dead
    slots; the port's planes equal the template (ROADMAP.md Queue 3)."""
    ref, port = build_pair(24, ("hosts", 4, 2))
    tile = port.tile_np
    for s in (ref, port):
        assert s.shrink_tiles(1) == [3]          # rows 24-31: padding
        s.move_tile(2, 0)                        # a dead, stale location
        assert s.shrink_tiles(1) == []
    assert_same_layout(ref, port)
    for s, side in ((ref, REF), (port, PORT)):
        d = side.tz.ClusterDelta()
        d.upsert_nodes = [make_node(side, i) for i in range(24, 27)]
        assert s.apply_delta(d) == "delta"
    assert_same_layout(ref, port)
    assert port._layout.owner[3] >= 0
    assert port.plane_checksum() == port_tz.template_checksum(port.template)
    np.testing.assert_array_equal(
        port._back(port._dev_node["avail"])[3 * tile:4 * tile],
        port.template.avail[3 * tile:4 * tile])
    ids = [solve_ids(s, s.pack_batch([make_ask(side, "j", 4)]))[0]
           for s, side in ((ref, REF), (port, PORT))]
    assert ids[0] == ids[1]


def test_tile_layout_and_pick_match_reference():
    for np_pad, S in ((64, 8), (512, 8), (1024, 4), (50176, 8),
                      (12288, 3)):
        assert ref_tz.pick_tile_np(np_pad, S) == \
            port_tz.pick_tile_np(np_pad, S)
        tile = port_tz.pick_tile_np(np_pad, S)
        r = ref_tz.TileLayout(np_pad // tile, S, tile)
        p = port_tz.TileLayout(np_pad // tile, S, tile)
        for lay in (r, p):
            lay.grow(2)
            lay.assign(lay.n_tiles - 1, lay.least_loaded())
            lay.release(0)
        np.testing.assert_array_equal(r.owner, p.owner)
        np.testing.assert_array_equal(r.slot, p.slot)
        np.testing.assert_array_equal(r.dev_src(), p.dev_src())
        np.testing.assert_array_equal(r.node_gid(np_pad),
                                      p.node_gid(np_pad))
        for a, b in zip(r.tables(), p.tables()):
            np.testing.assert_array_equal(a, b)
        g = np.arange(0, np_pad, 7)
        np.testing.assert_array_equal(r.g2d(g, "drop"), p.g2d(g, "drop"))
        q = r.remap_shards({i: i for i in range(1, S)}, S)
        w = p.remap_shards({i: i for i in range(1, S)}, S)
        np.testing.assert_array_equal(q.owner, w.owner)
    with pytest.raises(ValueError):
        port_tz.pick_tile_np(64, 8, tile_np=24)
    assert port_tz.pick_tile_np(64, 8, tile_np=16) == 16


def test_extend_template_rows_matches_reference():
    rt = REF.solver(make_nodes(REF, 40), probes(REF), evict_e=4).template
    pt = PORT.solver(make_nodes(PORT, 40), probes(PORT), evict_e=4).template
    ref_tz.extend_template_rows(rt, 16)
    port_tz.extend_template_rows(pt, 16)
    for name, _ in port_tz._NODE_AXIS_FILLS:
        np.testing.assert_array_equal(getattr(rt, name), getattr(pt, name),
                                      err_msg=name)
    assert rt.ev_ids == pt.ev_ids


def test_owner_masked_scatters_route_and_drop():
    """A delta row lands on the shard that owns its tile and nowhere
    else; a row of a lost tile drops on the device while the template
    keeps it."""
    _, port = build_pair(24, ("nodes", 8))
    lay = port._layout
    before = [host(p).copy() for p in port._used]
    row = 2 * lay.tile_np + 1                # a row of tile 2
    port._delta_add(port._used, np.array([row]), np.ones((1, 4),
                                                         np.float32))
    after = [host(p) for p in port._used]
    owner, slot = int(lay.owner[2]), int(lay.slot[2])
    for s in range(port.n_shards):
        diff = after[s] - before[s]
        if s == owner:
            assert diff[slot * lay.tile_np + 1].tolist() == [1.0] * 4
            assert diff.sum() == 4
        else:
            assert not diff.any()
    lost = port.fail_shard(owner)
    assert 2 in lost
    snap = port._fetch_rows(port._used).copy()
    port._delta_add(port._used, np.array([row]), np.ones((1, 4),
                                                         np.float32))
    np.testing.assert_array_equal(port._fetch_rows(port._used), snap)
    assert port._layout.g2d(np.array([row]), "drop")[0] == \
        port._layout.n_slots


def test_health_live_mask_merge_and_tiers():
    """After a shard loss the health kernel sees only the resident rows:
    equal to the reference's and to the host twin over the row mask;
    merge and the report's tier bytes as the reference's."""
    ref, port = build_pair(40, ("hosts", 4, 2), evict_e=4)
    for s in (ref, port):
        s.fail_shard(2)
    hc = port.health_counters()
    ref_hc = ref.health_counters()
    assert vars(hc) == vars(ref_hc)
    twin = port_health.health_host(port.template, *port.usage(),
                                   row_mask=port.health_row_mask())
    assert hc == twin
    assert hc.nodes_valid < sum(port.template.valid)
    merged = hc.merge(twin)
    assert vars(merged) == vars(ref_hc.merge(ref_hc))
    pb = [port.pack_batch([make_ask(PORT, "h", 4)])]
    port.solve_stream(pb)
    ref.solve_stream([ref.pack_batch([make_ask(REF, "h", 4)])])
    tiers = port_health.tier_bytes(port, pb)
    assert set(tiers) == {"hbm", "ici", "dcn"}
    rep = hc.report(tiers=tiers)
    assert rep["tier_bytes"] == tiers
    assert port_health.tier_bytes(port, None) == {}
    for s in (ref, port):
        s.recover()
    assert vars(port.health_counters()) == vars(ref.health_counters())


def test_grow_ships_only_the_new_tile():
    _, es = build_pair(40, ("hosts", 4, 2))
    t = es.template
    full = sum(getattr(t, n).nbytes for n in (
        "avail", "reserved", "valid", "node_dc", "attr_rank", "dev_cap",
        "used0", "dev_used0"))
    es.grow_tiles(1)
    grew = es.reshard_counters["last_reshard_bytes"]
    assert 0 < grew < full / 4
    assert grew <= full * es.tile_np / es.template.avail.shape[0] + 4096
    lay = es._layout
    tile = next(t for t in range(lay.n_tiles) if lay.owner[t] >= 0)
    dst = next(s for s in range(lay.n_shards)
               if s != lay.owner[tile] and lay.free_slots(s) > 0)
    assert 0 < es.move_tile(tile, dst) < full / 4
    assert [e["kind"] for e in es.event_log.events()] == ["grow", "move"]


def test_repack_while_degraded_recovers_first():
    _, es = build_pair(24, ("hosts", 4, 2), delta_threshold=0.25)
    ss = PORT.solver(make_nodes(PORT, 24), probes(PORT), gp=4, kp=16,
                     delta_threshold=0.25)
    tile = es.tile_np
    pinned = es.template.node_ids[es._layout.tiles_of(2)[0] * tile]
    for s in (es, ss):
        d = PORT.tz.ClusterDelta()
        d.place.append((pinned, make_alloc(PORT, "pin", pinned, 333, 256)))
        assert s.apply_delta(d) == "delta"
    es.fail_shard(2)
    for s in (es, ss):
        d = PORT.tz.ClusterDelta()
        d.upsert_nodes = [make_node(PORT, i, cpu=4500) for i in range(12,
                                                                       24)]
        assert s.apply_delta(d) == "repack"
    assert es.mesh_state == "healthy"
    assert es.reshard_counters["recoveries"] == 1
    u_e, u_s = es.usage()[0], ss.usage()[0]
    np.testing.assert_array_equal(u_e[es.node_index[pinned]],
                                  u_s[ss.node_index[pinned]])
    asks = [make_ask(PORT, "x", 3)]
    assert solve_ids(es, es.pack_batch(asks))[0] == \
        solve_ids(ss, ss.pack_batch(asks))[0]


# ------------------------------------------------ the recovery trigger
def test_supervisor_gossip_and_node_event_triggers():
    from nomad_tpu_torch.structs.consts import (NODE_STATUS_DOWN,
                                                NODE_STATUS_READY)
    _, es = build_pair(24, ("hosts", 4, 2))
    sup = port_sh.ElasticMeshSupervisor(es)
    sup.register_host("host-a", 1)

    class Member:
        def __init__(self, mid):
            self.id = mid

    sup.on_fail(Member("host-unknown"))          # unregistered: no-op
    assert es.mesh_state == "healthy"
    sup.on_fail(Member("host-a"))
    assert es.mesh_state == "degraded"
    sup.on_fail(Member("host-a"))                # idempotent
    sup.on_join(Member("host-a"))
    assert es.mesh_state == "healthy"
    assert sup.events == [("fail", "host-a"), ("recover", "host-a")]
    sup.register_host("node-7", 0)
    sup.note_node_event("node-7", NODE_STATUS_DOWN)
    assert es.mesh_state == "degraded"
    sup.note_node_event("node-7", NODE_STATUS_READY)
    assert es.mesh_state == "healthy"
    kinds = [e["kind"] for e in es.event_log.events()]
    assert kinds.count("supervisor.fail") == 2
    assert kinds.count("supervisor.recover") == 2


def test_worker_node_update_eval_feeds_mesh_supervisor():
    """A node-update eval through the worker reports the node's status to
    the attached supervisor before the solve."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.server.worker import Worker
    from nomad_tpu_torch.structs import NODE_STATUS_DOWN

    server = Server(num_workers=0, device="cpu")
    server.start()
    try:
        node = mock.node()
        server.register_node(node)
        job = mock.job()
        job.task_groups[0].count = 1
        server.register_job(job)
        w = Worker(server, ["service"])
        assert w.mesh_supervisor is None
        for ev, token in server.broker.dequeue_batch(["service"], 8, 1.0):
            w._process(ev, token)
        events = []

        class Recorder:
            def note_node_event(self, nid, status):
                events.append((nid, status))

        w.mesh_supervisor = Recorder()
        server.update_node_status(node.id, NODE_STATUS_DOWN)
        batch = server.broker.dequeue_batch(["service"], 8, 1.0)
        assert batch, "node-down must create a node-update eval"
        for ev, token in batch:
            w._process(ev, token)
        assert (node.id, NODE_STATUS_DOWN) in events
    finally:
        server.stop()
