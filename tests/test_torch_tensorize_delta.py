"""The port's incremental tensorize (`ClusterDelta` / `delta_pack` /
`apply_node_delta_host` / `repack_asks`) against the JAX package's, on
the CPU.

Every case is built by ONE function for both packages (each package's
own mock, structs and Tensorizer) with fixed node ids; random choices
are drawn once and replayed on both.  After every delta:

  * the NodeDelta scatter arrays and the template planes equal the
    reference's,
  * the ask-side planes `repack_asks` gives equal the reference's, and
  * the repacked batch solves (the port's `solve_kernel`, wave modes
    off / score / topk) to the same nodes, score bits and status as a
    from-scratch full pack of the current cluster (nodes compared by id:
    removed nodes stay as valid=False tombstones, so slot indices shift
    against a compacted pack, but the tie-break ORDER of surviving nodes
    is kept) and under `assert_same` to the reference's numpy twin on
    the reference's repacked batch.

Follows tests/test_tensorize_delta.py (:80, :159, :200, :235); the last
case holds that a solve with a `proposed_delta` leaves the resident
template bit-identical (after tests/test_plan_overlay.py:105).
"""
import copy

import numpy as np
import pytest
import torch

from test_host_solver import assert_same

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.solver import solve as ref_solve
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.solver.host import host_solve_kernel
from nomad_tpu.state.store import StateStore as RefStore
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.solver import kernel as port_kernel
from nomad_tpu_torch.solver import solve as port_solve
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.state.store import StateStore as PortStore

PKGS = {"ref": (ref_mock, ref_structs, ref_tz),
        "port": (port_mock, port_structs, port_tz)}

NODE_PLANES = ("avail", "reserved", "used0", "valid", "node_class",
               "node_dc", "attr_rank", "dev_cap", "dev_used0")
ASK_PLANES = tuple(f for f in port_tz.ARRAY_FIELDS if f not in NODE_PLANES)
DELTA_FIELDS = ("idx", "avail", "reserved", "valid", "node_class",
                "node_dc", "attr_rank", "dev_cap", "u_idx", "u_res",
                "u_dev")


def make_node(pkg, key, cpu=4000):
    mock = PKGS[pkg][0]
    i = key if isinstance(key, int) else 0
    nd = mock.node(id=f"node-{key}", name=f"node-{key}",
                   datacenter=f"dc{i % 2}")
    nd.node_resources.networks[0].ip = f"10.2.0.{i % 250 + 1}"
    nd.attributes["rack"] = f"r{i % 4}"
    nd.node_resources.cpu = cpu
    nd.node_resources.memory_mb = 16384
    nd.node_resources.disk_mb = 100_000
    nd.compute_class()
    return nd


def make_ask(pkg, count=3, cpu=500, rack=None, spread=False, jid="job"):
    mock, st, tz = PKGS[pkg]
    job = mock.job(id=jid)
    job.datacenters = ["dc0", "dc1"]
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = cpu
    if rack:
        job.constraints = [st.Constraint("${attr.rack}", rack, "!=")]
    if spread:
        job.spreads = [st.Spread(attribute="${node.datacenter}",
                                 weight=100)]
    return tz.PlacementAsk(job=job, tg=tg, count=count)


def make_alloc(pkg, cpu=300, mem=256):
    a = PKGS[pkg][0].alloc()
    tr = a.allocated_resources.tasks["web"]
    tr.cpu = cpu
    tr.memory_mb = mem
    tr.networks = []
    a.allocated_resources.shared.networks = []
    a.allocated_resources.shared.disk_mb = 100
    return a


def random_rounds(seed, n_nodes=10, n_rounds=6):
    """The random delta program of tests/test_tensorize_delta.py:80,
    drawn once as package-free ops: ("place", node, alloc, cpu),
    ("stop", alloc), ("drain", node), ("join", node), ("update", node)."""
    rng = np.random.default_rng(seed)
    live, join_seq, next_i, next_a = {}, list(range(n_nodes)), n_nodes, 0
    rounds = []
    for _ in range(n_rounds):
        ops = []
        for _ in range(int(rng.integers(1, 4))):
            op = rng.choice(["place", "stop", "drain", "join", "update"])
            if op == "place":
                nid = join_seq[int(rng.integers(len(join_seq)))]
                ops.append(("place", nid, next_a,
                            int(rng.integers(100, 400))))
                live[next_a] = nid
                next_a += 1
            elif op == "stop" and live:
                aid = list(live)[int(rng.integers(len(live)))]
                del live[aid]
                ops.append(("stop", aid))
            elif op == "drain" and len(join_seq) > 4:
                nid = join_seq.pop(int(rng.integers(len(join_seq))))
                for aid in [a for a, n in live.items() if n == nid]:
                    del live[aid]   # drained node's allocs stop with it
                ops.append(("drain", nid))
            elif op == "join":
                ops.append(("join", next_i))
                join_seq.append(next_i)
                next_i += 1
            elif op == "update":
                ops.append(("update",
                            join_seq[int(rng.integers(len(join_seq)))]))
        rounds.append(ops)
    return rounds


def _solve(pb, mode):
    has_spread = bool((pb.sp_col[:, 0] >= 0).any())
    res = port_kernel.solve_kernel(
        *port_solve._kernel_args(pb, "cpu"), 0, has_spread=has_spread,
        pallas_mode=mode)
    return port_solve._to_host(res)


def _by_node_id(pb, res):
    n = pb.n_place
    ids = [pb.node_ids[int(res.choice[p, 0])] if res.choice_ok[p, 0]
           else None for p in range(n)]
    return ids, res.score[:n, 0].copy(), res.unfinished[:n].copy()


def run_deltas(pkg, rounds, mode):
    """Replay `rounds` on `pkg`'s tensorizer; per round the NodeDelta,
    the template planes, the repacked batch and (port only) the solves
    of the repacked batch and of a full pack of the current cluster."""
    tz = PKGS[pkg][2]
    t = tz.Tensorizer()
    nodes = [make_node(pkg, i) for i in range(10)]
    probe = [make_ask(pkg, rack="r3", spread=True, jid="probe-0"),
             make_ask(pkg, jid="probe-1")]
    template = t.pack(nodes, probe)
    tnodes = list(nodes)
    node_index = {n.id: i for i, n in enumerate(tnodes)}
    cluster = {i: n for i, n in enumerate(nodes)}
    join_seq = list(range(10))
    live = {}                                   # alloc key -> (nid, alloc)
    out = []
    for r, ops in enumerate(rounds):
        delta = tz.ClusterDelta()
        for op in ops:
            if op[0] == "place":
                _, nk, ak, cpu = op
                a = make_alloc(pkg, cpu=cpu)
                delta.place.append((cluster[nk].id, a))
                live[ak] = (cluster[nk].id, a)
            elif op[0] == "stop":
                delta.stop.append(live.pop(op[1]))
            elif op[0] == "drain":
                nk = op[1]
                nid = cluster.pop(nk).id
                join_seq.remove(nk)
                delta.remove_node_ids.append(nid)
                for ak in [k for k, (n, _) in live.items() if n == nid]:
                    del live[ak]
            elif op[0] == "join":
                n = make_node(pkg, op[1])
                cluster[op[1]] = n
                join_seq.append(op[1])
                delta.upsert_nodes.append(n)
            else:
                n2 = copy.copy(cluster[op[1]])
                n2.node_resources = copy.deepcopy(n2.node_resources)
                n2.node_resources.cpu += 1000
                cluster[op[1]] = n2
                delta.upsert_nodes.append(n2)
        nd = t.delta_pack(template, node_index, delta)
        assert nd is not None, f"{pkg} round {r}: delta fell back"
        tz.apply_node_delta_host(template, nd, tnodes, node_index)
        # usage on drained (tombstoned) slots stays: valid=False gates it
        asks = [make_ask(pkg, count=3, cpu=400 + 100 * (r % 3),
                         spread=bool(r % 2), jid=f"ask-{r}")]
        rpb = t.repack_asks(tnodes, asks, template, gp=len(asks))
        assert rpb is not None
        rec = {"delta": {f: getattr(nd, f).copy() for f in DELTA_FIELDS},
               "ratio": nd.ratio(template.n_real),
               "node_ids": list(template.node_ids),
               "template": {f: getattr(template, f).copy()
                            for f in NODE_PLANES},
               "repack": rpb}
        if pkg == "port":
            cur = [cluster[k] for k in join_seq]
            by_node = {}
            for nid, a in live.values():
                by_node.setdefault(nid, []).append(a)
            fpb = tz.Tensorizer().pack(cur, asks, by_node)
            rec["res"] = _solve(rpb, mode)
            rec["solves"] = (_by_node_id(rpb, rec["res"]),
                             _by_node_id(fpb, _solve(fpb, mode)))
        else:
            # the reference's numpy twin, solved now: the template's
            # node planes move on with the next round
            rec["res"] = host_solve_kernel(
                *ref_solve._kernel_args(rpb), 0,
                has_spread=bool((rpb.sp_col[:, 0] >= 0).any()))
        out.append(rec)
    return out


@pytest.mark.parametrize("mode", ["off", "score", "topk"])
@pytest.mark.parametrize("seed", [7, 11])
def test_random_delta_interleavings_match_full_repack(seed, mode):
    rounds = random_rounds(seed)
    ref = run_deltas("ref", rounds, mode)
    port = run_deltas("port", rounds, mode)
    for r, (p, q) in enumerate(zip(port, ref)):
        for f in DELTA_FIELDS:
            assert p["delta"][f].dtype == q["delta"][f].dtype, (r, f)
            np.testing.assert_array_equal(p["delta"][f], q["delta"][f],
                                          err_msg=f"round {r}: {f}")
        assert p["ratio"] == q["ratio"]
        assert p["node_ids"] == q["node_ids"]
        for f in NODE_PLANES:
            np.testing.assert_array_equal(p["template"][f],
                                          q["template"][f],
                                          err_msg=f"round {r}: {f}")
        for f in ASK_PLANES:
            a, b = getattr(p["repack"], f), getattr(q["repack"], f)
            assert a.dtype == b.dtype, (r, f)
            np.testing.assert_array_equal(a, b, err_msg=f"round {r}: {f}")
        assert p["repack"].constraint_labels == q["repack"].constraint_labels
        (ids_inc, sc_inc, st_inc), (ids_full, sc_full, st_full) = \
            p["solves"]
        assert ids_inc == ids_full, f"round {r}: node choice diverged"
        np.testing.assert_array_equal(st_inc, st_full)
        np.testing.assert_array_equal(sc_inc, sc_full)
        assert_same(p["res"], q["res"])
        assert any(ids_inc)


def scatter_cases(pkg):
    """tests/test_tensorize_delta.py:159: a usage-only delta aggregated
    per slot, a join in a tail slot, None for an unseen dc and an unseen
    attr value, a drain as a valid=False tombstone."""
    tz = PKGS[pkg][2]
    t = tz.Tensorizer()
    nodes = [make_node(pkg, i) for i in range(6)]
    template = t.pack(nodes, [make_ask(pkg, rack="r3")])
    node_index = {n.id: i for i, n in enumerate(nodes)}
    weird = make_node(pkg, 7)
    weird.datacenter = "dc-new"
    weird2 = make_node(pkg, 8)
    weird2.attributes["rack"] = "r99"
    deltas = [
        tz.ClusterDelta(place=[(nodes[1].id, make_alloc(pkg, cpu=100)),
                               (nodes[1].id, make_alloc(pkg, cpu=200))]),
        tz.ClusterDelta(upsert_nodes=[make_node(pkg, 6)]),
        tz.ClusterDelta(upsert_nodes=[weird]),
        tz.ClusterDelta(upsert_nodes=[weird2]),
        tz.ClusterDelta(remove_node_ids=[nodes[2].id]),
        tz.ClusterDelta(stop=[("node-unknown", make_alloc(pkg))]),
    ]
    out = []
    for d in deltas:
        nd = t.delta_pack(template, node_index, d)
        out.append(None if nd is None else
                   ({f: getattr(nd, f) for f in DELTA_FIELDS},
                    nd.n_real_new, nd.touches_nodes(), nd.ratio(6)))
    return out, template


def test_delta_pack_scatter_arrays_and_fallbacks():
    port, template = scatter_cases("port")
    ref, _ = scatter_cases("ref")
    assert [p is None for p in port] == [r is None for r in ref] == [
        False, False, True, True, False, True]
    for p, r in zip(port, ref):
        if p is None:
            continue
        for f in DELTA_FIELDS:
            np.testing.assert_array_equal(p[0][f], r[0][f], err_msg=f)
        assert p[1:] == r[1:]
    usage, join, _, _, drain, _ = port
    assert not usage[2] and usage[0]["u_idx"].tolist() == [1]
    assert usage[0]["u_res"][0, 0] == 300.0
    assert join[1] == 7 and join[0]["idx"].tolist() == [6]
    assert bool(join[0]["valid"][0])
    assert drain[0]["idx"].tolist() == [2] and not drain[0]["valid"][0]
    np.testing.assert_array_equal(drain[0]["avail"][0], template.avail[2])


def world_case(pkg, case):
    """A store-attached solver's world through one forcing change:
    `threshold` (a delta over 0.25 of the nodes rebuilds) or `escape`
    (a join with an unseen rack value rebuilds with a new universe)."""
    mock, st, tz = PKGS[pkg]
    store = (RefStore if pkg == "ref" else PortStore)()
    ix = [100]

    def nix():
        ix[0] += 1
        return ix[0]

    nodes = [make_node(pkg, i) for i in range(8)]
    for n in nodes:
        store.upsert_node(nix(), n)
    if pkg == "ref":
        solver = ref_solve.Solver(store=store, resident_min_nodes=1,
                                  delta_threshold=0.25)
    else:
        assert port_solve.DELTA_THRESHOLD == 0.25
        solver = port_solve.Solver(device="cpu", store=store,
                                   resident_min_nodes=1, host="never")

    def solve(count=2):
        snap = store.snapshot()
        job = make_ask(pkg, count=count, rack="r3", jid="world").job
        asks = [tz.PlacementAsk(job=job, tg=job.task_groups[0],
                                count=count)]
        nodes_now, by_dc = snap.ready_nodes_in_dcs(job.datacenters)
        out = solver.solve(nodes_now, asks, {}, by_dc, snapshot=snap,
                           proposed_delta=((), ()))
        return ([p.node.id if p.node else None for p in out.placements],
                solver.resident_counters(), out.trace["resident"])

    steps = [solve()]
    a = make_alloc(pkg)
    a.node_id = nodes[0].id
    store.upsert_allocs(nix(), [a])
    steps.append(solve())                    # small delta: incremental
    if case == "threshold":
        for n in nodes[:6]:
            n2 = copy.copy(n)
            n2.node_resources = copy.deepcopy(n2.node_resources)
            n2.node_resources.cpu += 500
            store.upsert_node(nix(), n2)
    else:
        weird = make_node(pkg, 8)
        weird.attributes["rack"] = "r99"
        store.upsert_node(nix(), weird)
    steps.append(solve())
    t = solver._world.template
    return steps, {f: getattr(t, f).copy() for f in NODE_PLANES}, \
        list(t.node_ids), [rc._values for rc in t.rank_columns]


@pytest.mark.parametrize("case", ["threshold", "escape"])
def test_world_rebuilds_on_threshold_and_interning_escape(case):
    p_steps, p_planes, p_ids, p_cols = world_case("port", case)
    r_steps, r_planes, r_ids, r_cols = world_case("ref", case)
    assert p_steps == r_steps
    assert p_ids == r_ids and p_cols == r_cols
    for f in NODE_PLANES:
        np.testing.assert_array_equal(p_planes[f], r_planes[f], err_msg=f)
    (_, c0, res0), (_, c1, _), (placed, c2, res2) = p_steps
    assert res0 and res2 and all(placed)
    assert c1["delta_syncs"] == 1 and c1["repack_fallbacks"] == 0
    assert c2["repack_fallbacks"] == 1
    if case == "threshold":
        assert c2["last_delta_ratio"] > 0.25
    else:
        assert "node-8" in p_ids and any("r99" in c for c in p_cols)


def overlay_case(pkg):
    """Solves whose proposed_delta stops live allocs and adds probes
    leave the world's template, live map and index bit-identical, while
    the solved batch carries exactly the overlaid usage."""
    mock, st, tz = PKGS[pkg]
    store = (RefStore if pkg == "ref" else PortStore)()
    nodes = [make_node(pkg, i, cpu=3000) for i in range(8)]
    for i, n in enumerate(nodes):
        store.upsert_node(101 + i, n)
    allocs = []
    for k in range(6):                          # nodes 6, 7 stay empty
        a = make_alloc(pkg, cpu=2000)
        a.node_id = nodes[k].id
        a.client_status = st.ALLOC_CLIENT_RUNNING
        allocs.append(a)
    store.upsert_allocs(200, allocs)
    if pkg == "ref":
        solver = ref_solve.Solver(store=store, resident_min_nodes=1)
    else:
        solver = port_solve.Solver(device="cpu", store=store,
                                   resident_min_nodes=1, host="never")

    def fingerprint():
        w = solver._world
        t = w.template
        return ({f: getattr(t, f).copy() for f in NODE_PLANES},
                sorted(w.live), w.last_index, list(t.node_ids))

    def solve(count, delta):
        snap = store.snapshot()
        job = make_ask(pkg, count=count, cpu=1500, jid="overlay").job
        asks = [tz.PlacementAsk(job=job, tg=job.task_groups[0],
                                count=count)]
        nodes_now, by_dc = snap.ready_nodes_in_dcs(job.datacenters)
        out = solver.solve(nodes_now, asks, {}, by_dc, snapshot=snap,
                           proposed_delta=delta)
        return sorted(p.node.id for p in out.placements if p.node)

    solve(1, ((), ()))                          # builds the world
    fp = fingerprint()
    probe = make_alloc(pkg, cpu=2500)
    probe.node_id = nodes[6].id
    placed = []
    for count, delta in ((4, (allocs[:3], ())),
                         (2, ((), [probe])),
                         (3, (allocs[2:4], [probe])),
                         (8, ((), ()))):
        placed.append(solve(count, delta))
        after = fingerprint()
        assert after[1:] == fp[1:]
        for f in NODE_PLANES:
            np.testing.assert_array_equal(after[0][f], fp[0][f],
                                          err_msg=f"{pkg}: {f}")
    return placed, solver


def test_proposed_delta_leaves_template_bit_identical():
    p_placed, solver = overlay_case("port")
    r_placed, _ = overlay_case("ref")
    assert p_placed == r_placed
    # 2,900 MHz free on an empty node (100 reserved): one 1500-MHz
    # placement each.  Stops free the stopped nodes, the probe fills
    # node 6, and with no overlay only the two empty nodes take one
    assert len(p_placed[0]) == 4
    assert set(p_placed[0]) <= {"node-0", "node-1", "node-2", "node-6",
                                "node-7"}
    assert p_placed[1] == ["node-7"]
    assert p_placed[3] == ["node-6", "node-7"]
    # the overlay is a copy: the pending solve's batch differs from the
    # template only on the overlaid rows
    snap = solver._store.snapshot()
    job = make_ask("port", count=1, cpu=1500, jid="overlay").job
    asks = [port_tz.PlacementAsk(job=job, tg=job.task_groups[0], count=1)]
    pending = solver.solve_async([], asks, {}, {}, snapshot=snap,
                                 proposed_delta=([], []))
    pending.wait()
    assert pending.packed.used0 is not solver._world.template.used0
    np.testing.assert_array_equal(pending.packed.used0,
                                  solver._world.template.used0)
    assert isinstance(port_solve._kernel_args(pending.packed)[0],
                      torch.Tensor)


def test_ask_signatures_match_reference():
    """The row-cache keys: equal spec -> equal signature in both
    packages, and per-eval state or the job id does not change it."""
    def sigs(pkg):
        tz = PKGS[pkg][2]
        asks = [make_ask(pkg, rack="r3", spread=True, jid="sig-a"),
                make_ask(pkg, rack="r3", spread=True, jid="sig-b"),
                make_ask(pkg, cpu=700, jid="sig-c")]
        asks[1] = tz.PlacementAsk(job=asks[1].job, tg=asks[1].tg, count=1,
                                  penalty_nodes=frozenset({"node-1"}),
                                  existing_by_node={"node-2": 1})
        signer = tz.Tensorizer.ask_signer()
        return ([tz.Tensorizer.ask_signature(a) for a in asks],
                [signer(a) for a in asks])
    port, ref = sigs("port"), sigs("ref")
    assert port == ref
    full, signed = port
    assert full == signed
    assert full[0] == full[1] != full[2]


def test_storeless_solver_full_packs():
    """A Solver built without a store never takes the resident path,
    even when the caller passes a snapshot."""
    store = PortStore()
    for i in range(4):
        store.upsert_node(101 + i, make_node("port", i))
    solver = port_solve.Solver(device="cpu", resident_min_nodes=1)
    snap = store.snapshot()
    assert not solver.resident_active(snap)
    ask = make_ask("port", count=2)
    nodes, by_dc = snap.ready_nodes_in_dcs(ask.job.datacenters)
    out = solver.solve(nodes, [ask], {}, by_dc, snapshot=snap,
                       proposed_delta=((), ()))
    assert out.trace["resident"] is False and "world" not in out.trace
    assert solver.resident_counters() is None
    assert all(p.node is not None for p in out.placements)
