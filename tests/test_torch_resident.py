"""The port's streaming ResidentSolver against the JAX package's, on the
CPU.

One function makes the same cluster and asks for both packages (each
package's own mock and structs, fixed node and job ids, capacities drawn
from a numpy generator with a fixed seed); both solvers run with
`pallas="off"` and the reference's three environment knobs unset, so
both take the defaults the port's constructor arguments carry.  Per
batch the streams must agree on choices, ok flags, statuses, wave and
full-rescore counts and the carried usage; scores agree within
tests/test_score_spec.py's bound for the binpack pow (4 ulp).
"""
import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.solver import resident as ref_resident
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.telemetry import health as ref_health
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.solver import resident as port_resident
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.telemetry import health as port_health

#: the reference's score bound for the binpack pow (test_score_spec.py)
MAX_ULP = 4
ENV_KNOBS = ("NOMAD_TPU_SHORTLIST_C", "NOMAD_TPU_FUSED_LANES",
             "NOMAD_TPU_DELTA_THRESHOLD")


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


class Side:
    """One package's factories and its ResidentSolver."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            self.mock, self.st = ref_mock, ref_structs
            self.res, self.tz, self.health = ref_resident, ref_tz, ref_health
        else:
            self.mock, self.st = port_mock, port_structs
            self.res, self.tz, self.health = (port_resident, port_tz,
                                              port_health)

    def solver(self, nodes, probes, allocs_by_node=None, **kw):
        kw.setdefault("pallas", "off")
        if self.name == "port":
            kw["device"] = "cpu"
        return self.res.ResidentSolver(nodes, probes, allocs_by_node, **kw)


SIDES = (Side("ref"), Side("port"))


def make_node(side, i, cpu=None, mem=None, seed=0):
    """Node i of a cluster of 4 dcs, 8 racks and 16 zones, its cpu and
    memory drawn from a generator keyed on (seed, i)."""
    rng = np.random.default_rng([seed, i])
    nd = side.mock.node(id=f"node-{i}", name=f"node-{i}",
                        datacenter=f"dc{i % 4}")
    nd.attributes["rack"] = f"r{i % 8}"
    nd.attributes["zone"] = f"z{i % 16}"
    nd.reserved_resources.cpu = 0
    nd.reserved_resources.memory_mb = 0
    nd.reserved_resources.disk_mb = 0
    nd.node_resources.cpu = int(cpu if cpu is not None
                                else rng.choice([2000, 3000, 4000]))
    nd.node_resources.memory_mb = int(mem if mem is not None
                                      else rng.choice([4096, 8192]))
    nd.compute_class()
    return nd


def make_nodes(side, n, **kw):
    return [make_node(side, i, **kw) for i in range(n)]


def make_ask(side, jid, count, cpu=500, mem=256, spread=False, dc=None,
             affinity=False, constraint=False, priority=50):
    st = side.st
    job = side.mock.job(priority=priority)
    job.id = job.name = jid
    job.datacenters = [dc] if dc else [f"dc{d}" for d in range(4)]
    if spread:
        job.spreads = [st.Spread(attribute="${node.datacenter}",
                                 weight=50)]
    if affinity:
        job.affinities = [st.Affinity(ltarget="${attr.rack}", rtarget="r3",
                                      operand="=", weight=40)]
    if constraint:
        job.constraints = [st.Constraint("${attr.rack}", "r7", "!=")]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.ephemeral_disk.size_mb = 100
    return side.tz.PlacementAsk(job=job, tg=tg, count=count)


def make_alloc(side, aid, node_id, cpu, mem, priority=50, create_index=0):
    a = side.mock.alloc()
    a.id = aid
    a.node_id = node_id
    a.job.priority = priority
    a.create_index = create_index
    tr = a.allocated_resources.tasks["web"]
    tr.cpu, tr.memory_mb, tr.networks = cpu, mem, []
    a.allocated_resources.shared.networks = []
    a.allocated_resources.shared.disk_mb = 0
    return a


def probes(side):
    """The universe: the rack constraint, the mock job's default
    kernel.name constraint, the rack affinity and the dc spread."""
    return [make_ask(side, "probe", 4, spread=True, affinity=True,
                     constraint=True),
            make_ask(side, "probe-default", 4)]


def mixed_batches(side, rs, n_batches, count=24, tag="j"):
    """n_batches batches of two or three asks each: spreads, an
    affinity, a constraint, mixed sizes."""
    out = []
    for b in range(n_batches):
        asks = [make_ask(side, f"{tag}{b}a", count, cpu=700 + 100 * (b % 3),
                         spread=b % 2 == 0, affinity=b % 3 == 0),
                make_ask(side, f"{tag}{b}b", count // 2, cpu=400, mem=512,
                         constraint=True)]
        if b % 2:
            asks.append(make_ask(side, f"{tag}{b}c", 6, cpu=1200))
        pb = rs.pack_batch(asks)
        assert pb is not None
        out.append(pb)
    return out


def host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def f32_layout(rs):
    """Have a solver emit the f32 payload (exact scores) instead of the
    compact one."""
    rs._compact = False
    return rs


def assert_stream_equal(ref, port, what=""):
    """(choice, ok, score, status) of two streams."""
    rc, rok, rsc, rst = (host(x) for x in ref)
    pc, pok, psc, pst = (host(x) for x in port)
    np.testing.assert_array_equal(rok, pok, err_msg=f"{what} ok")
    np.testing.assert_array_equal(rc, pc, err_msg=f"{what} choice")
    np.testing.assert_array_equal(rst, pst, err_msg=f"{what} status")
    np.testing.assert_array_max_ulp(np.where(rok, rsc, 0.0),
                                    np.where(pok, psc, 0.0), maxulp=MAX_ULP)


def assert_counters_equal(rrs, prs):
    for a, b in ((rrs.last_waves, prs.last_waves),
                 (rrs.last_rescore_waves, prs.last_rescore_waves)):
        if isinstance(a, list):
            a = np.concatenate([np.asarray(x) for x in a])
            b = np.concatenate([np.asarray(x) for x in b])
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ru, rd = rrs.usage()
    pu, pd = prs.usage()
    np.testing.assert_array_equal(ru, pu)
    np.testing.assert_array_equal(rd, pd)


def both(fn):
    """fn(side) for the reference and the port."""
    return [fn(s) for s in SIDES]


# ------------------------------------------------------------- packing
def test_repack_matches_full_pack():
    """The port's ask-only repack equals the reference's plane for
    plane, and solves to the placements of the port's own full pack."""
    from nomad_tpu_torch.solver.solve import _run_kernel, _to_host

    def run(side):
        nodes = make_nodes(side, 320)
        rs = side.solver(nodes, probes(side), gp=4, kp=64)
        asks = [make_ask(side, "a", 12, spread=True, affinity=True),
                make_ask(side, "b", 8, constraint=True)]
        return rs, rs.pack_batch(asks), nodes, asks
    (_, rpb, *_), (prs, ppb, nodes, asks) = both(run)
    for name in port_resident._ASK_ARGS:
        np.testing.assert_array_equal(getattr(rpb, name),
                                      getattr(ppb, name), err_msg=name)
    full = port_tz.Tensorizer().pack(nodes, asks, None)
    r1 = _to_host(_run_kernel(ppb, "cpu"))
    r2 = _to_host(_run_kernel(full, "cpu"))
    n = full.n_place
    np.testing.assert_array_equal(r1.choice_ok[:n], r2.choice_ok[:n])
    ok = r2.choice_ok[:n]
    np.testing.assert_array_equal(r1.choice[:n][ok], r2.choice[:n][ok])


def test_merge_asks_matches_reference():
    def run(side):
        rs = side.solver(make_nodes(side, 320), probes(side), gp=4, kp=64)
        asks = [make_ask(side, f"m{k}", 5, cpu=500 + 100 * (k % 2))
                for k in range(6)]
        asks.append(make_ask(side, "d", 3))
        asks[-1].job.constraints = [side.st.Constraint(
            operand=side.st.CONSTRAINT_DISTINCT_HOSTS)]
        merged, keys = rs.merge_asks(asks)
        return [(a.job.id, a.count) for a in merged], keys
    ref, port = both(run)
    assert ref == port
    assert port[0] == [("m0", 15), ("m1", 15), ("d", 3)]


# ------------------------------------------------------------- streams
@pytest.mark.parametrize("seeded", [False, True])
def test_serial_stream_matches_reference(seeded):
    def run(side):
        rs = f32_layout(side.solver(make_nodes(side, 384), probes(side),
                                    gp=4, kp=64))
        bs = mixed_batches(side, rs, 4)
        out = rs.solve_stream(bs, seeds=[3, 5, 7, 11] if seeded else None)
        return rs, out
    (rrs, rout), (prs, pout) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    assert (host(pout[3])[:, :24] == port_resident.STATUS_COMMITTED).any()


def test_compact_payload_matches_reference():
    """The int16 payload: choice and status columns bit-equal, score
    columns (bf16 bits) equal or one bf16 ulp apart."""
    def run(side):
        rs = side.solver(make_nodes(side, 384), probes(side), gp=4, kp=64)
        assert rs._compact
        return host(rs.solve_stream_async(mixed_batches(side, rs, 3),
                                          seeds=[1, 2, 3]))
    ref, port = both(run)
    assert ref.dtype == port.dtype == np.int16
    tk = port_resident.TOP_K
    np.testing.assert_array_equal(ref[..., :tk], port[..., :tk])
    np.testing.assert_array_equal(ref[..., -1], port[..., -1])
    diff = np.abs(ref[..., tk:2 * tk].astype(np.int32)
                  - port[..., tk:2 * tk].astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_array_equal(
        port_resident.unpack_stream(port)[1],
        ref_resident.unpack_stream(ref)[1])


def test_capacity_exhaustion_fails_late_batches():
    def run(side):
        nodes = make_nodes(side, 320, cpu=1000, mem=8192)
        rs = f32_layout(side.solver(nodes, probes(side), gp=4, kp=512))
        bs = [rs.pack_batch([make_ask(side, f"x{b}", 200, cpu=900)])
              for b in range(3)]
        return rs, rs.solve_stream(bs)
    (rrs, rout), (prs, pout) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    status = pout[3]
    assert (status[0, :200] == 1).all()
    assert (status[1, :120] == 1).all() and (status[1, 120:200] == 0).all()
    assert (status[2, :200] == 0).all()


def test_wave_mode_while_equals_scan():
    def run(side, mode):
        rs = f32_layout(side.solver(make_nodes(side, 320, cpu=3000),
                                    probes(side), gp=4, kp=512,
                                    wave_mode=mode, max_waves=6))
        bs = [rs.pack_batch([make_ask(side, f"w{b}", 400, cpu=900,
                                      spread=True)]) for b in range(3)]
        return rs, rs.solve_stream(bs, seeds=[1, 2, 3])
    port = SIDES[1]
    (srs, sout), (wrs, wout) = run(port, "scan"), run(port, "while")
    assert_stream_equal(sout, wout)
    assert_counters_equal(srs, wrs)
    # contention waves, some of them on the carried shortlist
    assert max(wrs.last_waves) > 1
    assert (wrs.last_rescore_waves < wrs.last_waves).any()
    rrs, rout = run(SIDES[0], "while")
    assert_stream_equal(rout, wout)
    assert_counters_equal(rrs, wrs)


# ---------------------------------------------------- delta lifecycle
def _deltas(side, nodes, small=True):
    """A small delta (allocs placed and stopped, one node's capacity
    changed) or one touching half the nodes (past the threshold)."""
    d = side.tz.ClusterDelta()
    touched = range(0, 12, 3) if small else range(0, len(nodes), 2)
    for k, i in enumerate(touched):
        a = make_alloc(side, f"dl-{i}", nodes[i].id, 300, 512)
        d.place.append((nodes[i].id, a))
        if k % 2:
            d.stop.append((nodes[i].id, a))
    changed = make_node(side, 5, cpu=6000)
    d.upsert_nodes.append(changed)
    return d


def test_apply_delta_then_stream():
    def run(side):
        nodes = make_nodes(side, 320)
        rs = f32_layout(side.solver(nodes, probes(side), gp=4, kp=64))
        outs = [rs.solve_stream(mixed_batches(side, rs, 2, tag="p"))]
        kinds = [rs.apply_delta(_deltas(side, nodes))]
        outs.append(rs.solve_stream(mixed_batches(side, rs, 2, tag="q")))
        kinds.append(rs.apply_delta(_deltas(side, rs.nodes, small=False)))
        outs.append(rs.solve_stream(mixed_batches(side, rs, 2, tag="r")))
        return rs, outs, kinds
    (rrs, routs, rk), (prs, pouts, pk) = both(run)
    assert rk == pk == ["delta", "repack"]
    for ro, po in zip(routs, pouts):
        assert_stream_equal(ro, po)
    assert_counters_equal(rrs, prs)
    assert rrs.delta_counters == prs.delta_counters
    assert prs.plane_checksum() == port_tz.template_checksum(prs.template)
    assert prs.plane_checksum() == rrs.plane_checksum()


def test_delta_scatter_add_accumulates_padding():
    """"add" pads with zero rows at index 0 and must accumulate; "set"
    pads by repeating row 0."""
    from nomad_tpu_torch.solver.kernel import (delta_scatter_add,
                                               delta_scatter_set)
    arr = torch.ones((6, 2))
    delta_scatter_add(arr, np.array([0, 3, 0, 0]),
                      np.array([[1, 1], [2, 2], [0, 0], [0, 0]], np.float32))
    np.testing.assert_array_equal(arr.numpy()[[0, 3, 1]],
                                  [[2, 2], [3, 3], [1, 1]])
    delta_scatter_set(arr, np.array([4, 1, 4]),
                      np.array([[9, 9], [7, 7], [9, 9]], np.float32))
    np.testing.assert_array_equal(arr.numpy()[[4, 1]], [[9, 9], [7, 7]])


def test_pipelined_with_deltas():
    def run(side):
        nodes = make_nodes(side, 320)
        rs = side.solver(nodes, probes(side), gp=4, kp=64)
        chunks = [[make_ask(side, f"c{b}", 20, cpu=800, spread=b == 1),
                   make_ask(side, f"e{b}", 10, cpu=500)] for b in range(3)]
        deltas = [None, _deltas(side, nodes), None]
        out = rs.solve_stream_pipelined(chunks, seeds=[1, 2, 3],
                                        deltas=deltas)
        # re-dispatching the same packed chunk ships nothing
        pb = rs.pack_batch_cached(chunks[0])
        rs.solve_stream_pipelined([pb, pb], seeds=[4, 5])
        return rs, out
    (rrs, rout), (prs, pout) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    assert rrs.delta_counters == prs.delta_counters
    assert prs.last_pipeline_stats["bytes_dispatched"] == 0
    assert prs.plane_checksum() == port_tz.template_checksum(prs.template)


# ---------------------------------------------------------- preemption
def overcommit(side, seed=0, n_nodes=24):
    """Nodes mostly full of low-priority allocs (tests/
    test_preempt_kernel.py overcommit_world, fixed ids) and asks that
    place only by evicting."""
    rng = np.random.default_rng(seed)
    nodes, abn, ci = [], {}, 0
    for i in range(n_nodes):
        n = make_node(side, i, cpu=int(rng.choice([3000, 4000, 6000])),
                      mem=8192)
        nodes.append(n)
        lst = []
        for k in range(int(rng.integers(2, 6))):
            cpu = int(rng.choice([400, 700, 900, 1200]))
            lst.append(make_alloc(side, f"low-{i}-{k}", n.id, cpu, cpu * 2,
                                  priority=int(rng.choice([5, 10, 20, 30,
                                                           45])),
                                  create_index=ci))
            ci += 1
        abn[n.id] = lst
    asks = [[make_ask(side, f"hi-{b}-{g}", int(rng.integers(8, 15)),
                      cpu=int(rng.choice([2000, 2500])), mem=2048,
                      priority=prio, spread=g == 0)
             for g, prio in enumerate((60, 50))] for b in range(2)]
    return nodes, abn, asks


@pytest.mark.parametrize("delta_threshold", [1.0, 0.0],
                         ids=["delta", "repack"])
def test_preempting_stream_matches_reference(delta_threshold):
    """evict_e=8: two batches, the first one's evictions fed back as stop
    deltas before the second; victim masks, choices and carried usage
    equal per batch, on the scatter path and on the repack path.  The
    eviction pass already freed the victims' usage: the port's
    `apply_delta(evicted=True)` leaves it freed once, and the reference,
    which has no such flag, gives it back through `_delta_add` after a
    plain stop delta."""
    def run(side):
        nodes, abn, asks = overcommit(side)
        rs = f32_layout(side.solver(nodes, asks[0], abn, evict_e=8,
                                    delta_threshold=delta_threshold))
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
            ch, ok = out[0][0], out[1][0]
            d = side.tz.ClusterDelta()
            freed = {}
            for p in range(ch.shape[0]):
                if not ok[p, 0] or not ev[p].any():
                    continue
                ni = int(ch[p, 0])
                for e in np.nonzero(ev[p])[0]:
                    aid = rs.template.ev_ids[ni][e]
                    if aid in live:
                        nid, a = live.pop(aid)
                        d.stop.append((nid, a))
                        freed[ni] = freed.get(ni, 0) + \
                            side.tz.alloc_usage_vector(a)
            if d.empty():
                continue
            want = "delta" if delta_threshold else "repack"
            if side.name == "port":
                assert rs.apply_delta(d, evicted=True) == want
                continue
            assert rs.apply_delta(d) == want
            idx = np.asarray(sorted(freed), np.int32)
            if want == "repack":      # rows of the repacked node axis
                idx = np.asarray([rs.node_index[nodes[i].id]
                                  for i in sorted(freed)], np.int32)
            rs._used = rs._delta_add(
                rs._used, idx, np.stack([freed[i] for i in sorted(freed)]))
        return rs, outs, evicts
    (rrs, routs, revs), (prs, pouts, pevs) = both(run)
    assert len(routs) == len(pouts) == 2
    for ro, po, re_, pe in zip(routs, pouts, revs, pevs):
        assert_stream_equal(ro, po)
        np.testing.assert_array_equal(re_, pe)
    assert any(e.any() for e in pevs), "the workload must evict"
    assert_counters_equal(rrs, prs)
    assert prs.plane_checksum() == rrs.plane_checksum() \
        == port_tz.template_checksum(prs.template)


# ------------------------------------------------- checksums and health
@pytest.mark.parametrize("evict_e", [0, 8])
def test_health_kernel_matches_host_twin_and_reference(evict_e):
    def run(side):
        nodes, abn, asks = overcommit(side, seed=3)
        rs = side.solver(nodes, asks[0], abn, evict_e=evict_e)
        used0 = np.zeros_like(rs.template.used0)
        for i, n in enumerate(nodes):
            for a in abn[n.id]:
                used0[i] += side.tz.alloc_usage_vector(a)
        used0[7] += 1e8                    # saturates at 2^24 - 1
        rs.reset_usage(used0=used0)
        rs.solve_stream([rs.pack_batch([make_ask(side, "h", 20,
                                                 cpu=300)])])
        return rs, rs.health_counters()
    (rrs, rh), (prs, ph) = both(run)
    twin = port_health.health_host(prs.template, *prs.usage())
    assert ph == twin
    assert dataclasses.asdict(ph) == dataclasses.asdict(rh)
    assert (ph.ev_slots > 0) == (evict_e > 0)
    assert ph.nodes_busy > 0


def test_plane_checksum_matches_both_template_checksums():
    def run(side):
        nodes = make_nodes(side, 320)
        rs = side.solver(nodes, probes(side), gp=4, kp=64)
        return rs
    rrs, prs = both(run)
    c = prs.plane_checksum()
    assert c == port_tz.template_checksum(prs.template) \
        == ref_tz.template_checksum(rrs.template) == rrs.plane_checksum()


def test_resident_solver_raises_without_gpu(monkeypatch):
    side = SIDES[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_resident.ResidentSolver(make_nodes(side, 8), probes(side))
    rs = side.solver(make_nodes(side, 8), probes(side))
    assert rs.device.type == "cpu" and rs.compile_count() == -1


def test_wave_traffic_and_trace_attrs_match_reference():
    """The byte model, the measured wave counters and the trace
    attributes of a stream equal the reference's (the port's `tile` is
    its kernel's node width, not the Pallas tile).  The reference's
    attributes also carry the stream's wall (`solve`), the port's its
    host syncs (`syncs_total`): one read of each wave's flags, and one
    more a rerank."""
    def run(side):
        rs = side.solver(make_nodes(side, 320), probes(side), gp=4, kp=64)
        bs = mixed_batches(side, rs, 2)
        rs.solve_stream(bs, seeds=[1, 2])
        wt = rs.wave_traffic(bs)
        wt.pop("tile")
        attrs = rs.trace_attrs(bs)
        attrs["wave_traffic"].pop("tile")
        return wt, attrs
    (rwt, rat), (pwt, pat) = both(run)
    assert rwt == pwt
    assert set(rat.pop("solve")) == {"n_batches", "wall_s"}
    assert "solve" not in pat
    syncs = pat.pop("syncs_total")
    assert rat == pat
    assert pwt["measured"]["waves_total"] >= 2
    assert syncs >= pat["waves_total"]
