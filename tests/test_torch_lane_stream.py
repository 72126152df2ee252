"""The port's lane stream (chunks of L solves in lock-step, then a
cross-lane revalidation) and its optimistic-parallel stream against the
JAX package's, on the CPU, after tests/test_lane_stream.py: L = 1 is the
serial stream, disjoint chunks land the serial placements, a ragged B
pads on the device, a storm conserves placements through the retry
drain, a bounce is a retry with every score slot nulled, and the lane
counters, the stream stack cache, the trace attributes, the width
controller, the constructor's default width and the serving tier's
lane knobs behave as the reference's.  Both packages run with
`pallas="off"` and the reference's environment knobs unset (the
autouse fixture of test_torch_resident)."""
import numpy as np
import pytest

from nomad_tpu.scheduler.fleet import LaneWidthController as RefController
from nomad_tpu_torch.chaos import InvariantHarness
from nomad_tpu_torch.scheduler.fleet import (LaneWidthController,
                                             form_lanes)
from nomad_tpu_torch.solver.resident import STATUS_COMMITTED, STATUS_RETRY
from nomad_tpu_torch.solver.solve import (_run_kernel, _to_host,
                                          solve_trace_attrs)
from nomad_tpu_torch.utils.tracing import MeshEventLog
from test_torch_resident import (SIDES, _reference_defaults,  # noqa: F401
                                 assert_counters_equal, assert_stream_equal,
                                 both, f32_layout, host, make_ask,
                                 make_nodes, probes)


def solver(side, n_nodes=320, cpu=None, kp=64, **kw):
    return f32_layout(side.solver(make_nodes(side, n_nodes, cpu=cpu),
                                  probes(side), gp=4, kp=kp, **kw))


def solve(rs, batches, lanes=None, seeds=None):
    return rs.finish_stream(rs.solve_stream_async(batches, seeds=seeds,
                                                  lanes=lanes))


def tight(side, rs, n, count=16, cpu=900, tag="t"):
    """n batches that all want the same tight cluster."""
    return [rs.pack_batch([make_ask(side, f"{tag}{b}", count, cpu=cpu)])
            for b in range(n)]


@pytest.mark.parametrize("shortlist_c", [-1, 0])
def test_lane_one_is_the_serial_stream(shortlist_c):
    def run(side):
        rs = solver(side, n_nodes=64, cpu=2000, shortlist_c=shortlist_c)
        bs = tight(side, rs, 3, count=24)
        ref = solve(rs, bs)
        u_ref = rs.usage()
        assert rs.lane_counters() is None
        rs.reset_usage()
        got = solve(rs, bs, lanes=1)
        assert rs.lane_counters() is None
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(u_ref, rs.usage()):
            np.testing.assert_array_equal(a, b)
        return rs, got
    (rrs, rout), (prs, pout) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)


@pytest.mark.parametrize("lanes", [2, 4])
def test_lane_disjoint_chunks_match_serial(lanes):
    """Disjoint dc-pinned batches, formed by form_lanes: no bounce, the
    serial stream's placements and usage, and the reference's."""
    def run(side):
        rs = solver(side, n_nodes=64)
        members = [(rs.pack_batch([make_ask(side, f"d{b}", 3, cpu=500,
                                            dc=f"dc{b % 4}")]),
                    (f"dc{b % 4}",)) for b in range(4)]
        batches = [pb for pb, _ in form_lanes(members, lanes,
                                              key_fn=lambda m: m[1])]
        ser = solve(rs, batches, seeds=[1, 2, 3, 4])
        u_ser = rs.usage()
        rs.reset_usage()
        got = solve(rs, batches, lanes=lanes, seeds=[1, 2, 3, 4])
        lc = rs.lane_counters()
        assert lc["lanes"] == lanes and lc["chunks"] == 4 // lanes
        assert lc["bounced"] == 0 and lc["committed"] == 12
        for a, b in zip(ser, got):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(u_ser, rs.usage()):
            np.testing.assert_array_equal(a, b)
        return rs, got, lc
    (rrs, rout, rlc), (prs, pout, plc) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    assert rlc == plc


def test_lane_ragged_batch_count_pads_on_device():
    def run(side):
        rs = solver(side, n_nodes=64, cpu=2000)
        out = solve(rs, tight(side, rs, 3, count=20), lanes=2)
        assert out[3].shape[0] == 3
        lc = rs.lane_counters()
        assert lc["chunks"] == 2
        used, _ = rs.usage()
        committed = int((out[3] == STATUS_COMMITTED).sum())
        assert used[:, 0].sum() == pytest.approx(900 * committed)
        return rs, out, lc
    (rrs, rout, rlc), (prs, pout, plc) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    assert rlc == plc


def test_lane_uniform_rescore_rule():
    """Lanes that finish at different waves, and a padded chunk: while
    any lane of a chunk has finished (or is padding), every remaining
    wave is a full pass for every lane, so `last_rescore_waves` differs
    from the serial stream's and must equal the reference's, batch by
    batch."""
    counts = [400, 10, 300, 5, 250]

    def run(side, lanes):
        rs = solver(side, n_nodes=300, kp=512)
        bs = [rs.pack_batch([make_ask(side, f"u{b}", c, cpu=900,
                                      spread=b % 3 == 0)])
              for b, c in enumerate(counts)]
        out = solve(rs, bs, lanes=lanes, seeds=[1, 2, 3, 4, 5])
        return rs, out
    for lanes in (2, 4):
        (rrs, rout), (prs, pout) = both(lambda s: run(s, lanes))
        assert_stream_equal(rout, pout)
        assert_counters_equal(rrs, prs)
        assert rrs.lane_counters() == prs.lane_counters()
    # the rule shows: a lane kept running after its partner finished
    ser, _ = run(SIDES[1], None)
    lane2, _ = run(SIDES[1], 2)
    assert (lane2.last_rescore_waves > ser.last_rescore_waves).any()


def _drain(rs, side, batches, lanes, ids, harness=None):
    """Solve lane-parallel, re-solve bounced counts until every
    placement is terminal, feeding each terminal outcome and committed
    placement to `harness` (an InvariantHarness).  Returns (committed
    ids, failed ids, per-round outputs)."""
    committed, failed, rounds = [], [], []
    r = 0
    while batches:
        r += 1
        assert r <= 10, "retry drain did not converge"
        out = solve(rs, batches, lanes=lanes if len(batches) > 1 else None)
        rounds.append(out)
        status = out[3]
        nxt_b, nxt_i = [], []
        node_ids = rs.template.node_ids
        for b, pb in enumerate(batches):
            retry = []
            for k, pid in enumerate(ids[b]):
                st = status[b, k]
                if st == STATUS_COMMITTED:
                    committed.append(pid)
                    if harness is not None:
                        harness.note_outcome(pid, "acked")
                        harness.note_placement(
                            pid, node_ids[int(host(out[0])[b, k, 0])])
                elif st == 0:
                    failed.append(pid)
                    if harness is not None:
                        harness.note_outcome(pid, "failed")
                else:
                    assert st == STATUS_RETRY
                    retry.append(pid)
            if retry:
                nxt_b.append(rs.pack_batch([make_ask(
                    side, f"retry{r}-{b}", len(retry), cpu=900)]))
                nxt_i.append(retry)
        batches, ids = nxt_b, nxt_i
    return committed, failed, rounds


@pytest.mark.parametrize("lanes", [4])
def test_lane_storm_conserves_placements(lanes):
    """Every batch wants the same tight cluster: after the retry drain
    every placement is terminal exactly once, no node is overcommitted,
    the totals equal the serial stream's, and each round equals the
    reference's.  The port's InvariantHarness watches the drain, as the
    reference's storm runs under its own: every placement terminal,
    none lost, none placed twice."""
    def run(side):
        rs = solver(side, n_nodes=8, cpu=2000, kp=8)
        ser = solver(side, n_nodes=8, cpu=2000, kp=8)
        s_out = solve(ser, tight(side, ser, 8, count=4))
        ids = [[f"ev{b}.p{k}" for k in range(4)] for b in range(8)]
        harness = InvariantHarness(event_log=MeshEventLog())
        for row in ids:
            for pid in row:
                harness.note_enqueued(pid)
        committed, failed, rounds = _drain(
            rs, side, tight(side, rs, 8, count=4), lanes, ids, harness)
        assert len(committed) + len(failed) == 32
        assert len(set(committed) | set(failed)) == 32
        assert harness.check_eval_conservation()
        assert harness.check_no_double_placement()
        assert harness.ok and harness.report()["allocs_seen"] == len(
            committed)
        used, _ = rs.usage()
        assert (used[:8, 0] <= 2000).all()
        assert len(committed) == int((s_out[3][:, :4] == 1).sum())
        assert used[:, 0].sum() == pytest.approx(ser.usage()[0][:, 0].sum())
        return rounds
    ref, port = both(run)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert_stream_equal(a, b)


def test_lane_bounce_is_retry_without_candidates():
    def run(side):
        rs = solver(side, n_nodes=4, cpu=2000, kp=8)
        out = solve(rs, tight(side, rs, 4, count=4), lanes=4)
        st = out[3][:, :4]
        assert int((st == 1).sum()) <= 8000 // 900
        rest = st[st != 1]
        assert rest.size > 0 and (rest == STATUS_RETRY).all()
        bounced = st == STATUS_RETRY
        assert not out[1][:, :4, :][bounced].any()
        lc = rs.lane_counters()
        assert lc["bounced"] == int(bounced.sum())
        assert 0.0 < lc["bounce_rate"] <= 1.0
        return rs, out, lc
    (rrs, rout, rlc), (prs, pout, plc) = both(run)
    assert_stream_equal(rout, pout)
    assert_counters_equal(rrs, prs)
    assert rlc == plc


def test_stream_stack_cache_skips_reship_on_repeat_dispatch():
    side = SIDES[1]
    rs = solver(side, n_nodes=32)
    batches = tight(side, rs, 2, count=2, cpu=500)
    solve(rs, batches, lanes=2)
    assert rs.last_dispatch_bytes > 0
    solve(rs, batches, lanes=2)
    assert rs.last_dispatch_bytes == 0
    solve(rs, tight(side, rs, 2, count=2, cpu=500, tag="f"), lanes=2)
    assert rs.last_dispatch_bytes > 0
    for i in range(6):
        solve(rs, tight(side, rs, 2, count=2, cpu=500, tag=f"g{i}"),
              lanes=2)
    assert len(rs._stream_stack_cache) <= 4


def test_lane_counters_feed_trace_attrs_and_width_controller():
    def run(side):
        rs = solver(side, n_nodes=4, cpu=2000, kp=8)
        rates = []
        for r in range(4):
            solve(rs, tight(side, rs, 4, count=4 if r % 2 else 1,
                            tag=f"c{r}"), lanes=2)
            rates.append(rs.lane_counters()["bounce_rate"])
            rs.reset_usage()
        return rs, rates
    (_, r_rates), (prs, p_rates) = both(run)
    assert r_rates == p_rates
    lc = prs.lane_counters()
    assert set(lc) == {"lanes", "chunks", "bounced", "committed",
                       "bounce_rate"}
    ctrl, ref_ctrl = (LaneWidthController(max_width=8, start=2, patience=1),
                      RefController(max_width=8, start=2, patience=1))
    widths = [ctrl.record(r, 1.0) for r in p_rates]
    assert widths == [ref_ctrl.record(r, 1.0) for r in r_rates]
    pb = prs.pack_batch([make_ask(SIDES[1], "tr", 2)])
    res = _to_host(_run_kernel(pb, "cpu"))
    attrs = solve_trace_attrs(pb, res, "cpu", lane_counters=lc)
    assert attrs["lanes"] == 2 and attrs["lane_chunks"] == 2
    assert attrs["lane_committed"] == lc["committed"]
    assert attrs["lane_bounce_rate"] == lc["bounce_rate"]
    solve(prs, [pb])
    assert prs.lane_counters() is None
    assert "lanes" not in solve_trace_attrs(pb, res, "cpu")


def test_solve_parallel_matches_reference():
    """Optimistic batches against one snapshot collide on a tight
    cluster: the revalidation keeps usage within capacity and bounces
    to STATUS_RETRY, exactly as the reference's."""
    def run(side):
        rs = solver(side, n_nodes=4, cpu=2000, kp=8)
        out = rs.solve_parallel(tight(side, rs, 4, count=4))
        committed = int((out[3][:, :4] == 1).sum())
        used, _ = rs.usage()
        assert (used[:4, 0] <= 2000).all()
        assert used[:, 0].sum() == pytest.approx(900 * committed)
        rest = out[3][:, :4][out[3][:, :4] != 1]
        assert (rest == STATUS_RETRY).all()
        return rs, out
    (rrs, rout), (prs, pout) = both(run)
    assert_stream_equal(rout, pout)
    for a, b in zip(rrs.usage(), prs.usage()):
        np.testing.assert_array_equal(a, b)
    # a wider parallel stream, with spreads and seeds per batch
    def wide(side):
        rs = solver(side, n_nodes=320)
        bs = [rs.pack_batch([make_ask(side, f"pw{b}", 40, cpu=800,
                                      spread=b % 2 == 0)]) for b in range(3)]
        return rs, rs.solve_parallel(bs)
    (rrs, rout), (prs, pout) = both(wide)
    assert_stream_equal(rout, pout)
    for a, b in zip(rrs.usage(), prs.usage()):
        np.testing.assert_array_equal(a, b)
    assert host(pout[3]).size


def test_fused_lanes_sets_the_default_width(monkeypatch):
    """`ResidentSolver(fused_lanes=L)` routes a multi-batch stream with
    no `lanes=` to the lane stream of width L, as the reference's
    constructor argument does; a call's `lanes=` overrides it, and the
    port never reads `NOMAD_TPU_FUSED_LANES`."""
    monkeypatch.setenv("NOMAD_TPU_FUSED_LANES", "1")

    def run(side):
        rs = solver(side, n_nodes=64, fused_lanes=4)
        bs = tight(side, rs, 4, count=12, tag="fl")
        got = solve(rs, bs, seeds=[1, 2, 3, 4])
        lc = rs.lane_counters()
        assert (lc["lanes"], lc["chunks"]) == (4, 1)
        u_lanes = rs.usage()
        rs.reset_usage()
        ser = solve(rs, bs, lanes=1, seeds=[1, 2, 3, 4])
        assert rs.lane_counters() is None
        return rs, (got, u_lanes, ser)
    (rrs, (rgot, ru, rser)), (prs, (pgot, pu, pser)) = both(run)
    assert_stream_equal(rgot, pgot)
    assert_stream_equal(rser, pser)
    for a, b in zip(ru, pu):
        np.testing.assert_array_equal(a, b)
    assert prs.fused_lanes == rrs.fused_lanes == 4


LANE_KNOBS = {"fused_lanes": ("NOMAD_TPU_FUSED_LANES", 1, 2),
              "max_lanes": ("NOMAD_TPU_MAX_LANES", 8, 4),
              "lane_widen_below": ("NOMAD_TPU_LANE_WIDEN_BELOW", 0.05, 0.1),
              "lane_narrow_above": ("NOMAD_TPU_LANE_NARROW_ABOVE", 0.25,
                                    0.5)}


def test_serving_lane_knobs_match_reference(monkeypatch):
    """The serving tier's four lane knobs: the reference's defaults and
    overrides, in `stats()` as there, and the same `NOMAD_TPU_*`
    variables under `overrides`; its `lane_controller()` is the width
    controller they configure, stepping as the reference's controller
    with the same arguments."""
    from nomad_tpu.server.serving import ServingTier as RefTier
    from nomad_tpu_torch.server.serving import ServingTier
    for env, _default, _override in LANE_KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    over = {k: v[2] for k, v in LANE_KNOBS.items()}
    for kw in ({}, {"overrides": over}):
        ref, port = RefTier(**kw), ServingTier(**kw)
        want = {k: (over[k] if kw else v[1]) for k, v in LANE_KNOBS.items()}
        assert {k: getattr(ref, k) for k in LANE_KNOBS} == want
        assert {k: getattr(port, k) for k in LANE_KNOBS} == want
        assert ({k: port.stats()[k] for k in ("fused_lanes", "max_lanes")}
                == {k: ref.stats()[k] for k in ("fused_lanes", "max_lanes")})
        ctrl = port.lane_controller()
        ref_ctrl = RefController(max_width=ref.max_lanes,
                                 start=ref.fused_lanes,
                                 widen_below=ref.lane_widen_below,
                                 narrow_above=ref.lane_narrow_above)
        assert (ctrl.width, ctrl.max_width) == (want["fused_lanes"],
                                                want["max_lanes"])
        for rate in (0.0, 0.0, 0.0, 0.0, 0.07, 0.3, 0.3, 0.6, 0.6):
            assert ctrl.record(rate) == ref_ctrl.record(rate)
    for env, _default, override in LANE_KNOBS.values():
        monkeypatch.setenv(env, str(override))
    ref, port = RefTier(), ServingTier()
    assert ({k: getattr(port, k) for k in LANE_KNOBS}
            == {k: getattr(ref, k) for k in LANE_KNOBS} == over)
    over2 = {"fused_lanes": 1, "max_lanes": 16}
    ref, port = RefTier(overrides=over2), ServingTier(overrides=over2)
    assert ({k: getattr(port, k) for k in LANE_KNOBS}
            == {k: getattr(ref, k) for k in LANE_KNOBS}
            == dict(over, **over2))
