"""The port's flight recorder, metrics registry and mesh event log
(`nomad_tpu_torch.utils.tracing`, `.utils.metrics`) against the JAX
package's, on the CPU.

Each case of `tests/test_tracing.py` runs on both packages (`pkg` =
"ref" / "port"): the metrics registry under concurrent writers, its key
cap and Prometheus text; the recorder's ring, disabled path, parents,
spill drainer and JSONL sink; span chains over a real server (the
port's on `device="cpu"`); the trace corpus against the store; the
trace routes of the HTTP agent; the mesh event log against an elastic
solver's reshard counters, its JSONL sink and truthiness.  Knobs the
reference may read from the environment are passed as constructor
arguments on both sides.  The port's outcome must equal the reference's;
the port's solve span does not carry the reference's modelled TPU bytes
(`modeled_bytes_total`).  A last case shows that the port reads none of
the reference's tracing and metrics environment variables."""
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest

from tests.test_torch_http_api import PKG_NAMES, Outcomes, api_pkg

#: lifecycle stage names in their required order (subsequence match)
LIFECYCLE = ["create", "admit", "broker.enqueue", "broker.dequeue",
             "worker.batch", "solve"]


def quiet_job(P, count=1):
    job = P.mock.job()
    job.task_groups[0].count = count
    job.task_groups[0].tasks[0].resources.networks = []
    return job


def big_node(P, cpu=8000, mem=32768):
    n = P.mock.node()
    n.node_resources.cpu = cpu
    n.node_resources.memory_mb = mem
    return n


def wait_terminal(server, eval_ids, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [server.store.eval_by_id(i) for i in eval_ids]
        if all(e is not None and e.terminal_status() for e in evs):
            return evs
        time.sleep(0.05)
    raise AssertionError("evals not terminal: " + str(
        [(e.id[:8], e.status) for e in evs
         if e is None or not e.terminal_status()]))


def assert_span_chain(spans, eval_id):
    names = [s["name"] for s in spans]
    it = iter(names)
    missing = [want for want in LIFECYCLE
               if not any(got == want for got in it)]
    assert not missing, (eval_id, "missing stages", missing, names)
    ids = set()
    for s in spans:
        assert s["parent_id"] == "" or s["parent_id"] in ids, \
            (eval_id, s["name"], names)
        ids.add(s["span_id"])
    pos = {}
    for i, n in enumerate(names):
        pos.setdefault(n, i)
    for a, b in zip(LIFECYCLE, LIFECYCLE[1:]):
        assert pos[a] < pos[b], (eval_id, a, b, names)


# ------------------------------------------------------------- cases
def case_metrics_concurrent_writers(P):
    reg = P.metrics.MetricsRegistry(max_keys_per_ns=4096)
    n_threads, n_ops = 8, 500
    stop = threading.Event()
    seen = {"last": 0.0, "consistent": True, "snaps": 0}

    def writer(i):
        for k in range(n_ops):
            reg.incr_counter("t.counter")
            reg.incr_counter(f"t.counter_{i}")
            reg.set_gauge(f"t.gauge_{i}", float(k))
            reg.add_sample("t.sample", 0.001 * (k % 7))

    def reader():
        # every mid-flight snapshot is internally consistent: a
        # monotone shared counter, a sample count within the final
        while not stop.is_set():
            snap = reg.dump()
            c = snap["counters"].get("t.counter", 0.0)
            ok = c >= seen["last"]
            seen["last"] = c
            smp = snap["samples"].get("t.sample")
            if smp:
                ok &= 0 <= smp["count"] <= n_threads * n_ops
                ok &= smp["min"] >= 0.0
            seen["consistent"] &= ok
            seen["snaps"] += 1
            time.sleep(0.001)

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    rd = threading.Thread(target=reader)
    rd.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    rd.join()
    final = reg.dump()
    return {"counters": final["counters"], "gauges": final["gauges"],
            "count": final["samples"]["t.sample"]["count"],
            "consistent": bool(seen["consistent"]),
            "read": seen["snaps"] > 0}


def case_metrics_cardinality_cap(P):
    reg = P.metrics.MetricsRegistry(max_keys_per_ns=8)
    for i in range(50):
        reg.incr_counter(f"boom.key_{i}")
    d1 = reg.dump()
    reg.incr_counter("boom.key_0")
    reg.set_gauge("calm.gauge", 1.0)
    for i in range(20):
        reg.set_gauge(f"g.k{i}", 1.0)
        reg.add_sample(f"s.k{i}", 0.5)
    d2 = reg.dump()
    return {"boom": sorted(k for k in d1["counters"]
                           if k.startswith("boom.")),
            "overflow": d1["counters"][P.metrics.OVERFLOW_KEY],
            "key0": d2["counters"]["boom.key_0"],
            "calm": d2["gauges"]["calm.gauge"],
            "gauges": len([k for k in d2["gauges"] if k.startswith("g.")]),
            "samples": len([k for k in d2["samples"]
                            if k.startswith("s.")])}


def case_prometheus_exposition(P):
    reg = P.metrics.MetricsRegistry()
    reg.incr_counter("worker.dequeue_eval", 3)
    reg.set_gauge("broker.ready_count", 7.0)
    reg.add_sample("plan.evaluate", 0.25)
    reg.add_sample("plan.evaluate", 0.75)
    reg.observe_hist("plan.size", 3.0, buckets=(1.0, 4.0))
    return reg.prometheus()


def case_recorder_ring_bound_and_disabled(P):
    tr = P.tracing
    rec = tr.FlightRecorder(depth=2, enabled=True)
    for tid in ("a", "b", "c"):
        rec.event(tid, "create")
    off = tr.FlightRecorder(depth=2, enabled=False)
    null = off.span("t", "x") is tr.NULL_SPAN
    off.event("t", "y")
    return {"a": rec.get("a"), "b": rec.get("b") is not None,
            "c": rec.get("c") is not None,
            "dropped": rec.stats()["dropped_traces"], "null": null,
            "off": off.get("t"), "off_spans": off.stats()["spans"]}


def case_explicit_parent_and_stage_chaining(P):
    rec = P.tracing.FlightRecorder(depth=8, enabled=True)
    root = rec.span("t1", "root")
    root.end()
    with rec.stage("t1", "second"):
        pass
    rec.event("t1", "third", parent=root.span_id)
    by = {s["name"]: s for s in rec.get("t1")}
    return {"root": by["root"]["parent_id"] == "",
            "second": by["second"]["parent_id"] == by["root"]["span_id"],
            "third": by["third"]["parent_id"] == by["root"]["span_id"]}


def case_jsonl_sink(P):
    with tempfile.TemporaryDirectory() as d:
        sink = os.path.join(d, "trace.jsonl")
        rec = P.tracing.FlightRecorder(depth=4, enabled=True,
                                       sink_path=sink)
        rec.event("t1", "create", job_id="j1")
        with rec.span("t1", "solve", waves=3):
            pass
        rec.flush()
        with open(sink) as f:
            rows = [json.loads(ln) for ln in f]
    return {"names": [r["name"] for r in rows],
            "waves": rows[1]["attrs"]["waves"],
            "trace": rows[0]["trace_id"], "keys": sorted(rows[0])}


def span_chain_case(seed):
    def run(P):
        rng = np.random.default_rng(seed)
        server = P.Server(num_workers=1)
        server.workers[0].paused.set()
        server.start()
        try:
            for _ in range(8):
                server.register_node(big_node(P))
            pre = []
            for _ in range(int(rng.integers(4, 7))):
                pre.append(server.register_job(quiet_job(
                    P, int(rng.integers(1, 4)))).id)
            ready = server.broker.ready_count() == len(pre)
            server.workers[0].paused.clear()
            wait_terminal(server, pre)
            ev = server.register_job(quiet_job(P))
            wait_terminal(server, pre + [ev.id])
        finally:
            server.stop()
        fused = singleton = False
        for eid in pre + [ev.id]:
            if server.store.eval_by_id(eid).status != "complete":
                continue
            spans = P.tracing.global_tracer.get(eid)
            assert spans is not None, eid
            assert_span_chain(spans, eid)
            a = [s for s in spans if s["name"] == "solve"][0]["attrs"]
            assert a["waves"] >= 1 and a["rescore_waves"] >= 0
            assert a["backend"] in ("host", "device")
            assert isinstance(a["placements"], list)
            if a.get("fused"):
                fused = True
                assert a["fused_batch"] >= 2
            else:
                singleton = True
        return {"ready": ready, "fused": fused, "singleton": singleton}
    return run


def case_shed_eval_carries_shed_cause(P):
    server = P.Server(num_workers=0, serving_config={"max_pending": 1})
    server.start()
    try:
        ids = [server.register_job(quiet_job(P)).id for _ in range(3)]
        shed = server.blocked_evals.shed_count() >= 1
        causes = []
        for eid in ids:
            for s in P.tracing.global_tracer.get(eid) or []:
                if s["name"] == "admit" and not s["attrs"]["admitted"]:
                    causes.append(s["attrs"]["shed_cause"])
    finally:
        server.stop()
    return {"shed": shed, "causes": causes}


def case_broker_gauges_export_without_workers(P):
    server = P.Server(num_workers=0)
    server.start()
    try:
        server.register_job(quiet_job(P))
        ready = server.broker.ready_count()
        gm = P.metrics.global_metrics
        gm.set_gauge("broker.ready_count", -1.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if gm.dump()["gauges"].get("broker.ready_count") == 1.0:
                break
            time.sleep(0.1)
        return {"ready": ready,
                "gauge": gm.dump()["gauges"]["broker.ready_count"]}
    finally:
        server.stop()


def case_trace_corpus_roundtrips(P):
    server = P.Server(num_workers=1)
    server.start()
    try:
        for _ in range(4):
            server.register_node(big_node(P))
        ids = [server.register_job(quiet_job(P, 2)).id for _ in range(3)]
        wait_terminal(server, ids)
    finally:
        server.stop()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "corpus.jsonl")
        n_rows = P.tracing.global_tracer.write_corpus(path)
        with open(path) as f:
            rows = [json.loads(ln) for ln in f]
    mine = [r for r in rows if r["eval_id"] in ids]
    placed = [r for r in mine if r["node_id"]]
    allocs = list(server.store.allocs())
    for r in placed:
        assert [a for a in allocs if a.eval_id == r["eval_id"]
                and a.node_id == r["node_id"]
                and a.task_group == r["group"]], r
        assert r["candidates"] and "score" in r["candidates"][0]
        assert "nodes_evaluated" in r["features"]
    for a in allocs:
        if a.eval_id in ids:
            assert any(r["eval_id"] == a.eval_id
                       and r["node_id"] == a.node_id for r in placed)
    return {"rows": len(rows) == n_rows, "mine": len(mine),
            "placed": len(placed), "keys": sorted(placed[0])}


def case_trace_http_endpoints(P):
    hs = P.http_server
    server = P.Server(num_workers=1)
    server.start()
    try:
        server.register_node(big_node(P, mem=8192))
        ev = server.register_job(quiet_job(P))
        wait_terminal(server, [ev.id])
        api = hs.HTTPAgentServer(server)      # dispatch only
        api._httpd.server_close()
        code, body, _ = api.dispatch("GET", f"/v1/trace/{ev.id}", None)
        first = [s["name"] for s in body["spans"]][:2]
        c2, lst, _ = api.dispatch("GET", "/v1/traces?limit=5", None)
        c3, corpus, _ = api.dispatch("GET", "/v1/trace/corpus", None)
        c4, events, _ = api.dispatch("GET", "/v1/agent/events", None)
        with pytest.raises(hs.HTTPError) as ei:
            api.dispatch("GET", "/v1/trace/no-such-trace", None)
        return {"codes": [code, c2, c3, c4, ei.value.code],
                "first": first, "enabled": lst["stats"]["enabled"],
                "listed": any(t["trace_id"] == ev.id
                              for t in lst["traces"]),
                "rows": isinstance(corpus["rows"], list),
                "events": isinstance(events["events"], list)}
    finally:
        server.stop()


def case_mesh_event_log_matches_reshard_counters(P):
    from tests.test_torch_resident import SIDES, make_nodes, probes
    from tests.test_torch_sharded import port_mesh, ref_mesh
    side = SIDES[0] if P.name == "ref" else SIDES[1]
    if P.name == "ref":
        from nomad_tpu.parallel import sharded
        mesh = ref_mesh(("nodes", 4))
    else:
        from nomad_tpu_torch.parallel import sharded
        mesh = port_mesh(("nodes", 4))
    log = P.tracing.MeshEventLog(depth=64)
    es = sharded.ElasticShardedResidentSolver(
        make_nodes(side, 24), probes(side), gp=4, kp=16, mesh=mesh,
        event_log=log, pallas="off")
    empty = len(log) == 0
    grew = es.grow_tiles(1)
    lay = es._layout
    t = next(t for t in range(lay.n_tiles)
             if lay.owner[t] >= 0 and t not in grew)
    dst = next(s for s in range(lay.n_shards)
               if s != lay.owner[t] and lay.free_slots(s) > 0)
    es.move_tile(t, dst)
    shrunk = es.shrink_tiles(1)
    fail = next(int(lay.owner[t2]) for t2 in range(lay.n_tiles)
                if lay.owner[t2] >= 0)
    lost = es.fail_shard(fail)
    rec_bytes = es.recover()
    events = log.events()
    by = {e["kind"]: e for e in events}
    rc = es.reshard_counters
    checks = {
        "grow": by["grow"]["n_tiles"] == rc["tiles_grown"] == 1
        and by["grow"]["tiles"] == grew and by["grow"]["bytes"] > 0,
        "move": by["move"]["tile"] == t and by["move"]["dst_shard"] == dst
        and by["move"]["bytes"] == rc["last_reshard_bytes"],
        "shrink": by["shrink"]["tiles"] == shrunk and len(shrunk) == 1,
        "fail": by["fail"]["shard"] == fail and by["fail"]["tiles"] == lost,
        "recover": by["recover"]["bytes"] == rec_bytes
        == rc["last_recovery_bytes"] and by["recover"]["duration_s"] > 0,
        "recoveries": rc["recoveries"],
        "seq": [e["seq"] for e in events] == sorted(e["seq"]
                                                    for e in events)}
    json.dumps(events)
    sup = sharded.ElasticMeshSupervisor(es)
    sup.register_host("host-a", fail)
    sup.on_fail("host-a")
    sup.on_join("host-a")
    return {"empty": empty, "kinds": [e["kind"] for e in events],
            "checks": checks,
            "supervisor": [e["kind"] for e in log.events()][-4:],
            "grew": grew, "bytes": [e.get("bytes") for e in events]}


def case_mesh_event_log_jsonl_sink(P):
    with tempfile.TemporaryDirectory() as d:
        sink = os.path.join(d, "mesh.jsonl")
        log = P.tracing.MeshEventLog(depth=8, sink_path=sink)
        log.record("grow", tiles=[1], bytes=128)
        log.record("fail", shard=0)
        with open(sink) as f:
            rows = [json.loads(ln) for ln in f]
    return {"kinds": [r["kind"] for r in rows], "bytes": rows[0]["bytes"]}


def case_mesh_event_log_truthiness(P):
    log = P.tracing.MeshEventLog(depth=8)
    out = [len(log), bool(log)]
    recorded = []
    for _ in range(2):
        if log:
            recorded.append(log.record("grow", tiles=[1]))
    return out + [len(recorded), len(log), bool(log)]


OUTCOMES = Outcomes({
    "metrics_concurrent_writers": case_metrics_concurrent_writers,
    "metrics_cardinality_cap": case_metrics_cardinality_cap,
    "prometheus_exposition": case_prometheus_exposition,
    "recorder_ring_bound_and_disabled":
        case_recorder_ring_bound_and_disabled,
    "explicit_parent_and_stage_chaining":
        case_explicit_parent_and_stage_chaining,
    "jsonl_sink": case_jsonl_sink,
    "span_chain_0": span_chain_case(0),
    "span_chain_1": span_chain_case(1),
    "shed_eval_carries_shed_cause": case_shed_eval_carries_shed_cause,
    "broker_gauges_export_without_workers":
        case_broker_gauges_export_without_workers,
    "trace_corpus_roundtrips": case_trace_corpus_roundtrips,
    "trace_http_endpoints": case_trace_http_endpoints,
    "mesh_event_log_matches_reshard_counters":
        case_mesh_event_log_matches_reshard_counters,
    "mesh_event_log_jsonl_sink": case_mesh_event_log_jsonl_sink,
    "mesh_event_log_truthiness": case_mesh_event_log_truthiness,
})


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_metrics_concurrent_writers_snapshot_consistency(pkg):
    out = OUTCOMES.check("metrics_concurrent_writers", pkg)
    assert out["counters"]["t.counter"] == 8 * 500
    assert all(out["counters"][f"t.counter_{i}"] == 500 for i in range(8))
    assert all(out["gauges"][f"t.gauge_{i}"] == 499.0 for i in range(8))
    assert out["count"] == 8 * 500 and out["consistent"] and out["read"]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_metrics_cardinality_cap_and_overflow(pkg):
    out = OUTCOMES.check("metrics_cardinality_cap", pkg)
    assert len(out["boom"]) == 8 and out["overflow"] == 42
    assert out["key0"] == 2 and out["calm"] == 1.0
    assert out["gauges"] == 8 and out["samples"] == 8


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_prometheus_exposition(pkg):
    lines = OUTCOMES.check("prometheus_exposition", pkg).splitlines()
    for want in ("# TYPE worker_dequeue_eval counter",
                 "worker_dequeue_eval 3",
                 "# TYPE broker_ready_count gauge", "broker_ready_count 7",
                 "# TYPE plan_evaluate summary",
                 'plan_evaluate{quantile="0.5"} 0.75',
                 "plan_evaluate_sum 1", "plan_evaluate_count 2",
                 "# TYPE plan_size histogram",
                 'plan_size_bucket{le="+Inf"} 1'):
        assert want in lines
    for ln in lines:
        if not ln.startswith("#"):
            name = ln.split("{")[0].split(" ")[0]
            assert all(c.isalnum() or c in "_:" for c in name), ln


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_recorder_ring_bound_and_disabled_noop(pkg):
    out = OUTCOMES.check("recorder_ring_bound_and_disabled", pkg)
    assert out == {"a": None, "b": True, "c": True, "dropped": 1,
                   "null": True, "off": None, "off_spans": 0}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_explicit_parent_and_stage_chaining(pkg):
    out = OUTCOMES.check("explicit_parent_and_stage_chaining", pkg)
    assert all(out.values())


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_jsonl_sink(pkg):
    out = OUTCOMES.check("jsonl_sink", pkg)
    assert out["names"] == ["create", "solve"] and out["waves"] == 3
    assert out["trace"] == "t1"


@pytest.mark.parametrize("pkg", PKG_NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_span_chain_property_random_eval_batch(seed, pkg):
    out = OUTCOMES.check(f"span_chain_{seed}", pkg)
    assert out == {"ready": True, "fused": True, "singleton": True}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_shed_eval_carries_shed_cause_span(pkg):
    out = OUTCOMES.check("shed_eval_carries_shed_cause", pkg)
    assert out["shed"] and out["causes"]
    assert all(c == "max_pending" for c in out["causes"])


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_broker_gauges_export_without_workers(pkg):
    out = OUTCOMES.check("broker_gauges_export_without_workers", pkg)
    assert out == {"ready": 1, "gauge": 1.0}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_trace_corpus_roundtrips_against_store(pkg):
    out = OUTCOMES.check("trace_corpus_roundtrips", pkg)
    assert out["rows"] and out["mine"] and out["placed"] == 6


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_trace_http_endpoints(pkg):
    out = OUTCOMES.check("trace_http_endpoints", pkg)
    assert out["codes"] == [200, 200, 200, 200, 404]
    assert out["first"] == ["create", "admit"]
    assert out["enabled"] and out["listed"]
    assert out["rows"] and out["events"]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_mesh_event_log_matches_reshard_counters(pkg):
    out = OUTCOMES.check("mesh_event_log_matches_reshard_counters", pkg)
    assert out["empty"]
    assert out["kinds"] == ["grow", "move", "shrink", "fail", "recover"]
    assert out["checks"] == {"grow": True, "move": True, "shrink": True,
                             "fail": True, "recover": True,
                             "recoveries": 1, "seq": True}
    assert out["supervisor"] == ["fail", "supervisor.fail", "recover",
                                 "supervisor.recover"]


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_mesh_event_log_jsonl_sink(pkg):
    out = OUTCOMES.check("mesh_event_log_jsonl_sink", pkg)
    assert out == {"kinds": ["grow", "fail"], "bytes": 128}


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_mesh_event_log_truthiness_regression(pkg):
    assert OUTCOMES.check("mesh_event_log_truthiness", pkg) == \
        [0, True, 2, 2, True]


def test_port_reads_no_tracing_or_metrics_environment(monkeypatch):
    """The reference's recorder, registry and event log read
    NOMAD_TPU_TRACE*, NOMAD_TPU_METRICS_MAX_KEYS and
    NOMAD_TPU_MESH_EVENT_LOG; the port's take the same knobs as
    constructor arguments only (the agent configuration will pass
    them)."""
    ref, port = api_pkg("ref"), api_pkg("port")
    with tempfile.TemporaryDirectory() as d:
        for name, value in (("NOMAD_TPU_TRACE", "0"),
                            ("NOMAD_TPU_TRACE_DEPTH", "3"),
                            ("NOMAD_TPU_TRACE_SAMPLE", "0.0"),
                            ("NOMAD_TPU_TRACE_SPILL", "2"),
                            ("NOMAD_TPU_TRACE_SINK",
                             os.path.join(d, "t.jsonl")),
                            ("NOMAD_TPU_MESH_EVENT_LOG",
                             os.path.join(d, "m.jsonl")),
                            ("NOMAD_TPU_METRICS_MAX_KEYS", "2")):
            monkeypatch.setenv(name, value)
        ref_rec = ref.tracing.FlightRecorder()
        assert not ref_rec.enabled and ref_rec.depth_limit == 3
        assert ref.metrics.MetricsRegistry().max_keys_per_ns == 2
        rec = port.tracing.FlightRecorder()
        assert rec.enabled and rec.depth_limit == 512
        assert rec.sample == 1.0 and rec.spill_limit == 8192
        rec.event("t", "create")
        rec.flush()
        assert rec.get("t") is not None
        assert port.metrics.MetricsRegistry().max_keys_per_ns == 512
        port.tracing.MeshEventLog().record("grow", tiles=[1])
        assert sorted(os.listdir(d)) == []
