"""Entry "server": independent clients in a closed loop through a started
`nomad_tpu_torch` `Server` with its default serving tier.

Set-up enters the configuration's nodes and resident allocs (through
raft), starts the server, builds each worker's resident world with one
job while the others are paused, runs one small burst, and starts the
clients `ramp_s` before the window opens.  Each of `clients` threads
registers a new job (`register_job`), waits until its eval is done,
deregisters the job (`deregister_job`), waits for the stop's eval, and
registers the next.  The clients block on
events that one watcher thread sets when the store's index moves, so
they do not poll.  After `--seconds` no client sends anything new; the
evals in flight finish, and the checks read the store.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from .. import gen, harness, port
from ..devtrace import DeviceTrace
from ..reference import server as ref_server
from ..reference import solver as ref_solver

NAMESPACE = "default"
DONE = ("complete", "failed", "blocked", "canceled")


class Waiter:
    """One thread that wakes on every store change and releases the
    clients whose evals are done."""

    def __init__(self, store):
        self.store = store
        self.lock = threading.Lock()
        self.pending: Dict[str, threading.Event] = {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="bench-waiter")
        self.thread.start()

    def _done(self, eid: str) -> bool:
        ev = self.store.eval_by_id(eid)
        return ev is not None and ev.status in DONE

    def _loop(self):
        while not self.stop.is_set():
            head = self.store.latest_index()
            with self.lock:
                items = list(self.pending.items())
            for eid, e in items:
                if self._done(eid):
                    e.set()
                    with self.lock:
                        self.pending.pop(eid, None)
            self.store.wait_for_change(head, 0.25)

    def wait(self, eid: str, timeout: float) -> bool:
        e = threading.Event()
        with self.lock:
            self.pending[eid] = e
        if self._done(eid):
            with self.lock:
                self.pending.pop(eid, None)
            return True
        return e.wait(timeout)

    def close(self):
        self.stop.set()
        self.thread.join(5.0)


class Capture:
    """Keeps a seeded sample of the window's solves (the packed batch,
    the nodes and asks it was packed from, the unfetched result): the
    largest by placements, and a reservoir of `keep` others."""

    def __init__(self, seed: int, keep: int):
        from nomad_tpu_torch.solver import solve as solve_mod
        self.Solver = solve_mod.Solver
        self.real = self.Solver.solve_async
        self.rng = gen.rng(seed, "capture")
        self.keep = keep
        self.lock = threading.Lock()
        self.on = False
        self.seen = 0
        self.largest = None
        self.sample: List[Dict] = []
        cap = self

        def solve_async(solver, nodes, asks, *a, **kw):
            pend = cap.real(solver, nodes, asks, *a, **kw)
            if cap.on and pend.packed is not None and pend._res is not None:
                cap._add({"pb": pend.packed, "nodes": pend._nodes,
                          "asks": pend._asks, "res": pend._res,
                          "preempt": bool(kw.get("preempt")),
                          "degraded": solver.degraded})
            return pend
        self.wrapper = solve_async

    def _add(self, rec):
        with self.lock:
            self.seen += 1
            if self.largest is None or \
                    rec["pb"].n_place > self.largest["pb"].n_place:
                rec, self.largest = self.largest, rec
                if rec is None:
                    return
            if len(self.sample) < self.keep:
                self.sample.append(rec)
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < self.keep:
                    self.sample[j] = rec

    def __enter__(self):
        self.Solver.solve_async = self.wrapper
        return self

    def __exit__(self, *exc):
        self.Solver.solve_async = self.real
        return False

    def records(self) -> List[Dict]:
        return ([self.largest] if self.largest else []) + self.sample


def warm_worlds(srv, make, waiter) -> None:
    """One job per worker builds that worker's resident world while the
    other workers are paused (chip_smoke.py `warm_worlds`)."""
    from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT_S
    for i, w in enumerate(srv.workers):
        for o in srv.workers:
            if o is not w:
                o.paused.set()
        time.sleep(2 * DEQUEUE_TIMEOUT_S)
        ev = srv.register_job(make(f"warm{i}"))
        if not waiter.wait(ev.id, 600):
            raise RuntimeError("a world-building eval did not finish")
        for o in srv.workers:
            o.paused.clear()


def run(run) -> Dict:
    import torch
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.utils.metrics import global_metrics
    from nomad_tpu_torch.utils.tracing import global_tracer
    cfg, mix, seed = run.cfg, run.mix, run.seed
    cl = gen.cluster(cfg, seed)
    spec = gen.job(cfg, "probe")
    maker = port.JobMaker(spec)
    name = cfg["name"]
    if run.device == "cuda":
        from nomad_tpu_torch.solver import wave_kernel
        wave_kernel._load()
    srv = Server(device=run.device)
    tier = {"workers": len(srv.workers),
            "coordinator": srv.solve_coordinator is not None,
            "group_commit": srv.serving.group_commit,
            "max_batch": srv.serving.max_batch}
    enter = port.enter_cluster(srv, cl, port.nodes(cl))
    waiter = Waiter(srv.store)
    try:
        srv.start()

        def make(tag):
            return maker.full(f"{name}-{seed}-{tag}")
        warm_worlds(srv, make, waiter)
        burst = [srv.register_job(make(f"burst{i}"))
                 for i in range(mix["warm_burst"])]
        for ev in burst:
            waiter.wait(ev.id, 600)
        stops = [srv.deregister_job(NAMESPACE, ev.job_id) for ev in burst]
        for ev in stops:
            waiter.wait(ev.id, 600)
        harness.settle()
        window = Window(srv, waiter, maker, run)
        window.start()
        time.sleep(mix["ramp_s"])       # the clients reach their steady loop
        if run.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - run.t0
        m0 = global_metrics.dump()
        with Capture(seed, mix["sampled_solves"] - 1) as cap:
            cap.on = True
            window.run()
            m1 = global_metrics.dump()
            cap.on = False
            window.finish(mix["drain_s"])
        if run.device == "cuda":
            torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() if run.device == "cuda"
                else 0)
        store = read_store(srv, window.jobs, window.records, window.errors)
        spans = {r["eval"]: global_tracer.get(r["eval"]) or []
                 for r in window.records}
        solves = [prepare(r) for r in cap.records() if not r["preempt"]]
        if window.traced:
            window.traced["summary"] = window.traced.pop("trace").summarize()
    finally:
        waiter.close()
        srv.stop()
    regs = [r for r in window.records if r["kind"] == "register"]
    in_window = sum(1 for a in store["allocs"]
                    if window.idx_open < a["create_index"]
                    <= window.idx_close)
    checks = judge(cl, spec, store, solves, run.limits, run.control)
    layer = {"eval_ms": [1e3 * (r["t_done"] - r["t_start"]) for r in regs],
             "spans": spans, "metrics0": m0, "metrics1": m1,
             "traced": window.traced, "tier": tier, "enter": enter}
    failed = sum(1 for r in regs if not r["done"] or (
        store["evals"][r["eval"]] or {}).get("status") != "complete")
    return {"attempted": len(regs), "failed": failed,
            "e2e": {"server_placements_per_s": in_window / window.window_s,
                    "setup_s": setup_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "diag": {"window_s": window.window_s,
                     "evals": len(window.records), "registers": len(regs),
                     "solves": [(sv["n_place"], sv["n_asks"])
                                for sv in solves],
                     "tier": tier, "enter_s": enter,
                     "errors": store["errors"][:5]}}


class Window:
    """The clients of one window and what they recorded."""

    def __init__(self, srv, waiter, maker, run):
        self.srv, self.waiter, self.maker, self.cell = srv, waiter, maker, run
        self.records: List[Dict] = []
        self.lock = threading.Lock()
        self.closed = threading.Event()
        self.traced = None
        self.errors: List[str] = []

    def client(self, c: int) -> None:
        srv, run = self.srv, self.cell
        timeout = run.mix["eval_timeout_s"]
        n = 0
        try:
            while not self.closed.is_set():
                job = self.maker.full(
                    f"{run.cfg['name']}-{run.seed}-c{c}-{n}")
                n += 1
                for kind in ("register", "stop"):
                    if kind == "stop" and self.closed.is_set():
                        break               # the job stays registered
                    t = time.perf_counter()
                    ev = (srv.register_job(job) if kind == "register" else
                          srv.deregister_job(NAMESPACE, job.id))
                    ok = self.waiter.wait(ev.id, timeout)
                    rec = {"kind": kind, "job": job.id, "eval": ev.id,
                           "t_start": t, "t_done": time.perf_counter(),
                           "done": ok}
                    with self.lock:
                        self.records.append(rec)
                    if not ok:
                        raise RuntimeError(f"eval {ev.id} not done in "
                                           f"{timeout} s")
        except Exception as e:                    # recorded, and judged
            with self.lock:
                self.errors.append(f"client {c}: {e!r}")

    def start(self) -> None:
        self.threads = [threading.Thread(target=self.client, args=(c,),
                                         daemon=True, name=f"bench-c{c}")
                        for c in range(self.cell.mix["clients"])]
        for t in self.threads:
            t.start()

    def run(self) -> None:
        """The window: from now for `--seconds`, the clients running."""
        mix, run = self.cell.mix, self.cell
        self.idx_open = self.srv.store.latest_index()
        self.t_open = time.perf_counter()
        if run.trace:
            lead = run.seconds * mix["trace_at"]
            time.sleep(lead)
            with DeviceTrace(run.device) as dt:
                time.sleep(min(mix["trace_s"], run.seconds - lead))
            self.traced = {"trace": dt}
        rest = self.t_open + run.seconds - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
        self.idx_close = self.srv.store.latest_index()
        self.window_s = time.perf_counter() - self.t_open
        self.closed.set()

    def finish(self, drain_s: float) -> None:
        deadline = time.perf_counter() + drain_s
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        alive = sum(t.is_alive() for t in self.threads)
        if alive:
            self.errors.append(f"{alive} clients still waiting after "
                               f"{drain_s} s")
        # every job counts for the placements committed in the window;
        # the records judged are the evals started while it was open
        self.jobs = sorted({r["job"] for r in self.records})
        close = self.t_open + self.window_s
        self.records = [r for r in self.records
                        if self.t_open <= r["t_start"] < close]


def read_store(srv, jobs, records, errors) -> Dict:
    """Plain copies of what the store holds for the clients' jobs."""
    evals = {r["eval"]: srv.store.eval_by_id(r["eval"]) for r in records}
    allocs, placed_by_eval = [], {}
    for j in jobs:
        for a in srv.store.allocs_by_job(NAMESPACE, j):
            allocs.append({"job": j, "group": a.task_group,
                           "node": a.node_id, "eval": a.eval_id,
                           "desired": a.desired_status,
                           "create_index": a.create_index or 0})
            placed_by_eval[a.eval_id] = placed_by_eval.get(a.eval_id, 0) + 1
    return {"allocs": allocs, "placed_by_eval": placed_by_eval,
            "evals": {k: (None if e is None else
                          {"status": e.status, "blocked": e.blocked_eval,
                           "job": e.job_id}) for k, e in evals.items()},
            "records": records, "errors": list(errors)}


def prepare(rec: Dict) -> Dict:
    """A captured solve as plain arrays (its result fetched)."""
    import dataclasses
    pb, res = rec["pb"], rec["res"]

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else \
            np.asarray(x)
    planes = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)
              if isinstance(getattr(pb, f.name), np.ndarray)}
    n = pb.n_place
    ok = host(res.choice_ok)[:n, 0]
    status = np.where(ok, ref_solver.STATUS_COMMITTED,
                      np.where(host(res.unfinished)[:n],
                               ref_solver.STATUS_RETRY,
                               ref_solver.STATUS_FAILED))
    return {"planes": planes, "n_place": n, "n_asks": pb.n_asks,
            "node_ids": [nd.id for nd in rec["nodes"]],
            "asks": [(a.job.id, a.tg.name, a.count) for a in rec["asks"]],
            "choice": host(res.choice)[:n, 0].astype(np.int64),
            "score": host(res.score)[:n, 0].astype(np.float32),
            "status": status, "degraded": rec["degraded"]}


def judge(cl, spec, store, solves, limits, control) -> list:
    """The numbers that decide `correct`, each beside its limit."""
    plane_errors = 0
    n = mism = 0
    gap = 0.0
    for sv in solves:
        plane_errors += ref_server.plane_errors(cl, spec, sv)
        mw = ref_server.BROWNOUT_MAX_WAVES if sv["degraded"] else 0
        if control:
            ctl = ref_server.resolve(sv, mw, control)
            sv = dict(sv, choice=ctl.choice, status=ctl.status,
                      score=ctl.score)
        ref = ref_server.resolve(sv, mw)
        n += len(ref.status)
        differ = (sv["status"] != ref.status) | (
            (ref.status == ref_solver.STATUS_COMMITTED)
            & (sv["choice"] != ref.choice))
        mism += int(differ.sum())
        same = ~differ & (ref.status == ref_solver.STATUS_COMMITTED)
        if same.any():
            gap = max(gap, float(np.abs(sv["score"][same].astype(np.float64)
                                        - ref.score[same]).max()))
    values = dict(ref_server.store_errors(cl, spec, store))
    values["plane_errors"] = plane_errors
    values["choice_mismatch"] = mism / n if n else 1.0
    values["score_gap"] = gap if n else 1.0
    return [(k, values[k], limits[k]) for k in limits]
