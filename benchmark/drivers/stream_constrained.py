"""Entry "stream_constrained": the "stream" entry's passes for jobs with
constraints, affinities and spreads, judged by the constrained stream's
plain reference.

The window is the "stream" entry's (`drivers/stream.py`: `Stream`,
`drain_chunks`, `WaveBytes`): each pass starts from the seeded resident
usage, packs `evals_per_pass` evals in chunks of `evals_per_chunk`
merged evals, dispatches them pipelined and drains what the wave budget
left.  A `--trace 1` run also returns the `nomad.solve.prologue` ranges
of its traced pass (`prologue_s`), read from the profiler before its
summary drops it.  `diag` carries the parts of the set-up (the process
start to this entry, the cluster and the solver's planes, the warm pass,
the collector's settle), the reference's seconds for the judged pass,
and the program's solve counters over the window beside the real
[group, node] pairs its solves saw.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import gen, harness
from ..devtrace import DeviceTrace
from ..reference import solver as ref_solver
from ..reference import stream as ref_stream
from ..reference import stream_constrained as ref_constrained
from .stream import Stream, WaveBytes, spec_group

#: the program's range around a solve's prologue
PROLOGUE = "nomad.solve.prologue"
#: the program's counters that `diag` reports over the window
COUNTERS = ("solver.solves", "solver.waves", "solver.pairs_filtered")


def counters() -> Dict:
    from nomad_tpu_torch.utils.metrics import global_metrics
    c = global_metrics.dump()["counters"]
    return {k: c.get(k) for k in COUNTERS}


def prologue_s(prof) -> list:
    """The seconds of each prologue range a finished profiler holds."""
    return [(e.time_range.end - e.time_range.start) / 1e6
            for e in prof.events() if e.name == PROLOGUE]


def run(run) -> Dict:
    import torch
    marks = [run.t0, time.perf_counter()]
    s = Stream(run)
    mix = run.mix
    n_seeds = s.n_chunks + 64 * mix["drain_rounds"]
    marks.append(time.perf_counter())
    s.one_pass(s.warm_jobs, gen.tie_seeds(run.seed, "warm", n_seeds))
    marks.append(time.perf_counter())
    harness.settle()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - run.t0
    setup_parts = dict(zip(("start_s", "build_s", "warm_s", "settle_s"),
                           np.diff(marks).tolist()))

    passes, traced = [], None
    c0 = counters()
    t0 = time.perf_counter()
    p = 0
    while True:
        seeds = gen.tie_seeds(run.seed, f"pass{p}", n_seeds)
        jobs = s.pass_jobs[p % len(s.pass_jobs)]
        if run.trace and p == 1:
            with DeviceTrace(run.device) as dt, WaveBytes() as wb:
                passes.append(s.one_pass(jobs, seeds))
            traced = {"trace": dt, "wave_bytes": wb.bytes}
        else:
            passes.append(s.one_pass(jobs, seeds))
        p += 1
        if time.perf_counter() - t0 >= run.seconds and \
                (p >= 2 or not run.trace):
            break
    window_s = time.perf_counter() - t0
    c1 = counters()
    peak = (torch.cuda.max_memory_allocated() if run.device == "cuda"
            else 0)
    prologue = None
    if traced:
        prologue = prologue_s(traced["trace"].prof)
        traced["summary"] = traced.pop("trace").summarize()

    placed = sum(r["placed"] for r in passes)
    asked = len(passes) * mix["evals_per_pass"] * sum(
        g.count for g in s.spec.groups)
    failed = sum(r["failed"] + r["unresolved"] for r in passes)
    layer = {"pack_ms_per_chunk": 1e3 * sum(r["pack_s"] for r in passes)
             / sum(len(r["batches"]) for r in passes),
             "solve_s": sum(r["wall_s"] - r["pack_s"] for r in passes),
             "waves": sum(r["waves"] for r in passes),
             "traced": traced, "prologue_s": prologue}
    sample = int(gen.rng(run.seed, "sample").integers(0, len(passes)))
    t = time.perf_counter()
    checks = judge(s, passes[sample], run.limits, run.control)
    ref_s = time.perf_counter() - t
    window = {k: (None if c1[k] is None else c1[k] - (c0[k] or 0.0))
              for k in COUNTERS}
    real_pairs = len(s.cl.nodes) * sum(len(b["rows"]) for r in passes
                                       for b in r["batches"])
    return {"attempted": asked, "failed": asked - placed,
            "e2e": {"placements_per_s": placed / window_s,
                    "setup_s": setup_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "diag": {"setup_parts": setup_parts,
                     "window_s": window_s, "passes": len(passes),
                     "unplaced": failed, "sampled_pass": sample,
                     "batches": len(passes[sample]["batches"]),
                     "waves": [r["waves"] for r in passes],
                     "reference_s": ref_s, "counters": window,
                     "real_pairs": real_pairs,
                     "prologues": None if prologue is None
                     else len(prologue)}}


def judge(s: Stream, rec: Dict, limits: Dict, control: str = "") -> list:
    """The numbers that decide `correct` for one pass, each beside its
    limit.  With `control` ("bf16") the reference in that precision is
    put in the program's place for the choices."""
    cap = s.cl.capacity()
    resident = s.cl.resident_usage()
    nodes, spec, max_waves = s.cl.nodes, s.spec, s.run.mix["max_waves"]
    batches = []
    for b in rec["batches"]:
        rows = [(spec_group(spec, a), n) for a, n in b["rows"]]
        batches.append({"rows": rows, "seed": b["seed"],
                        "choice": b["choice"], "status": b["status"]})
    if control:
        ctl = ref_constrained.follow_pass(nodes, spec, cap, resident,
                                          batches, max_waves, control,
                                          own=True)
        for b, c in zip(batches, ctl):
            b["choice"], b["status"] = c["choice"], c["status"]
    ref = ref_constrained.follow_pass(nodes, spec, cap, resident, batches,
                                      max_waves)
    n = mism = 0
    for b, r in zip(batches, ref):
        n += len(r["status"])
        differ = (b["status"] != r["status"]) | (
            (r["status"] == ref_solver.STATUS_COMMITTED)
            & (b["choice"] != r["choice"]))
        mism += int(differ.sum())
    used = resident.astype(np.float64).copy()
    for b in batches:
        ref_stream.add_commits(used, b["choice"], b["status"],
                               *ref_stream.ask_rows(b["rows"]))
    prog_used = used.copy()
    if not control:
        real = s.pos_of >= 0
        prog_used[s.pos_of[real]] = rec["usage"][real][:, :used.shape[1]]
    asked = s.run.mix["evals_per_pass"] * sum(g.count for g in spec.groups)
    st = np.concatenate([b["status"] for b in batches])
    done = int((st == 1).sum() + (st == 0).sum())
    values = {
        "choice_mismatch": mism / max(n, 1),
        "usage_gap": float(np.abs(prog_used - used).max()),
        "oversubscribed_nodes": int((used > cap + 1e-9).any(axis=1).sum()),
        "lost_placements": abs(asked - done - rec["unresolved"]),
        "constraint_violations": ref_constrained.violations(nodes, spec,
                                                            batches),
    }
    return [(k, values[k], limits[k]) for k in limits]
