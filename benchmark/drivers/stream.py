"""Entry "stream": passes of merged evals through the port's
`ResidentSolver.solve_stream_pipelined`, then its retry drains.

A pass starts from the seeded resident usage (`reset_usage`, inside the
window), packs `evals_per_pass` evals in chunks of `evals_per_chunk`
merged evals through the benchmark's pack callback (`merge_asks`,
`pack_batch_cached`), dispatches them pipelined, and drains what the
wave budget left in merged rows of `drain_row`.  Passes repeat until the
window has lasted `--seconds`; each pass has jobs of its own (ids from
the seed), made during set-up.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .. import gen, harness, peaks, port
from ..devtrace import DeviceTrace
from ..reference import solver as ref_solver
from ..reference import stream as ref_stream

def pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class Stream:
    """Set-up, the window and the records of one run."""

    def __init__(self, run):
        import torch
        from nomad_tpu_torch.solver.resident import ResidentSolver
        from nomad_tpu_torch.solver.tensorize import Tensorizer
        self.run = run
        self.torch = torch
        cfg, mix, seed = run.cfg, run.mix, run.seed
        self.cl = gen.cluster(cfg, seed)
        self.spec = gen.job(cfg, "probe")
        self.maker = port.JobMaker(self.spec)
        self.epc = mix["evals_per_chunk"]
        self.n_chunks = mix["evals_per_pass"] // self.epc
        count = sum(g.count for g in self.spec.groups)
        if run.device == "cuda":
            from nomad_tpu_torch.solver import wave_kernel
            wave_kernel._load()              # nvcc, or the cached build
        probe = port.asks(self.maker.make("probe"))
        gp = pow2(len({Tensorizer.ask_signature(a) for a in probe}))
        self.rs = ResidentSolver(port.nodes(self.cl), probe, gp=gp,
                                 kp=pow2(count * self.epc),
                                 max_waves=mix["max_waves"], pallas="auto",
                                 device=run.device)
        self.used0 = port.used0(self.rs.template, self.rs.node_index,
                                self.cl)
        self.pass_jobs = [self._jobs(f"p{p}")
                          for p in range(mix["job_sets"])]
        self.warm_jobs = self._jobs("warm")
        self.pos_of = np.full(self.rs.template.used0.shape[0], -1,
                              np.int64)
        for k, pn in enumerate(self.cl.nodes):
            self.pos_of[self.rs.node_index[pn.id]] = k

    def _jobs(self, tag: str) -> List[list]:
        name = self.run.cfg["name"]
        out = []
        for e in range(self.run.mix["evals_per_pass"]):
            out.append(port.asks(self.maker.make(
                f"{name}-{self.run.seed}-{tag}-e{e}")))
        return out

    def one_pass(self, jobs: List[list], seeds: List[int]) -> Dict:
        """One pass from the seeded usage; returns its record."""
        torch, rs, epc = self.torch, self.rs, self.epc
        mix = self.run.mix
        rec = {"pack_s": 0.0, "batches": [], "waves": 0}
        t0 = time.perf_counter()
        rs.reset_usage(used0=self.used0)
        packed = []

        def pack(i):
            t = time.perf_counter()
            merged, keys = rs.merge_asks(sum(jobs[i:i + epc], []))
            pb = rs.pack_batch_cached(merged, job_keys=keys)
            rec["pack_s"] += time.perf_counter() - t
            if pb is None:
                raise RuntimeError("a chunk fell outside the universe")
            packed.append((merged, pb))
            return pb

        out = rs.solve_stream_pipelined(
            [b * epc for b in range(self.n_chunks)],
            seeds=seeds[:self.n_chunks], pack=pack)
        rec["waves"] += sum(int(np.asarray(w)[0]) for w in rs.last_waves)
        choice, _ok, _score, status = out
        for b, (merged, pb) in enumerate(packed):
            rec["batches"].append(self._batch(merged, pb, seeds[b],
                                              choice[b], status[b]))
        cur = self._retries(rec["batches"])
        for r in range(mix["drain_rounds"]):
            if not cur:
                break
            chunks = drain_chunks(cur, rs.gp, rs.kp, mix["drain_row"])
            pbs = []
            for c in chunks:
                t = time.perf_counter()
                pb = rs.pack_batch(c)
                rec["pack_s"] += time.perf_counter() - t
                if pb is None:
                    raise RuntimeError("a drain chunk fell outside the "
                                       "universe")
                pbs.append(pb)
            dseeds = seeds[self.n_chunks + r * 64:][:len(pbs)]
            douts = []
            for pb, s in zip(pbs, dseeds):
                douts.append(rs.solve_stream_async([pb], seeds=[s]))
                rec["waves"] += int(np.asarray(rs.last_waves)[0])
            dch, _dok, _ds, dst = rs.finish_stream(torch.cat(douts))
            new = [self._batch(c, pb, s, dch[i], dst[i])
                   for i, (c, pb, s) in enumerate(zip(chunks, pbs,
                                                      dseeds))]
            rec["batches"].extend(new)
            cur = self._retries(new)
        rec["usage"] = rs.usage()[0]
        rec["wall_s"] = time.perf_counter() - t0
        st = np.concatenate([b["status"] for b in rec["batches"]])
        rec["placed"] = int((st == 1).sum())
        rec["failed"] = int((st == 0).sum())
        rec["unresolved"] = sum(n for _, n in cur)
        return rec

    def _batch(self, merged, pb, seed, choice, status) -> Dict:
        n = pb.n_place
        return {"merged": merged, "rows": [(a, a.count) for a in merged],
                "seed": int(seed), "n_place": n,
                "p_ask": np.asarray(pb.p_ask[:n]),
                "choice": self.pos_of[np.asarray(choice[:n, 0])],
                "status": np.asarray(status[:n])}

    @staticmethod
    def _retries(batches) -> list:
        out = []
        for b in batches:
            retry = b["status"] == ref_solver.STATUS_RETRY
            if not retry.any():
                continue
            per = np.bincount(b["p_ask"][retry],
                              minlength=len(b["merged"]))
            out += [(a, int(r)) for a, r in zip(b["merged"], per) if r]
        return out


def drain_chunks(cur, gp_cap: int, kp_cap: int, row: int) -> List[list]:
    """Retries split into rows of at most `row`, filled greedily into
    chunks under the solver's group and placement caps (chip_smoke.py
    `drain_chunks`, bench.py's merged drain rows)."""
    import dataclasses
    split = []
    for a, r in cur:
        while r > row:
            split.append(dataclasses.replace(a, count=row))
            r -= row
        split.append(dataclasses.replace(a, count=r))
    chunks, chunk, k = [], [], 0
    for a in split:
        if chunk and (len(chunk) + 1 > gp_cap or k + a.count > kp_cap):
            chunks.append(chunk)
            chunk, k = [], 0
        chunk.append(a)
        k += a.count
    if chunk:
        chunks.append(chunk)
    return chunks


class WaveBytes:
    """Counts the bytes of every fused-wave call while installed."""

    def __init__(self):
        from nomad_tpu_torch.solver import wave_kernel as wk
        self.wk, self.real = wk, wk.fused_wave
        self.bytes = 0

        def wave(**kw):
            res = self.real(**kw)
            self.bytes += peaks.wave_bytes(kw, res)
            return res
        # the wrapper's own counters are read through the module name
        wave.launches = self.real.launches
        wave.mode_launches = self.real.mode_launches
        self.wave = wave

    def __enter__(self):
        self.wk.fused_wave = self.wave
        return self

    def __exit__(self, *exc):
        self.real.launches = self.wave.launches
        self.wk.fused_wave = self.real
        return False


def run(run) -> Dict:
    import torch
    s = Stream(run)
    mix = run.mix
    n_seeds = s.n_chunks + 64 * mix["drain_rounds"]
    s.one_pass(s.warm_jobs, gen.tie_seeds(run.seed, "warm", n_seeds))
    harness.settle()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - run.t0

    passes, traced = [], None
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
    peak = (torch.cuda.max_memory_allocated() if run.device == "cuda"
            else 0)
    if traced:
        traced["summary"] = traced.pop("trace").summarize()

    placed = sum(r["placed"] for r in passes)
    asked = len(passes) * mix["evals_per_pass"] * sum(
        g.count for g in s.spec.groups)
    failed = sum(r["failed"] + r["unresolved"] for r in passes)
    layer = {"pack_ms_per_chunk": 1e3 * sum(r["pack_s"] for r in passes)
             / sum(len(r["batches"]) for r in passes),
             "solve_s": sum(r["wall_s"] - r["pack_s"] for r in passes),
             "waves": sum(r["waves"] for r in passes),
             "traced": traced}
    sample = int(gen.rng(run.seed, "sample").integers(0, len(passes)))
    checks = judge(s, passes[sample], run.limits, run.control)
    return {"attempted": asked, "failed": asked - placed,
            "e2e": {"placements_per_s": placed / window_s,
                    "setup_s": setup_s},
            "layer": layer, "memory_peak_bytes": peak, "checks": checks,
            "diag": {"window_s": window_s, "passes": len(passes),
                     "unplaced": failed, "sampled_pass": sample,
                     "batches": len(passes[sample]["batches"]),
                     "waves": [r["waves"] for r in passes]}}


def judge(s: Stream, rec: Dict, limits: Dict, control: str = "") -> list:
    """The numbers that decide `correct` for one pass, each beside its
    limit.  With `control` ("bf16") the reference in that precision is
    put in the program's place for the choices."""
    cap = s.cl.capacity()
    resident = s.cl.resident_usage()
    batches = []
    for b in rec["batches"]:
        rows = [(spec_group(s.spec, a), n) for a, n in b["rows"]]
        batches.append({"rows": rows, "seed": b["seed"],
                        "choice": b["choice"], "status": b["status"]})
    if control:
        ctl = ref_stream.follow_pass(cap, resident, batches,
                                     s.run.mix["max_waves"], control,
                                     own=True)
        for b, c in zip(batches, ctl):
            b["choice"], b["status"] = c["choice"], c["status"]
    ref = ref_stream.follow_pass(cap, resident, batches,
                                 s.run.mix["max_waves"])
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
    asked = s.run.mix["evals_per_pass"] * sum(g.count
                                              for g in s.spec.groups)
    st = np.concatenate([b["status"] for b in batches])
    done = int((st == 1).sum() + (st == 0).sum())
    values = {
        "choice_mismatch": mism / max(n, 1),
        "usage_gap": float(np.abs(prog_used - used).max()),
        "oversubscribed_nodes": int((used > cap + 1e-9).any(axis=1).sum()),
        "lost_placements": abs(asked - done - rec["unresolved"]),
    }
    return [(k, values[k], limits[k]) for k in limits]


def spec_group(spec, ask):
    """The plain group of a merged port ask (by group name)."""
    for g in spec.groups:
        if g.name == ask.tg.name:
            return g
    raise KeyError(ask.tg.name)
