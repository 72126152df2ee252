#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nomad_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed phase exits nonzero:

  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build   — nvcc builds the fused wave kernel from
               nomad_tpu_torch/solver/csrc/ into nomad_tpu_torch/_build/.
  3. kernel  — the kernel against its plain torch version on the card at
               the main path's widths: score mode (Gp=128, Np=10,240,
               one spread over V=4, and once with device and blocked
               planes) and topk mode with per-value tables (Gp=4,
               Np=10,240, 128 extracted, TK=36).  Counters equal, scores
               within 4 ulp, indices equal wherever the plain scores are
               separated by more than that; median times of >= 20 launches.
  4. solve   — the slice end to end through `Solver(device="cuda").solve`
               on bench.py's config-3 cluster (10,000 nodes, 4 dcs, 64
               racks, 16 zones) loaded with 100,000 resident allocs:
               32 one-job evals in turn (fused topk mode), each eval's
               placements charged into allocs_by_node, then one merged
               32-job batch (128 groups, 2048 placements; fused score
               mode).  Launch counts are zeroed just before and read just
               after; the last one-eval batch and the merged batch are
               re-solved with the plain wave function and held to the
               reference's cross-backend criteria
               (tests/test_host_solver.py assert_same), and no node may
               end oversubscribed.

The line before the last lists every kernel with its launches on the main
path, error against the plain version, times and bound; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
nonzero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

#: H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): HBM bytes/s and
#: f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: scores of kernel and plain version may differ by this many ulp (the
#: reference's own cross-backend bound for 10**x, test_score_spec.py)
ULP_TOL = 4
#: bench.py config 3
N_NODES = 10_000
RESIDENT = 100_000
R_VEC = (200, 256, 300)          # resident alloc cpu, memory, disk
N_EVALS = 32
COUNT = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


# ------------------------------------------------------------ phase 2
def phase_build(wk):
    t0 = time.perf_counter()
    path = wk.build()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": os.path.relpath(path, HERE)})


# ------------------------------------------------------------ phase 3
def wave_inputs(torch, Gp, Np, S, V, D, with_blocked, seed, device):
    """Random fused-wave inputs at realistic magnitudes (integral cpu /
    memory / disk figures, small collocation counts, seeded jitter)."""
    from nomad_tpu_torch.solver.masks import pack_bool_u32
    rng = np.random.default_rng(seed)
    f32 = np.float32
    R = 4
    cap = np.stack([4000 + (np.arange(Np) % 8) * 1000,
                    8192 + (np.arange(Np) % 4) * 4096,
                    np.full(Np, 100_000), np.full(Np, 1000)], 1).astype(f32)
    n_res = rng.integers(0, 25, Np)
    used = (n_res[:, None] * np.array([200, 256, 300, 0])).astype(f32)
    ask = np.stack([400 + (np.arange(Gp) % 4) * 150,
                    256 + (np.arange(Gp) % 4) * 128,
                    np.full(Gp, 300), np.zeros(Gp)], 1).astype(f32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    bits = lambda p: t(rng.random((Gp, Np)) < p)   # noqa: E731
    kw = dict(
        feas=pack_bool_u32(bits(0.85)), pen=pack_bool_u32(bits(0.05)),
        blocked=pack_bool_u32(bits(0.05)) if with_blocked else None,
        aff=t((rng.random((Gp, Np)) < 0.1).astype(f32) * f32(0.5)),
        jitter=t((rng.integers(0, 1024, (Gp, Np)).astype(f32)
                  * f32(0.05 / 1023.0))),
        coll=t((rng.random((Gp, Np)) < 0.05).astype(f32)),
        used=t(used), avail=t(cap), reserved=t(np.zeros((Np, R), f32)),
        ask_res=t(ask), ask_desired=t(np.full(Gp, 16.0, f32)))
    if D:
        kw["dev"] = (t(rng.integers(0, 4, (Np, D)).astype(f32)),
                     t(np.full((Np, D), 4.0, f32)),
                     t((rng.random((Gp, D)) < 0.5).astype(f32)))
    vnode = np.broadcast_to(np.arange(Np) % V, (S, Gp, Np)).copy()
    vnode[rng.random((S, Gp, Np)) < 0.02] = -1
    sp_used = rng.integers(0, 6, (Gp, S, V)).astype(f32)
    pres = sp_used > 0
    anyp = pres.any(2)
    kw["spread"] = (
        t(vnode.astype(np.int16)),
        t(np.where(vnode >= 0, f32(16 / V), f32(-1.0)).astype(f32)),
        t(sp_used), t(np.ones((Gp, S), f32)),
        t(rng.random((Gp, S)) < 0.5), t(np.ones((Gp, S), np.int8)),
        t(np.where(anyp, np.where(pres, sp_used, np.inf).min(2), 0)
          .astype(f32)),
        t(np.where(anyp, sp_used.max(2), 0).astype(f32)),
        t(anyp.astype(np.int8)))
    return kw


def ulp_dist(torch, a, b):
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def time_ms(torch, fn, reps=30, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ops_per_pair(R, D, S):
    """f32 operations of the scoring chain for one (group, node) pair,
    counted from csrc/wave_kernel.cu: fit (2 per dimension + 2 utils),
    device fit (2 per device), bin-pack 14, anti 3, spread 15 per
    constraint, combine 13."""
    return 2 * R + 2 + 2 * D + 14 + 3 + 15 * S + 13


def compare_wave(torch, name, kw, res_k, res_p):
    for c in ("n_feas", "n_exh", "grp_any", "dim_exh"):
        check(torch.equal(res_k[c], res_p[c]), f"{name}: counter {c} "
              "differs between kernel and plain version")
    errs = []
    for s_key, i_key in (("score", None), ("top_score", "top_idx"),
                         ("tab_s", "tab_i")):
        if s_key not in res_p:
            continue
        sk, sp = res_k[s_key], res_p[s_key]
        check(sk.shape == sp.shape, f"{name}: {s_key} shape")
        mk, mp = sk > -1e29, sp > -1e29
        check(torch.equal(mk, mp), f"{name}: {s_key} masks differ")
        d = ulp_dist(torch, sk[mp], sp[mp])
        check(d.numel() == 0 or int(d.max()) <= ULP_TOL,
              f"{name}: {s_key} off by {int(d.max())} ulp")
        errs.append(float((sk[mp] - sp[mp]).abs().max())
                    if mp.any() else 0.0)
        if i_key is not None:
            sp2 = sp.reshape(-1, sp.shape[-1])
            ik = res_k[i_key].reshape(sp2.shape)
            ip = res_p[i_key].reshape(sp2.shape)
            gap = ulp_dist(torch, sp2[:, 1:], sp2[:, :-1]) > ULP_TOL
            sep = torch.ones_like(ik, dtype=torch.bool)
            sep[:, 1:] &= gap
            sep[:, :-1] &= gap
            check(torch.equal(ik[sep], ip[sep]),
                  f"{name}: {i_key} differs at separated scores")
    return max(errs)


def wave_bytes(torch, kw, res):
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)

    for v in kw.values():
        add(v)
    for v in res.values():
        add(v)
    return total


def phase_kernel(torch, wk):
    dev = torch.device(DEVICE)
    cases = [
        ("score", dict(Gp=128, Np=10240, S=1, V=4, D=0, with_blocked=False),
         dict(mode="score", TK=260, n_extract=384)),
        ("score+dev+blocked",
         dict(Gp=128, Np=10240, S=1, V=4, D=1, with_blocked=True),
         dict(mode="score", TK=260, n_extract=384)),
        ("topk+tables", dict(Gp=4, Np=10240, S=1, V=4, D=1,
                             with_blocked=False),
         dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ]
    out = {}
    for i, (name, shape, call) in enumerate(cases):
        kw = wave_inputs(torch, seed=100 + i, device=dev, **shape)
        kw.update(call, seed=1 + i)
        res_k = wk.fused_wave(**kw)
        res_p = wk.fused_wave_plain(**kw)
        torch.cuda.synchronize()
        err = compare_wave(torch, name, kw, res_k, res_p)
        ms = time_ms(torch, lambda: wk.fused_wave(**kw))
        plain_ms = time_ms(torch, lambda: wk.fused_wave_plain(**kw))
        nbytes = wave_bytes(torch, kw, res_k)
        ops = (shape["Gp"] * shape["Np"]
               * ops_per_pair(4, shape["D"], shape["S"]))
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / F32_OPS_S * 1e3
        row = {"phase": "kernel", "case": name, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
               "ops": ops, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               **shape, **{k: v for k, v in call.items() if k != "mode"}}
        emit(row)
        out[name] = row
    return out


# ------------------------------------------------------------ phase 4
def make_nodes(mock, n_nodes):
    """bench.py make_nodes (config 3 cluster, no devices, gen_seed 0)."""
    nodes = []
    for i in range(n_nodes):
        n = mock.node(datacenter=f"dc{i % 4}")
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.reserved_resources.disk_mb = 0
        n.attributes["kernel.name"] = "linux"
        n.attributes["rack"] = f"r{i % 64}"
        n.attributes["zone"] = f"z{i % 16}"
        n.node_resources.cpu = 4000 + (i % 8) * 1000
        n.node_resources.memory_mb = 8192 + (i % 4) * 4096
        n.node_resources.disk_mb = 100_000
        for net in n.node_resources.networks:
            net.mbits = 1000
        n.compute_class()
        nodes.append(n)
    return nodes


def make_job(mock, structs, eval_ix, count):
    """bench.py make_job, config 3: two constraints, a rack affinity, a
    datacenter spread, 4 groups of count // 4."""
    import copy
    job = mock.job()
    job.id = f"job-3-{eval_ix}"
    job.name = job.id
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints = [
        structs.Constraint("${attr.rack}", "r63", "!="),
        structs.Constraint("${attr.zone}", "z1", ">="),       # lexical
    ]
    job.affinities = [structs.Affinity(ltarget="${attr.rack}", rtarget="r7",
                                       operand="=", weight=35)]
    job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                  weight=50)]
    base = job.task_groups[0]
    groups = []
    for g in range(4):
        tg = copy.deepcopy(base)
        tg.name = f"g{g}"
        tg.count = count // 4
        tg.constraints = []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 400 + (g % 4) * 150
        t.resources.memory_mb = 256 + (g % 4) * 128
        t.resources.devices = []
        tg.ephemeral_disk.size_mb = 300
        groups.append(tg)
    job.task_groups = groups
    return job


def asks_for(job):
    from nomad_tpu_torch.solver.tensorize import PlacementAsk
    return [PlacementAsk(job=job, tg=tg, count=tg.count)
            for tg in job.task_groups]


def resident_allocs(mock, nodes, n_allocs):
    """n_allocs live allocs spread round-robin, each using R_VEC."""
    from nomad_tpu_torch.structs import (AllocatedResources,
                                         AllocatedSharedResources,
                                         AllocatedTaskResources)
    job = mock.job()
    job.id = "resident"
    by_node = {}
    for k in range(n_allocs):
        nd = nodes[k % len(nodes)]
        a = mock.alloc(job=job, node_id=nd.id)
        a.allocated_resources = AllocatedResources(
            tasks={"web": AllocatedTaskResources(cpu=R_VEC[0],
                                                 memory_mb=R_VEC[1])},
            shared=AllocatedSharedResources(disk_mb=R_VEC[2]))
        by_node.setdefault(nd.id, []).append(a)
    return by_node


def charge(mock, by_node, job, asks, out):
    """Apply an eval's placements the way the plan applier would: each
    placed alloc joins its node's live allocs."""
    placed = 0
    for p in out.placements:
        if p.node is None:
            continue
        a = mock.alloc(job=job, node_id=p.node.id,
                       task_group=asks[p.ask_index].tg.name)
        a.allocated_resources = p.resources
        by_node.setdefault(p.node.id, []).append(a)
        placed += 1
    return placed


@contextlib.contextmanager
def plain_wave(wk):
    """Route solve_kernel's wave calls to the plain torch version."""
    real = wk.fused_wave
    wk.fused_wave = wk.fused_wave_plain
    try:
        yield
    finally:
        wk.fused_wave = real


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]


def assert_same(a, b, what):
    """tests/test_host_solver.py assert_same, plus wave counters."""
    ok_a, ok_b = a.choice_ok, b.choice_ok
    check(np.array_equal(ok_a, ok_b), f"{what}: choice_ok differs")
    check(np.array_equal(np.where(ok_a, a.choice, -1),
                         np.where(ok_b, b.choice, -1)),
          f"{what}: choice differs")
    check(np.allclose(np.where(ok_a, a.score, 0.0),
                      np.where(ok_b, b.score, 0.0), rtol=2e-5, atol=2e-5),
          f"{what}: scores differ")
    check(np.allclose(a.used_final, b.used_final, rtol=1e-5),
          f"{what}: used_final differs")
    for f in ("unfinished", "n_feasible", "feas"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")
    check(a.n_waves == b.n_waves and a.n_rescore == b.n_rescore,
          f"{what}: waves {a.n_waves}/{b.n_waves} rescore "
          f"{a.n_rescore}/{b.n_rescore}")


def phase_solve(torch, wk, n_nodes, resident, n_evals):
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.solver.solve import (Solver, _run_kernel,
                                              _to_host)
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    by_node = resident_allocs(mock, nodes, resident)
    setup_s = time.perf_counter() - t0
    jobs = [make_job(mock, structs, e, COUNT) for e in range(2 * n_evals)]
    solver = Solver(device=DEVICE)
    merged_jobs = jobs[n_evals:]
    merged_asks = [a for j in merged_jobs for a in asks_for(j)]

    # ---- the main path, launch counts zeroed just before ----
    wk.fused_wave.launches = 0
    wk.fused_wave.mode_launches = {"score": 0, "topk": 0}
    torch.cuda.synchronize()
    walls, placed, failed, waves, resc = [], 0, 0, [], []
    packs, devs = [], []
    for e, job in enumerate(jobs[:n_evals]):
        asks = asks_for(job)
        if e == n_evals - 1:
            # the last eval's batch, packed here for the checks below
            pb_one = solver._tensorizer.pack(nodes, asks, by_node)
        t1 = time.perf_counter()
        out = solver.solve(nodes, asks, by_node)
        walls.append(time.perf_counter() - t1)
        packs.append(out.trace["pack_wall_s"])
        # launch-to-fetch: the wave loop on the card and its host driving
        devs.append(out.trace["dispatch_wall_s"] - out.trace["pack_wall_s"]
                    + out.trace["fetch_wall_s"])
        waves.append(out.trace["waves"])
        resc.append(out.trace["rescore_waves"])
        n = charge(mock, by_node, job, asks, out)
        placed += n
        failed += len(out.placements) - n
    topk_launches = wk.fused_wave.mode_launches["topk"]
    # the merged batch: packed once here so the checks below re-solve
    # exactly what Solver.solve solved
    pb = solver._tensorizer.pack(nodes, merged_asks, by_node)
    t1 = time.perf_counter()
    m_out = solver.solve(nodes, merged_asks, by_node)
    merged_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    counts = {"score": wk.fused_wave.mode_launches["score"],
              "topk": wk.fused_wave.mode_launches["topk"]}
    m_placed = sum(p.node is not None for p in m_out.placements)
    check(counts["topk"] > 0, "one-eval solves launched no topk kernel")
    check(counts["score"] > 0, "merged batch launched no score kernel")
    check(topk_launches == counts["topk"],
          "merged batch unexpectedly ran topk mode")
    check(placed > 0 and m_placed > 0, "nothing was placed")
    for p in m_out.placements:
        check(p.node is None or np.isfinite(p.score), "non-finite score")

    # ---- checks (launches here are not counted) ----
    for what, batch in (("last one-eval batch", pb_one),
                        ("merged batch", pb)):
        res_k = _to_host(_run_kernel(batch, DEVICE))
        with plain_wave(wk):
            res_p = _to_host(_run_kernel(batch, DEVICE))
        assert_same(res_k, res_p, f"{what}: kernel vs plain")
        real = batch.n_real
        check(bool(np.all(res_k.used_final[:real] <= batch.avail[:real])),
              f"{what}: a node is oversubscribed")
        check(np.isfinite(res_k.score[res_k.choice_ok]).all(),
              f"{what}: non-finite committed score")
    row = {"phase": "solve", "nodes": n_nodes, "resident_allocs": resident,
           "resident_cut": RESIDENT - resident, "setup_s": setup_s,
           "one_eval": {"evals": n_evals, "placed": placed,
                        "failed": failed, "waves": waves,
                        "rescore_waves": resc,
                        "p50_ms": 1e3 * pct(walls, 0.5),
                        "p99_ms": 1e3 * pct(walls, 0.99),
                        "pack_p50_ms": 1e3 * pct(packs, 0.5),
                        "device_solve_p50_ms": 1e3 * pct(devs, 0.5)},
           "merged": {"groups": len(merged_asks),
                      "placements": len(m_out.placements),
                      "placed": m_placed,
                      "failed": len(m_out.placements) - m_placed,
                      "failed_reasons": dict(collections.Counter(
                          p.failed_reason for p in m_out.placements
                          if p.node is None)),
                      "waves": m_out.trace["waves"],
                      "rescore_waves": m_out.trace["rescore_waves"],
                      "wall_s": merged_s,
                      "pack_s": m_out.trace["pack_wall_s"],
                      "device_solve_s": m_out.trace["dispatch_wall_s"]
                      - m_out.trace["pack_wall_s"]
                      + m_out.trace["fetch_wall_s"],
                      "placements_per_s": m_placed / merged_s},
           "launches": counts}
    emit(row)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nomad_tpu_torch.solver import wave_kernel as wk

    card = phase_device(torch)
    phase_build(wk)
    kern = phase_kernel(torch, wk)
    counts = phase_solve(torch, wk, N_NODES, RESIDENT, N_EVALS)
    src = "nomad_tpu_torch/solver/csrc/wave_kernel.cu"
    kernels = []
    for mode, case, line in (("score", "score", 317),
                             ("topk", "topk+tables", 543)):
        r = kern[case]
        kernels.append({
            "name": f"fused_wave[{mode}]", "route": "cuda", "source": src,
            "replaces": f"nomad_tpu/solver/pallas_kernel.py:{line}",
            "launches": counts[mode], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
