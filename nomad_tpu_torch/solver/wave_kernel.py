"""Fused wave scoring for the placement solve: a CUDA kernel for Hopper.

The counterpart of `nomad_tpu/solver/pallas_kernel.py`.  It replaces that
module's TPU kernel `fused_wave` (`pl.pallas_call` of `_wave_tile_kernel`,
modes "score" and "topk", with the per-value spread tables) with one
hand-written CUDA C++ source, `csrc/wave_kernel.cu`, built with nvcc for
sm_90a:

  mode "score": a block owns a 1,024-node stripe for a few groups, reads
      the node rows once and the [Gp, Np] planes 16 bytes a thread, writes
      the score plane and folds the per-group explainability counters in
      with one atomic per block, group and counter slot;
  mode "topk": one block per (256-node tile, group) ranks the tile's
      entries in (score desc, column asc) order by counting, and writes its
      top `n_extract` keys — and, with `tables_v`, those of each spread
      value class plus the missing-value class — so the [Gp, Np] plane
      never reaches device memory; a second kernel merges the tile lists
      (binary-search ranks, no sort), so the lower column stays first
      among equal scores (torch.topk does not promise that order).

Bound on the H100: memory.  A score wave must read the three f32
[Gp, Np] planes (affinity, jitter, collocation), the spread planes (i16
value ranks, f32 desired counts), the bit-packed masks and the small
[Np, R] node planes, and write the f32 score plane: at Gp=128,
Np=10,240 about 30 MB, 9 us at 3.35 TB/s.  A topk wave at Gp=4 moves
1.3 MB and is bound by the depth of its dependent steps.  The design
notes are in the source; `PERF.md` holds the measured times beside the
bounds.

`launch_plan` is the launch geometry as plain Python (the CPU tests check
it).  `fused_wave` launches the kernels for CUDA tensors and counts each
call in `fused_wave.launches` and per mode in `fused_wave.mode_launches`
("score", "topk", and "merge" for the topk merge kernel that every topk
call launches); for CPU tensors it returns `fused_wave_plain`, the same
function in plain torch (the CPU tests and chip_smoke.py's comparison use
it).  There is no fallback: a failed build or launch, or a launch the
plan cannot fit, raises.  The shared library is built from `csrc/` on
first use into `nomad_tpu_torch/_build/`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from .masks import unpack_bool_u32

NEG_INF = -1e30
SCORE_BIN = 0.05
#: largest candidate window the in-kernel iterative extraction serves;
#: wider windows use mode "score"
TOPK_MAX = 256
#: spread value-vocabulary cap of the fused path (above it: mode "off")
_V_MAX = 16
#: the reference's per-tile working-set budget, in [Gp, T] elements; the
#: mode pick keeps its tile rule so both packages pick the same mode
_TILE_ELEMS = 1 << 18
#: counter slots before the per-dimension ones: n_feas, n_exh, n_placeable
_CNT_HEAD = 3

# CUDA launch geometry (the constants of csrc/wave_kernel.cu)
#: score mode: threads a block, nodes a thread, most groups a block
SCORE_THREADS, SCORE_NODES, SCORE_MAX_GB = 256, 4, 8
#: topk mode: node-tile width, one node a thread and one tile a block
TOPK_TILE = 256
MERGE_THREADS = 1024
#: widest topk row (n_extract, or the table width) the merge serves
MERGE_MAX_WIDTH = 1024
#: the H100's streaming multiprocessors and a block's shared-memory limit
N_SMS = 132
SMEM_LIMIT = 232_448
#: shared memory the merge aims to stay within (room for two blocks an SM)
_MERGE_SMEM_BUDGET = 96 * 1024

_R_CPU, _R_MEM = 0, 1

_CSRC = Path(__file__).resolve().parent / "csrc" / "wave_kernel.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def pick_tile(Np: int, Gp: int) -> int:
    """The reference's node-tile rule (pallas_kernel.pick_tile): largest
    lane-aligned divisor of Np within the working-set budget."""
    budget = max(_TILE_ELEMS // max(Gp, 1), 128)
    for t in (2048, 1024, 512, 256, 128):
        if Np % t == 0 and t <= budget:
            return t
    return Np


def launch_plan(mode: str, Gp: int, Np: int, NE: int = 0, TK: int = 0,
                tables_v: int = 0) -> dict:
    """Geometry of one CUDA launch of the fused wave, as a plain dict (no
    torch, no GPU): what `_launch` passes to csrc/wave_kernel.cu.

      score: a block of SCORE_THREADS threads owns a stripe of
             SCORE_THREADS * SCORE_NODES nodes for `groups_per_block`
             groups, the fewest that keep the grid within one round of
             two blocks an SM (the kernel's ~100 registers a thread allow
             two), so no second round of a few blocks trails the first.
      topk:  one block per (TOPK_TILE-node tile, group); each tile writes
             `partial_widths[t]` sorted keys (`table_partial_widths[t]`
             per class table); the merge runs one block of
             MERGE_THREADS per (group, list) and merges `merge_batch` tile
             lists of `merge_width` keys at a time in `merge_smem` bytes of
             dynamic shared memory.

    Raises ValueError for a topk row wider than MERGE_MAX_WIDTH (the
    merge holds a list in a warp's registers)."""
    if mode == "score":
        stripe = SCORE_THREADS * SCORE_NODES
        stripes = -(-Np // stripe)
        gb = max(1, min(SCORE_MAX_GB, -(-stripes * Gp // (2 * N_SMS)), Gp))
        return {"mode": mode, "threads": SCORE_THREADS, "stripe": stripe,
                "groups_per_block": gb, "grid": (stripes, -(-Gp // gb)),
                "smem": 0}
    if mode != "topk":
        raise ValueError(f"fused_wave: unknown mode {mode!r}")
    NE = NE or TK
    T = TOPK_TILE
    n_tiles = -(-Np // T)
    lens = [min(T, Np - t * T) for t in range(n_tiles)]
    TKt = min(NE, T)
    Vs = tables_v
    TKv = -(-TK // (Vs + 1)) if Vs else 0
    TKvt = min(TKv, T)
    # the merge's list width: the widest output, rounded up to a power of
    # two and at least a warp (one key a lane and register)
    Kw = max(32, 1 << (max(NE, TKv) - 1).bit_length())
    if Kw > MERGE_MAX_WIDTH:
        raise ValueError(f"fused_wave: the topk merge takes at most "
                         f"{MERGE_MAX_WIDTH} entries a row, not {NE}")
    batch = max(1, min(n_tiles, _MERGE_SMEM_BUDGET // (16 * Kw) - 1))
    # two buffers of batch + 1 lists of 8-byte keys, and their lengths
    smem = (batch + 1) * (16 * Kw + 8)
    return {"mode": mode, "threads": T, "tile": T, "n_tiles": n_tiles,
            "grid": (n_tiles, Gp), "smem": 0, "NE": NE, "TKt": TKt,
            "Vs": Vs, "TKv": TKv, "TKvt": TKvt,
            "partial_widths": [min(TKt, n) for n in lens],
            "table_partial_widths": [min(TKvt, n) for n in lens]
            if Vs else [],
            "merge_grid": (Gp, Vs + 2 if Vs else 1),
            "merge_threads": MERGE_THREADS, "merge_batch": batch,
            "merge_width": Kw, "merge_smem": smem}


def resolve_mode(Np: int, Gp: int, TK: int, V: int, has_spread: bool,
                 on: bool = True) -> str:
    """Mode pick for solve_kernel, the reference's `resolve_mode` with
    the fused path enabled (`on`): "topk" for windows the in-kernel
    extraction serves, "score" for wider ones, "off" outside the fused
    universe."""
    if not on:
        return "off"
    if has_spread and V > _V_MAX:
        return "off"
    T = pick_tile(Np, Gp)
    if Np % T != 0:
        return "off"
    if TK <= TOPK_MAX:
        return "topk"
    return "score"


# ------------------------------------------------------------- build
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused wave kernel is built "
                       "from csrc/ with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    digest = hashlib.sha256(_CSRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"wave_kernel_{digest[:16]}.so"


def build() -> Path:
    """Compile csrc/wave_kernel.cu into the build directory (no-op when
    the library for this source and these flags exists).  Raises on a
    compiler error.  ptxas's report of each kernel's registers, shared
    memory and spills (`-Xptxas -v`, which changes no code) is kept
    beside the library as `<library>.ptxas.txt`."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(_CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    Path(str(out) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.nomad_wave_launch
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([I] + [P] * 23 + [I] * 7 + [P] * 9 + [I] * 10
                           + [P])
            fn.restype = I
            _lib = lib
    return _lib


# -------------------------------------------------------- shared parts
def _lex_topk_rows(s: torch.Tensor, i: torch.Tensor, k: int, n_real: int):
    """Top-k of each row in (score desc, position asc) order, padded to k
    with (NEG_INF, 0) where a row holds fewer than k real entries — the
    reference's lax.top_k merge and its padding.  A stable sort keeps
    equal scores in position order (`0.0 - s` gives -0.0 and 0.0 one
    key)."""
    kk = min(k, n_real)
    pos = torch.argsort(0.0 - s, dim=-1, stable=True)[..., :kk]
    ts = torch.gather(s, -1, pos)
    ti = torch.gather(i, -1, pos)
    if kk < k:
        pad = s.shape[:-1] + (k - kk,)
        ts = torch.cat([ts, torch.full(pad, NEG_INF, dtype=ts.dtype,
                                       device=ts.device)], dim=-1)
        ti = torch.cat([ti, torch.zeros(pad, dtype=ti.dtype,
                                        device=ti.device)], dim=-1)
    return ts, ti


def _counters(cnt: torch.Tensor, R: int) -> dict:
    return {"n_feas": cnt[:, 0], "n_exh": cnt[:, 1],
            "grp_any": cnt[:, 2] > 0,
            "dim_exh": cnt[:, _CNT_HEAD:_CNT_HEAD + R]}


# ------------------------------------------------------ plain version
def fused_wave_plain(*, mode, feas, blocked, aff, pen, jitter, coll, used,
                     avail, reserved, ask_res, ask_desired, dev=None,
                     spread=None, seed=0, TK=4, n_extract=0, tables_v=0):
    """`fused_wave` in plain torch: the same inputs, the same outputs,
    the same float-op sequence (the reference tile kernel's), on the
    whole [Gp, Np] plane at once."""
    f32 = torch.float32
    Gp = feas.shape[0]
    Np, R = used.shape
    feas_b = unpack_bool_u32(feas, Np)
    if blocked is not None:
        feas_b = feas_b & ~unpack_bool_u32(blocked, Np)

    after = used[None, :, :] + ask_res[:, None, :]          # [Gp, Np, R]
    fit_dims = after <= avail[None, :, :]
    fit = fit_dims.all(dim=-1)
    dim_fail = (feas_b[:, :, None] & ~fit_dims).sum(dim=1)
    util_cpu = after[:, :, _R_CPU] + reserved[None, :, _R_CPU]
    util_mem = after[:, :, _R_MEM] + reserved[None, :, _R_MEM]
    denom_cpu = avail[None, :, _R_CPU]
    denom_mem = avail[None, :, _R_MEM]
    if dev is not None:
        dev_used, dev_cap, dev_ask = dev
        dev_fit = ((dev_used[None, :, :] + dev_ask[:, None, :])
                   <= dev_cap[None, :, :]).all(dim=-1)
    else:
        dev_fit = torch.ones_like(fit)
    placeable = feas_b & fit & dev_fit

    ok_denoms = (denom_cpu > 0) & (denom_mem > 0)
    free_cpu = 1.0 - util_cpu / torch.clamp(denom_cpu, min=1.0)
    free_mem = 1.0 - util_mem / torch.clamp(denom_mem, min=1.0)
    raw = 20.0 - (torch.pow(10.0, free_cpu) + torch.pow(10.0, free_mem))
    binpack = torch.where(ok_denoms, torch.clamp(raw, 0.0, 18.0) / 18.0,
                          0.0)

    anti = torch.where(coll > 0, -(coll + 1.0) / ask_desired[:, None], 0.0)
    anti_counts = (coll > 0).to(f32)

    spread_total = torch.zeros((Gp, Np), dtype=f32, device=used.device)
    if spread is not None:
        (sp_vnode, sp_des, sp_used, sp_weight, sp_targeted, sp_has, minc,
         maxc, anyp) = spread
        S, V = sp_vnode.shape[0], sp_used.shape[2]
        for s in range(S):
            has = sp_has[:, s][:, None] != 0
            v = sp_vnode[s]
            has_v = v >= 0
            cur = torch.zeros((Gp, Np), dtype=f32, device=used.device)
            for val in range(V):
                cur = cur + torch.where(v == val, sp_used[:, s, val][:, None],
                                        0.0)
            desired = sp_des[s]
            boost = ((desired - (cur + 1.0))
                     / torch.clamp(desired, min=1e-9)
                     ) * sp_weight[:, s][:, None]
            targeted = torch.where(~has_v, -1.0,
                                   torch.where(desired <= 0, -1.0, boost))
            mn = minc[:, s][:, None]
            mx = maxc[:, s][:, None]
            ap = anyp[:, s][:, None] != 0
            delta_boost = (mn - cur) / torch.clamp(mn, min=1e-9)
            even = torch.where(cur != mn, delta_boost,
                               torch.where(mn == mx, -1.0,
                                           (mx - mn)
                                           / torch.clamp(mn, min=1e-9)))
            even = torch.where(~has_v, -1.0, even)
            even = torch.where(ap, even, 0.0)
            contrib = torch.where(sp_targeted[:, s][:, None] != 0, targeted,
                                  even)
            spread_total = spread_total + torch.where(has, contrib, 0.0)
    spread_counts = (spread_total != 0.0).to(f32)

    pen_b = unpack_bool_u32(pen, Np)
    pen_score = torch.where(pen_b, -1.0, 0.0)
    aff_counts = (aff != 0.0).to(f32)
    n_scorers = (1.0 + anti_counts + pen_b.to(f32) + aff_counts
                 + spread_counts)
    total = (binpack + anti + pen_score + aff + spread_total) / n_scorers
    if int(seed) != 0:
        total = torch.floor(total / SCORE_BIN) * SCORE_BIN
    total = total + jitter
    score = torch.where(placeable, total, NEG_INF)

    i32 = torch.int32
    cnt = torch.cat([feas_b.sum(dim=1, keepdim=True),
                     (feas_b & ~(fit & dev_fit)).sum(dim=1, keepdim=True),
                     placeable.sum(dim=1, keepdim=True), dim_fail],
                    dim=1).to(i32)
    res = _counters(cnt, R)
    if mode == "score":
        res["score"] = score
        return res
    cols = torch.arange(Np, dtype=i32, device=used.device).expand(Gp, Np)
    res["top_score"], res["top_idx"] = _lex_topk_rows(
        score, cols, n_extract or TK, Np)
    if tables_v > 0:
        Vs = tables_v
        TKv = -(-TK // (Vs + 1))
        vnode0 = spread[0][0]
        tabs_s, tabs_i = [], []
        for vv in range(Vs + 1):
            vmask = (vnode0 == vv) if vv < Vs else (vnode0 < 0)
            ts, ti = _lex_topk_rows(torch.where(vmask, score, NEG_INF),
                                    cols, TKv, Np)
            tabs_s.append(ts)
            tabs_i.append(ti)
        res["tab_s"] = torch.stack(tabs_s, dim=1)      # [Gp, Vs+1, TKv]
        res["tab_i"] = torch.stack(tabs_i, dim=1)
    return res


# ------------------------------------------------------------ kernel
def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_wave: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"fused_wave: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_wave: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_wave: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_wave: {name} must be contiguous")
    return t


def fused_wave(*, mode, feas, blocked, aff, pen, jitter, coll, used, avail,
               reserved, ask_res, ask_desired, dev=None, spread=None,
               seed=0, TK=4, n_extract=0, tables_v=0):
    """One fused pass producing the wave's scoring outputs (the
    reference `pallas_kernel.fused_wave` contract).  Returns a dict:

      mode "score": score [Gp, Np] f32 and the counters;
      mode "topk":  top_score / top_idx [Gp, n_extract or TK] (exact lex
                    order), the counters, and with tables_v > 0
                    tab_s / tab_i [Gp, tables_v + 1, ceil(TK/(tables_v+1))].

    counters: n_feas [Gp] i32, n_exh [Gp] i32, grp_any [Gp] bool,
    dim_exh [Gp, R] i32.  `feas`, `pen` and `blocked` are bit-packed
    int32 words [Gp, ceil(Np/32)] (masks.pack_bool_u32); `spread` packs
    (sp_vnode i16 [S,Gp,Np], sp_des [S,Gp,Np], sp_used [Gp,S,V],
    sp_weight [Gp,S], sp_targeted [Gp,S], sp_has i8 [Gp,S], minc [Gp,S],
    maxc [Gp,S], anyp i8 [Gp,S]); `dev` packs (dev_used [Np,D],
    dev_cap [Np,D], dev_ask [Gp,D]).

    CPU tensors go to `fused_wave_plain`; CUDA tensors launch the kernel;
    anything else raises."""
    kw = dict(mode=mode, feas=feas, blocked=blocked, aff=aff, pen=pen,
              jitter=jitter, coll=coll, used=used, avail=avail,
              reserved=reserved, ask_res=ask_res, ask_desired=ask_desired,
              dev=dev, spread=spread, seed=seed, TK=TK,
              n_extract=n_extract, tables_v=tables_v)
    if feas.device.type == "cpu":
        return fused_wave_plain(**kw)
    if feas.device.type != "cuda":
        raise ValueError(f"fused_wave: unsupported device {feas.device}")
    return _launch(**kw)


#: wrapper calls that launched, in all and per mode, and launches of the
#: topk merge kernel (one with every topk call; CPU calls are not counted)
fused_wave.launches = 0
fused_wave.mode_launches = {"score": 0, "topk": 0, "merge": 0}


def _launch(*, mode, feas, blocked, aff, pen, jitter, coll, used, avail,
            reserved, ask_res, ask_desired, dev, spread, seed, TK,
            n_extract, tables_v):
    if mode not in ("score", "topk"):
        raise ValueError(f"fused_wave: unknown mode {mode!r}")
    device = feas.device
    f32, i32 = torch.float32, torch.int32
    Gp, Np, R = feas.shape[0], used.shape[0], used.shape[1]
    W32 = -(-Np // 32)
    for name, t in (("feas", feas), ("pen", pen)):
        _check(name, t, i32, (Gp, W32), device)
    if blocked is not None:
        _check("blocked", blocked, i32, (Gp, W32), device)
    for name, t in (("aff", aff), ("jitter", jitter), ("coll", coll)):
        _check(name, t, f32, (Gp, Np), device)
    for name, t in (("used", used), ("avail", avail),
                    ("reserved", reserved)):
        _check(name, t, f32, (Np, R), device)
    _check("ask_res", ask_res, f32, (Gp, R), device)
    _check("ask_desired", ask_desired, f32, (Gp,), device)
    if not 2 <= R <= 8:
        raise ValueError(f"fused_wave: R={R} outside the kernel's 2..8")
    D = 0
    dev_ptrs = [None, None, None]
    if dev is not None:
        D = dev[1].shape[1]
        _check("dev_used", dev[0], f32, (Np, D), device)
        _check("dev_cap", dev[1], f32, (Np, D), device)
        _check("dev_ask", dev[2], f32, (Gp, D), device)
        dev_ptrs = list(dev)
    S = V = 0
    sp_ptrs = [None] * 9
    if spread is not None:
        (sp_vnode, sp_des, sp_used, sp_weight, sp_targeted, sp_has, minc,
         maxc, anyp) = spread
        S, V = sp_vnode.shape[0], sp_used.shape[2]
        _check("sp_vnode", sp_vnode, torch.int16, (S, Gp, Np), device)
        _check("sp_des", sp_des, f32, (S, Gp, Np), device)
        _check("sp_used", sp_used, f32, (Gp, S, V), device)
        if sp_targeted.dtype == torch.bool:
            # the same bytes, no copy: the launch reads the caller's tensor
            sp_targeted = sp_targeted.view(torch.int8)
        for name, t, dt in (("sp_weight", sp_weight, f32),
                            ("sp_targeted", sp_targeted, torch.int8),
                            ("sp_has", sp_has, torch.int8),
                            ("minc", minc, f32), ("maxc", maxc, f32),
                            ("anyp", anyp, torch.int8)):
            _check(name, t, dt, (Gp, S), device)
        sp_ptrs = [sp_vnode, sp_des, sp_used, sp_weight, sp_targeted,
                   sp_has, minc, maxc, anyp]
    want_tables = mode == "topk" and tables_v > 0
    if want_tables and S == 0:
        raise ValueError("fused_wave: tables_v needs the spread planes")
    if want_tables and tables_v > _V_MAX:
        raise ValueError(f"fused_wave: tables_v={tables_v} above "
                         f"{_V_MAX}")

    plan = launch_plan(mode, Gp, Np, NE=n_extract or TK, TK=TK,
                       tables_v=tables_v if want_tables else 0)
    # the launch writes every counter (score mode zeroes them first)
    cnt = torch.empty((Gp, _CNT_HEAD + R), dtype=i32, device=device)
    score = part = vpart = tcnt = top_s = top_i = tab_s = tab_i = None
    T = GB = NE = TKt = Vs = TKv = TKvt = batch = width = merge_smem = 0
    if mode == "score":
        GB = plan["groups_per_block"]
        score = torch.empty((Gp, Np), dtype=f32, device=device)
    else:
        T, NE, TKt = plan["tile"], plan["NE"], plan["TKt"]
        Vs, TKv, TKvt = plan["Vs"], plan["TKv"], plan["TKvt"]
        batch, merge_smem = plan["merge_batch"], plan["merge_smem"]
        width = plan["merge_width"]
        n_tiles = plan["n_tiles"]
        part = torch.empty((Gp, n_tiles, TKt), dtype=torch.int64,
                           device=device)
        tcnt = torch.empty((Gp, n_tiles, _CNT_HEAD + R), dtype=i32,
                           device=device)
        top_s = torch.empty((Gp, NE), dtype=f32, device=device)
        top_i = torch.empty((Gp, NE), dtype=i32, device=device)
        if want_tables:
            vpart = torch.empty((Vs + 1, Gp, n_tiles, TKvt),
                                dtype=torch.int64, device=device)
            tab_s = torch.empty((Gp, Vs + 1, TKv), dtype=f32, device=device)
            tab_i = torch.empty((Gp, Vs + 1, TKv), dtype=i32, device=device)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.nomad_wave_launch(
            0 if mode == "score" else 1,
            ptr(feas), ptr(pen), ptr(blocked), ptr(aff), ptr(jitter),
            ptr(coll), ptr(used), ptr(avail), ptr(reserved), ptr(ask_res),
            ptr(ask_desired), *[ptr(t) for t in dev_ptrs],
            *[ptr(t) for t in sp_ptrs],
            Gp, Np, R, D, S, V, int(seed), ptr(cnt), ptr(score),
            ptr(part), ptr(vpart), ptr(tcnt), ptr(top_s), ptr(top_i),
            ptr(tab_s), ptr(tab_i), T, GB, NE, TKt, Vs, TKv, TKvt, batch,
            width, merge_smem, stream)
    if rc != 0:
        raise RuntimeError(f"fused_wave: kernel launch failed with CUDA "
                           f"error {rc}")
    fused_wave.launches += 1
    fused_wave.mode_launches[mode] += 1
    res = _counters(cnt, R)
    if mode == "score":
        res["score"] = score
        return res
    fused_wave.mode_launches["merge"] += 1
    res["top_score"], res["top_idx"] = top_s, top_i
    if want_tables:
        res["tab_s"], res["tab_i"] = tab_s, tab_i
    return res
