"""ctypes binding of the native host solve engine.

Builds `native/host_solve.cc` with g++ at first use into
`nomad_tpu_torch/_build/` (no external dependencies; the library's name
is keyed on the source's content hash and the flags) and exposes
`native_solve_kernel`, a drop-in for `host.host_solve_kernel` returning
the same SolveResult, and the prepared-call pair `PreparedTemplate` /
`PreparedRun` that `host.HostResidentSolver` streams through.  The
engine exists because an interactive eval's wave arithmetic costs tens
of microseconds in C++ against about a millisecond of ufunc overhead in
numpy.

A failed build raises with the compiler's message: the caller asked for
this engine, so nothing answers in its place.  The flags are the
reference's plus `-ffp-contract=off`, so that no host (aarch64 g++
contracts by default) fuses a multiply-add the numpy twin rounds twice
(the CUDA build's `-fmad=false`, for the same reason).

tests/test_torch_native_solver.py holds it equal to the numpy twin and
to the reference's engine across every feature: constraints,
affinities, targeted / even spreads, distinct_hosts, devices,
penalties, collocation counts, seeds, stack_commit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .kernel import (MAX_WAVES, MERGED_GP_MAX, TOP_K, _MERGED_W_CAP,
                     _WIDE_W_CAP, SolveResult)

_SRC = Path(__file__).resolve().parent / "native" / "host_solve.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: nomad_host_solve's parameters: 31 input/state pointers, n_place, 17
#: shape and mode ints, 10 output pointers, static_ready and the 5
#: static-program cache pointers
_ARGTYPES = [_P] * 31 + [_I] + [_I] * 17 + [_P] * 10 + [_I] + [_P] * 5
_SEED_IX = 43
_STATIC_READY_IX = 59

_lock = threading.Lock()
_libs: dict = {}


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"host_solve_{digest[:16]}.so"


def build() -> Path:
    """Compile host_solve.cc into the build directory (a no-op when the
    library for this source and these flags exists).  Raises on a
    compiler error with its message.  The library is written to a
    temporary name and moved into place, so concurrent builds (test
    workers) never load a partial file."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _get_lib() -> ctypes.CDLL:
    """The loaded engine for the current source, built on first use."""
    with _lock:
        path = build()
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.nomad_host_solve.argtypes = _ARGTYPES
            lib.nomad_host_solve.restype = ctypes.c_int
            _libs[path] = lib
        return lib


def _check_r(R: int) -> None:
    if R > 8:
        raise ValueError(f"the native engine caps R at 8, got {R}")


class PreparedTemplate:
    """Node-side arrays marshaled once per solver (the template is
    fixed for the solver's lifetime), plus the carried usage buffers
    the engine updates in place.  Builds the engine (or raises)."""

    def __init__(self, template):
        _get_lib()
        f32, i32, u8 = np.float32, np.int32, np.uint8
        t = template
        self.avail = np.ascontiguousarray(t.avail, f32)
        self.reserved = np.ascontiguousarray(t.reserved, f32)
        self.valid = np.ascontiguousarray(t.valid, u8)
        self.node_dc = np.ascontiguousarray(t.node_dc, i32)
        self.attr_rank = np.ascontiguousarray(t.attr_rank, i32)
        self.dev_cap = np.ascontiguousarray(t.dev_cap, f32)
        self.Np, self.R = self.avail.shape
        _check_r(self.R)
        self.A = self.attr_rank.shape[1]
        self.D = self.dev_cap.shape[1]
        # carried usage: the native stream path mutates these in place
        self.used = np.ascontiguousarray(t.used0, f32).copy()
        self.dev_used = np.ascontiguousarray(t.dev_used0, f32).copy()

    def reset_usage(self, used0, dev_used0):
        np.copyto(self.used, np.asarray(used0, np.float32))
        np.copyto(self.dev_used, np.asarray(dev_used0, np.float32))


class PreparedRun:
    """One PackedBatch's fully marshaled native call.  Build once, run
    many times (the seed varies per run); the carried usage lives in the
    PreparedTemplate's buffers and updates in place."""

    def __init__(self, tp: PreparedTemplate, pb, has_spread: bool,
                 hint: int, max_waves: int, stack_commit: bool):
        f32, i32, u8 = np.float32, np.int32, np.uint8
        self.tp = tp
        Gp = pb.ask_res.shape[0]
        C = pb.c_op.shape[1]
        CA = pb.a_op.shape[1]
        S = pb.sp_col.shape[1]
        V = pb.sp_desired.shape[2]
        K = pb.p_ask.shape[0]
        NDC = pb.dc_ok.shape[1]
        R, D, Np, A = tp.R, tp.D, tp.Np, tp.A
        w_cap = _MERGED_W_CAP if Gp <= MERGED_GP_MAX else _WIDE_W_CAP

        self.sp_used0 = np.ascontiguousarray(pb.sp_used0, f32)
        self.sp_used = self.sp_used0.copy()
        self.out_idx = np.zeros((K, TOP_K), i32)
        self.out_ok = np.zeros((K, TOP_K), u8)
        self.out_score = np.zeros((K, TOP_K), f32)
        self.out_nfeas = np.zeros(K, i32)
        self.out_nexh = np.zeros(K, i32)
        self.out_dimexh = np.zeros((K, R), i32)
        self.out_unfin = np.zeros(K, u8)
        self.out_waves = np.zeros(1, i32)

        # every buffer the engine reads or writes stays referenced here
        self._keep = []

        def P(a, dtype):
            a = np.ascontiguousarray(a, dtype)
            self._keep.append(a)
            return ctypes.c_void_p(a.ctypes.data)

        args = [
            P(tp.avail, f32), P(tp.reserved, f32),
            P(tp.used, f32), P(tp.valid, u8), P(tp.node_dc, i32),
            P(tp.attr_rank, i32),
            P(pb.ask_res, f32), P(pb.ask_desired, f32),
            P(pb.distinct, i32), P(pb.dc_ok, u8), P(pb.host_ok, u8),
            P(pb.coll0, f32), P(pb.penalty, u8),
            P(pb.c_op, i32), P(pb.c_col, i32), P(pb.c_rank, i32),
            P(pb.a_op, i32), P(pb.a_col, i32), P(pb.a_rank, i32),
            P(pb.a_weight, f32), P(pb.a_host, f32),
            P(pb.sp_col, i32), P(pb.sp_weight, f32),
            P(pb.sp_targeted, u8), P(pb.sp_desired, f32),
            P(pb.sp_implicit, f32), P(self.sp_used, f32),
            P(tp.dev_cap, f32), P(tp.dev_used, f32),
            P(pb.dev_ask, f32), P(pb.p_ask, i32),
            ctypes.c_int(int(pb.n_place)),
            ctypes.c_int(Np), ctypes.c_int(Gp), ctypes.c_int(A),
            ctypes.c_int(C), ctypes.c_int(CA), ctypes.c_int(S),
            ctypes.c_int(V), ctypes.c_int(R), ctypes.c_int(D),
            ctypes.c_int(K), ctypes.c_int(NDC),
            ctypes.c_int(0),                      # seed slot
            ctypes.c_int(1 if has_spread else 0),
            ctypes.c_int(int(hint)),
            ctypes.c_int(int(max_waves or MAX_WAVES)),
            ctypes.c_int(1 if stack_commit else 0),
            ctypes.c_int(w_cap),
            P(self.out_idx, i32), P(self.out_ok, u8),
            P(self.out_score, f32), P(self.out_nfeas, i32),
            P(self.out_nexh, i32), P(self.out_dimexh, i32),
            P(self.out_unfin, u8), P(self.out_waves, i32),
            ctypes.c_void_p(0), ctypes.c_void_p(0),
            # static-program cache: filled on the first run, read-only
            # after (the ask programs and the template are fixed)
            ctypes.c_int(0),
            P(np.zeros((Gp, Np), u8), u8),            # feas
            P(np.zeros((Gp, Np), f32), f32),          # aff
            P(np.zeros((Gp, C), i32), i32),           # consf
            P(np.zeros((S, Gp, Np), i32), i32),       # sp_vnode
            P(np.zeros((S, Gp, Np), f32), f32),       # sp_des
        ]
        self._args = args
        self._lib = _get_lib()

    def run(self, seed: int) -> None:
        """Execute; results land in the out_* buffers (overwritten per
        run) and the carried usage updates in place."""
        np.copyto(self.sp_used, self.sp_used0)
        self._args[_SEED_IX] = ctypes.c_int(int(seed))
        rc = self._lib.nomad_host_solve(*self._args)
        if rc != 0:
            raise RuntimeError(f"nomad_host_solve returned {rc}")
        self._args[_STATIC_READY_IX] = ctypes.c_int(1)


def native_solve_kernel(avail, reserved, used0, valid, node_dc, attr_rank,
                        ask_res, ask_desired, distinct, dc_ok, host_ok,
                        coll0, penalty,
                        c_op, c_col, c_rank, a_op, a_col, a_rank, a_weight,
                        a_host, sp_col, sp_weight, sp_targeted, sp_desired,
                        sp_implicit, sp_used0, dev_cap, dev_used0, dev_ask,
                        p_ask, n_place, seed=0, *, has_spread=True,
                        group_count_hint=0, max_waves=0,
                        stack_commit=False) -> SolveResult:
    """`host.host_solve_kernel`'s solve (without its eviction pass and
    optional planes, which the engine does not implement) in one native
    call over numpy arrays; the static program is recomputed per call."""
    lib = _get_lib()
    f32, i32, u8 = np.float32, np.int32, np.uint8

    def c(a, dtype):
        return np.ascontiguousarray(a, dtype)

    ins = [c(avail, f32), c(reserved, f32),
           np.array(used0, f32),                    # in/out copy
           c(valid, u8), c(node_dc, i32), c(attr_rank, i32),
           c(ask_res, f32), c(ask_desired, f32), c(distinct, i32),
           c(dc_ok, u8), c(host_ok, u8), c(coll0, f32), c(penalty, u8),
           c(c_op, i32), c(c_col, i32), c(c_rank, i32),
           c(a_op, i32), c(a_col, i32), c(a_rank, i32),
           c(a_weight, f32), c(a_host, f32),
           c(sp_col, i32), c(sp_weight, f32), c(sp_targeted, u8),
           c(sp_desired, f32), c(sp_implicit, f32),
           np.array(sp_used0, f32),                 # in/out copy
           c(dev_cap, f32),
           np.array(dev_used0, f32),                # in/out copy
           c(dev_ask, f32), c(p_ask, i32)]
    used, dev_used = ins[2], ins[28]
    Np, R = ins[0].shape
    _check_r(R)
    Gp = ins[6].shape[0]
    A = ins[5].shape[1]
    C = ins[13].shape[1]
    CA = ins[16].shape[1]
    S = ins[21].shape[1]
    V = ins[24].shape[2]
    D = ins[27].shape[1]
    K = ins[30].shape[0]
    NDC = ins[9].shape[1]
    w_cap = _MERGED_W_CAP if Gp <= MERGED_GP_MAX else _WIDE_W_CAP

    out_idx = np.zeros((K, TOP_K), i32)
    out_ok = np.zeros((K, TOP_K), u8)
    out_score = np.zeros((K, TOP_K), f32)
    out_nfeas = np.zeros(K, i32)
    out_nexh = np.zeros(K, i32)
    out_dimexh = np.zeros((K, R), i32)
    out_unfin = np.zeros(K, u8)
    out_waves = np.zeros(1, i32)
    out_feas = np.zeros((Gp, Np), u8)
    out_consf = np.zeros((Gp, C), i32)
    outs = [out_idx, out_ok, out_score, out_nfeas, out_nexh, out_dimexh,
            out_unfin, out_waves, out_feas, out_consf]

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.nomad_host_solve(
        *[vp(a) for a in ins], int(n_place),
        Np, Gp, A, C, CA, S, V, R, D, K, NDC, int(seed),
        1 if has_spread else 0, int(group_count_hint),
        int(max_waves or MAX_WAVES), 1 if stack_commit else 0, w_cap,
        *[vp(a) for a in outs],
        0, None, None, None, None, None)
    if rc != 0:
        raise RuntimeError(f"nomad_host_solve returned {rc}")
    return SolveResult(
        choice=out_idx, choice_ok=out_ok.astype(bool),
        score=out_score, n_feasible=out_nfeas, n_exhausted=out_nexh,
        dim_exhausted=out_dimexh, feas=out_feas.astype(bool),
        cons_filtered=out_consf, used_final=used,
        dev_used_final=dev_used, n_waves=int(out_waves[0]),
        unfinished=out_unfin.astype(bool), n_rescore=int(out_waves[0]))
