"""The wave body's node-segmented reductions: the same-wave conflict
check and the commits over one stable sort, on hand-written CUDA kernels.

Above 2,048 placements a wave the wave body (`kernel._wave_body`) no
longer builds [K, K] masks: it sorts the wave's candidates by node once
(`sort_segments`, rows outside the check pushed to the end) and reuses
that order for

  `prior_sum`  each row's sum of a [K, R] value over the earlier rows
               on its node (the resources a same-wave placement ahead of
               it has already asked of the node);
  `seg_add`    the wave's commits: each node's sum of its committed
               rows' asks added to its usage row once.

`seg_rank` is the exclusive rank of a row among the earlier rows of its
segment, for keys with a sort of their own (distinct hosts, a spread
value class, an eviction's node).  `hist_add` counts commits into a
small target ([Gp, S, V] spread counts, [Gp, C] collocation counts).

On CUDA tensors each call launches a kernel of `csrc/seg_kernel.cu`
(built into `wave_kernel`'s library) on torch's current stream: no host
sync and no shape that depends on the data, so a captured wave body
(`wave_graph`) records them.  On the CPU the same one-sort algorithm
runs in torch ops (`*_plain`, on any device), the plain twin the CPU
tests hold against the [K, K] mask path and the reference.  Sums run in
double and round once to float, in both versions: the values are
integers, so each sum is exact and the two give the same bits (and those
of a sequential float sum wherever that one is exact).
`LAUNCHES` counts the kernels' launches (`scan`, of which `commit` in
commit mode, and `hist`): the calls that launched and, for a call
recorded in a CUDA graph (`wave_graph`), each replay of the graph.  CPU
calls count nothing.
"""
from __future__ import annotations

import collections
import threading
from typing import NamedTuple, Optional

import torch

from . import wave_kernel as _wk

#: targets up to this many cells count in shared memory (48 KB of int)
HIST_SMEM_CELLS = 12_288
#: the sort keys are int32: a member's key stays below this
KEY_LIMIT = 0x7FFFFFFF

#: the kernels' launches by kind, in every thread
LAUNCHES: collections.Counter = collections.Counter()
_tls = threading.local()


def _tally(which: str) -> collections.Counter:
    """This thread's launches ("real") or calls recorded in a graph
    capture ("captured"), by kind."""
    t = getattr(_tls, which, None)
    if t is None:
        t = collections.Counter()
        setattr(_tls, which, t)
    return t


def _launched(*kinds: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        _tally("captured").update(kinds)
    else:
        _tally("real").update(kinds)
        LAUNCHES.update(kinds)


def captured() -> collections.Counter:
    """A copy of this thread's tally of kernel calls recorded in graph
    captures, by kind: what a graph launches at each replay is the
    difference across its capture."""
    return collections.Counter(_tally("captured"))


def replayed(launches: collections.Counter) -> None:
    """Count the launches of one replay of a graph (`captured()`'s
    difference across its capture)."""
    _tally("real").update(launches)
    LAUNCHES.update(launches)


def thread_launches(kind: str) -> int:
    """This thread's launches of `kind` so far, replays included."""
    return _tally("real")[kind]


class Segments(NamedTuple):
    """A stable sort of rows by key: `key` [K] i32 the sorted keys
    (KEY_LIMIT for rows outside every segment, which sort last), `ix`
    [K] i64 the row at each sorted position."""
    key: torch.Tensor
    ix: torch.Tensor


def sort_segments(key: torch.Tensor, member: torch.Tensor) -> Segments:
    """The `member` rows of `key` [K] sorted stably by key, the others
    after them.  The sort runs on int32 keys: the caller keeps the
    members' keys in [0, KEY_LIMIT)."""
    s_key, s_ix = torch.sort(
        torch.where(member, key.to(torch.int32), KEY_LIMIT), stable=True)
    return Segments(s_key, s_ix)


def prior_sum(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """[K, R] f32: each member row's sum of `vals` [K, R] over the
    earlier member rows of its segment; 0 on the other rows."""
    if vals.device.type == "cpu":
        return prior_sum_plain(seg, vals)
    out = torch.empty(vals.shape, dtype=torch.float32, device=vals.device)
    launch_scan(seg, vals.contiguous(), None, out, None, None)
    return out


def seg_rank(seg: Segments) -> torch.Tensor:
    """[K] i64: each member row's count of the earlier member rows of
    its segment; 0 on the other rows."""
    if seg.key.device.type == "cpu":
        return seg_rank_plain(seg)
    out = torch.empty(seg.key.shape, dtype=torch.int64,
                      device=seg.key.device)
    launch_scan(seg, None, None, None, out, None)
    return out


def seg_add(seg: Segments, target: torch.Tensor,
            vals: Optional[torch.Tensor],
            weight: torch.Tensor) -> torch.Tensor:
    """A copy of `target` ([N, R] f32, or [N]) with each segment's sum
    of `vals` [K, R] (None: ones) over its member rows where `weight`
    [K] bool added to the target row of the segment's key.  The keys
    must be rows of `target`."""
    if target.device.type == "cpu":
        return seg_add_plain(seg, target, vals, weight)
    out = target.clone(memory_format=torch.contiguous_format)
    _check("target", out, torch.float32)
    _check("weight", weight, torch.bool)
    launch_scan(seg, None if vals is None else vals.contiguous(),
                 weight.contiguous(), None, None,
                 out if out.dim() == 2 else out[:, None])
    return out


def hist_add(target: torch.Tensor, idx: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """A copy of `target` (f32, any shape, read flat) with 1 added at
    flat cell idx[i] for each i where weight[i]; indices outside the
    target are dropped.  `idx` (i64) and `weight` (bool) have one
    shape."""
    if target.device.type == "cpu":
        return hist_add_plain(target, idx, weight)
    n = target.numel()
    flat_i, flat_w = idx.reshape(-1).contiguous(), weight.reshape(-1)
    _check("target", target, torch.float32)
    _check("idx", flat_i, torch.int64)
    _check("weight", flat_w, torch.bool)
    out = target.clone(memory_format=torch.contiguous_format)
    if flat_i.numel():
        lib = _wk._load()
        rc = lib.nomad_seg_hist(
            flat_i.data_ptr(), flat_w.contiguous().data_ptr(),
            flat_i.numel(), n, HIST_SMEM_CELLS, out.data_ptr(),
            torch.cuda.current_stream(target.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"seg_hist: kernel launch failed with "
                               f"CUDA error {rc}")
        _launched("hist")
    return out


# ------------------------------------------------------ plain version
def _scan_plain(seg: Segments, vals, weight, R: int = 1):
    """The scan in torch ops: (member [K] bool, exclusive [K, R] and
    inclusive [K, R] f64 segment sums), all in sorted order."""
    K, device = seg.key.shape[0], seg.key.device
    member = seg.key != KEY_LIMIT
    if vals is None:
        v = torch.ones((K, R), dtype=torch.float64, device=device)
    else:
        v = vals[seg.ix].double()
    if weight is not None:
        v = v * weight[seg.ix][:, None]
    v = v * member[:, None]
    cum = torch.cumsum(v, dim=0)
    head = torch.ones(K, dtype=torch.bool, device=device)
    head[1:] = seg.key[1:] != seg.key[:-1]
    pos = torch.arange(K, device=device)
    hpos = torch.cummax(torch.where(head, pos, 0), dim=0).values
    base = (cum - v)[hpos]
    return member, cum - v - base, cum - base


def prior_sum_plain(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """`prior_sum` in torch ops."""
    _, excl, _ = _scan_plain(seg, vals, None)
    return torch.zeros(vals.shape, dtype=torch.float32,
                       device=vals.device).index_put_(
        (seg.ix,), excl.to(torch.float32))


def seg_rank_plain(seg: Segments) -> torch.Tensor:
    """`seg_rank` in torch ops."""
    _, excl, _ = _scan_plain(seg, None, None)
    return torch.zeros(seg.key.shape, dtype=torch.int64,
                       device=seg.key.device).index_put_(
        (seg.ix,), excl[:, 0].to(torch.int64))


def seg_add_plain(seg: Segments, target: torch.Tensor,
                  vals: Optional[torch.Tensor],
                  weight: torch.Tensor) -> torch.Tensor:
    """`seg_add` in torch ops: each segment's last row writes its key's
    target row."""
    t2 = target if target.dim() == 2 else target[:, None]
    member, _, incl = _scan_plain(seg, vals, weight, t2.shape[1])
    tail = member.clone()
    tail[:-1] &= seg.key[1:] != seg.key[:-1]
    rows = seg.key[tail].to(torch.int64)
    out = t2.clone(memory_format=torch.contiguous_format)
    out[rows] = (t2[rows].double() + incl[tail]).to(torch.float32)
    return out.view(target.shape)


def hist_add_plain(target: torch.Tensor, idx: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """`hist_add` in torch ops."""
    n = target.numel()
    flat_i, flat_w = idx.reshape(-1), weight.reshape(-1)
    keep = flat_w & (flat_i >= 0) & (flat_i < n)
    cnt = torch.zeros(n + 1, dtype=torch.float64,
                      device=target.device).index_add_(
        0, torch.where(keep, flat_i, n), keep.to(torch.float64))[:n]
    flat = target.reshape(-1)
    return torch.where(cnt != 0, (flat.double() + cnt).to(torch.float32),
                       flat).view(target.shape)


# ------------------------------------------------------------ kernel
def _check(name: str, t: torch.Tensor, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"seg_kernel: {name} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise TypeError(f"seg_kernel: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")


def launch_scan(seg: Segments, vals, weight, out, rank, target) -> None:
    """One scan launch: prior sums into `out`, ranks into `rank`, or a
    commit reduce into `target` (contiguous, as `vals` has columns)."""
    K = seg.key.shape[0]
    if K == 0:
        return
    _check("key", seg.key, torch.int32)
    _check("ix", seg.ix, torch.int64)
    if vals is not None:
        _check("vals", vals, torch.float32)
    nc = (vals.shape[1] if vals is not None
          else target.shape[1] if target is not None else 0)
    lib = _wk._load()
    rc = lib.nomad_seg_scan(
        seg.key.data_ptr(), seg.ix.data_ptr(), K, None if vals is None else vals.data_ptr(), nc,
        None if weight is None else weight.data_ptr(),
        None if out is None else out.data_ptr(),
        None if rank is None else rank.data_ptr(),
        None if target is None else target.data_ptr(),
        torch.cuda.current_stream(seg.key.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seg_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    if target is None:
        _launched("scan")
    else:
        _launched("scan", "commit")
