"""Bitpacked boolean planes, and the standalone static-feasibility pass.

The counterpart of `nomad_tpu.solver.masks`: 32 node columns fold into
one 32-bit word, bit j of word w being node column ``w * 32 + j``, so the
static feasibility, penalty and distinct-blocking planes cost 1/8th of
their bool bytes on every full wave's re-read (`pack_bool_u32` /
`unpack_bool_u32`, and the numpy twins `np_pack_bool_u32` /
`np_unpack_bool_u32`).

`_feas_kernel` computes only the static [G, N] feasibility mask
(constraints, datacenter, host-evaluated ops) without the placement
waves, for the system scheduler, which forces placements onto specific
nodes; `static_feasibility` fetches its packed words and unpacks them on
the host.  It shares `kernel.static_feas` with the wave solve.

Torch on the CPU has no uint32 shift or sum, so the words are built on
an int64 carrier and stored as int32 whose bit pattern equals the
reference's uint32 words (`words.numpy().view(np.uint32)` gives them
back).
"""
from __future__ import annotations

import numpy as np
import torch

#: node columns folded per packed word
PACK_LANES = 32


def pack_bool_u32(mask: torch.Tensor) -> torch.Tensor:
    """[..., N] bool mask -> [..., ceil(N/32)] int32 words.  Node axes
    below a 32-multiple zero-fill the trailing bits."""
    n = mask.shape[-1]
    if n % PACK_LANES:
        pad = PACK_LANES - n % PACK_LANES
        mask = torch.cat([mask, torch.zeros(mask.shape[:-1] + (pad,),
                                            dtype=mask.dtype,
                                            device=mask.device)], dim=-1)
        n += pad
    bits = mask.to(torch.int64).reshape(
        mask.shape[:-1] + (n // PACK_LANES, PACK_LANES))
    shifts = torch.arange(PACK_LANES, dtype=torch.int64, device=mask.device)
    words = (bits << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_bool_u32(words: torch.Tensor, n: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., n] bool."""
    shifts = torch.arange(PACK_LANES, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1]
                        + (words.shape[-1] * PACK_LANES,))[..., :n] != 0


def np_pack_bool_u32(mask: np.ndarray) -> np.ndarray:
    """Host-side (numpy) twin of pack_bool_u32, as uint32 words."""
    n = mask.shape[-1]
    if n % PACK_LANES:
        pad = PACK_LANES - n % PACK_LANES
        mask = np.concatenate(
            [mask, np.zeros(mask.shape[:-1] + (pad,), mask.dtype)],
            axis=-1)
        n += pad
    bits = np.asarray(mask, bool).reshape(
        mask.shape[:-1] + (n // PACK_LANES, PACK_LANES))
    weights = np.uint32(1) << np.arange(PACK_LANES, dtype=np.uint32)
    return (bits * weights).sum(axis=-1, dtype=np.uint64).astype(np.uint32)


def np_unpack_bool_u32(words: np.ndarray, n: int) -> np.ndarray:
    """Host-side (numpy) twin of unpack_bool_u32 (uint32 words, or the
    int32 words of pack_bool_u32 with the same bits)."""
    words = np.asarray(words).view(np.uint32)
    shifts = np.arange(PACK_LANES, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(words.shape[:-1]
                        + (words.shape[-1] * PACK_LANES,))[..., :n] != 0


def _feas_kernel(valid, node_dc, attr_rank, dc_ok, host_ok, c_op, c_col,
                 c_rank) -> torch.Tensor:
    """[Gp, Np] static feasibility of every (ask, node) pair as packed
    [Gp, ceil(Np/32)] words: the system scheduler fetches the whole
    plane, so it crosses to the host 8x smaller than as bools."""
    from .kernel import static_feas
    feas, _cons = static_feas(valid, node_dc, attr_rank, dc_ok, host_ok,
                              c_op, c_col, c_rank)
    return pack_bool_u32(feas)


def feas_planes(pb, device) -> tuple:
    """The `_feas_kernel` arguments of a PackedBatch, as tensors on
    `device`."""
    from .solve import _to_device
    return _to_device((pb.valid, pb.node_dc, pb.attr_rank, pb.dc_ok,
                       pb.host_ok, pb.c_op, pb.c_col, pb.c_rank), device)


def static_feasibility(pb, device) -> np.ndarray:
    """[Gp, Np] bool feasibility mask of a PackedBatch, computed on
    `device` and fetched as packed words."""
    words = _feas_kernel(*feas_planes(pb, device))
    return np_unpack_bool_u32(words.cpu().numpy(), pb.valid.shape[0])
