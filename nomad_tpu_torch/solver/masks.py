"""Bitpacked boolean planes for the fused wave kernel.

The counterpart of `nomad_tpu.solver.masks` (`pack_bool_u32` /
`unpack_bool_u32`): 32 node columns fold into one 32-bit word, bit j of
word w being node column ``w * 32 + j``, so the static feasibility,
penalty and distinct-blocking planes cost 1/8th of their bool bytes on
every full wave's re-read.

Torch on the CPU has no uint32 shift or sum, so the words are built on
an int64 carrier and stored as int32 whose bit pattern equals the
reference's uint32 words (`words.numpy().view(np.uint32)` gives them
back).
"""
from __future__ import annotations

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
