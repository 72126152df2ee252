"""The card's published peaks and the byte count of a wave-kernel call.

Frozen from `chip_smoke.py` (`HBM_BYTES_S`, `wave_bytes`, at commit
e7763fa).  Peaks: NVIDIA's H100 SXM data sheet, dense rates,
at the full 700 W power limit.
"""
from __future__ import annotations

#: HBM bytes/s
HBM_BYTES_S = 3.35e12


def wave_bytes(kw: dict, res: dict) -> int:
    """Bytes one fused-wave call must move at least: each distinct input
    tensor read once and each output tensor written once."""
    import torch
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
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
