"""Simple bitmap for alloc-name index reuse.

Reference: nomad/structs/bitmap.go, used by scheduler/reconcile_util.go:396.
"""
from __future__ import annotations

from typing import Iterator, List


class Bitmap:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("bitmap must have positive size")
        self.size = size
        self._bits = bytearray((size + 7) // 8)

    def set(self, idx: int) -> None:
        self._bits[idx >> 3] |= 1 << (idx & 7)

    def unset(self, idx: int) -> None:
        self._bits[idx >> 3] &= ~(1 << (idx & 7))

    def check(self, idx: int) -> bool:
        return bool(self._bits[idx >> 3] & (1 << (idx & 7)))

    def clear(self) -> None:
        for i in range(len(self._bits)):
            self._bits[i] = 0

    def indexes_in_range(self, set_value: bool, lo: int, hi: int) -> List[int]:
        return [i for i in range(lo, min(hi + 1, self.size))
                if self.check(i) == set_value]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indexes_in_range(True, 0, self.size - 1))
