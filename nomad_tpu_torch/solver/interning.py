"""String interning for tensorization.

The key trick (SURVEY §7.3): Go's constraint comparisons <,<=,>,>= are
*lexical* string comparisons (reference: scheduler/feasible.go
checkLexicalOrder). We intern each attribute column's observed values —
node values plus constraint operands — with ORDER-PRESERVING ranks, so a
lexical comparison becomes an integer comparison on device, exactly.
"""
from __future__ import annotations

from typing import Dict, Iterable, List


class Interner:
    """Plain string -> dense int id (no ordering guarantees)."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._strs: List[str] = []

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
        return i

    def lookup(self, i: int) -> str:
        return self._strs[i]

    def items(self):
        return self._ids.items()

    def __len__(self) -> int:
        return len(self._strs)


class RankColumn:
    """Order-preserving interning for one attribute column.

    Build with the full value universe (node values + operand literals),
    then `rank(value)` is monotone in lexical order: a < b (strings)
    iff rank(a) < rank(b) (ints).
    """

    MISSING = -1

    def __init__(self, values: Iterable[str]):
        uniq = sorted(set(values))
        self._rank = {v: i for i, v in enumerate(uniq)}
        self._values = uniq

    def rank(self, value: str) -> int:
        return self._rank.get(value, self.MISSING)

    def insertion(self, value: str) -> int:
        """bisect_left of `value` in the universe: every rank < insertion
        sorts strictly before `value`, every rank >= insertion sorts at or
        after it. Lets ordered comparisons against operands OUTSIDE the
        built universe stay exact (used by Tensorizer.repack_asks)."""
        import bisect
        return bisect.bisect_left(self._values, value)

    @property
    def n_values(self) -> int:
        return len(self._values)

    def value(self, rank: int) -> str:
        return self._values[rank]
