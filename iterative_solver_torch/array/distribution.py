"""1-D contiguous partition bookkeeping (port of
iterative_solver_tpu/array/distribution.py; reference:
array/util/Distribution.h:16-109).

Pure Python, copied rather than imported: importing the JAX package's
module would import JAX. ``spread_remainder`` follows the reference's
make_distribution_spread_remainder (Distribution.h:98-109), so the ranges a
rank owns agree with the C bindings (IterativeSolverCMPI.cpp:90-110).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


class Distribution:
    """Partition of [0, dimension) into contiguous chunks, one per rank."""

    def __init__(self, chunk_borders: List[int]):
        assert chunk_borders == sorted(chunk_borders)
        self.chunk_borders = list(chunk_borders)

    @property
    def size(self) -> int:
        return len(self.chunk_borders) - 1

    @property
    def border(self) -> Tuple[int, int]:
        return self.chunk_borders[0], self.chunk_borders[-1]

    def range(self, rank: int) -> Tuple[int, int]:
        return self.chunk_borders[rank], self.chunk_borders[rank + 1]

    def cover(self, lo: int, hi: Optional[int] = None):
        """Rank(s) owning index lo (or overlapping [lo, hi))."""
        if hi is None:
            i = bisect.bisect_right(self.chunk_borders, lo) - 1
            return min(max(i, 0), self.size - 1)
        first = self.cover(lo)
        last = self.cover(max(lo, hi - 1))
        return first, last

    def compatible(self, other: "Distribution") -> bool:
        return self.chunk_borders == other.chunk_borders


def spread_remainder(dimension: int, n_ranks: int) -> Distribution:
    """Even partition with the remainder spread over the leading ranks
    (Distribution.h:98-109)."""
    base = dimension // n_ranks
    remainder = dimension % n_ranks
    borders = [0]
    for rank in range(n_ranks):
        borders.append(borders[-1] + base + (1 if rank < remainder else 0))
    return Distribution(borders)
