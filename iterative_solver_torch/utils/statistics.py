"""Operation statistics mirroring the reference's itsolv::Statistics (Statistics.h:10-37);

Counts both solver-level events (iterations, vector creations, line searches)
and handler-level device operations (copies, dots, gemms, axpys) gathered from
the vector-ops layer's counters.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Statistics:
    iterations: int = 0
    r_creations: int = 0
    q_creations: int = 0
    q_deletions: int = 0
    d_creations: int = 0
    best_r_creations: int = 0
    current_r_creations: int = 0
    line_searches: int = 0
    line_search_steps: int = 0
    # handler-level op counters (device-op parity with ArrayHandler counters)
    copies: int = 0
    scals: int = 0
    fills: int = 0
    axpys: int = 0
    dots: int = 0
    gemm_inner_ops: int = 0
    gemm_outer_ops: int = 0

    def __str__(self) -> str:
        parts = []
        if self.iterations:
            parts.append(f"iterations = {self.iterations}")
        if self.r_creations:
            parts.append(f"R vectors created = {self.r_creations}")
        if self.q_creations:
            parts.append(f"Q vectors created = {self.q_creations}")
        if self.q_deletions:
            parts.append(f"Q vectors deleted = {self.q_deletions}")
        if self.d_creations:
            parts.append(f"D vectors created = {self.d_creations}")
        if self.line_searches:
            parts.append(f"line searches = {self.line_searches}")
        if self.line_search_steps:
            parts.append(f"line search steps = {self.line_search_steps}")
        ops = []
        for name in ("copies", "scals", "fills", "axpys", "dots", "gemm_inner_ops", "gemm_outer_ops"):
            v = getattr(self, name)
            if v:
                ops.append(f"{name} = {v}")
        return ", ".join(parts + ops)
