"""Subspace partition bookkeeping (copy of iterative_solver_tpu/subspace/dimensions.py;

The working subspace X is ordered [P, Q, D]: P-space model vectors first,
then Q-space history (newest first), then the D-space compression of deleted
history.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Dimensions:
    nP: int = 0
    nQ: int = 0
    nD: int = 0
    nRHS: int = 0

    @property
    def oP(self) -> int:
        return 0

    @property
    def oQ(self) -> int:
        return self.nP

    @property
    def oD(self) -> int:
        return self.nP + self.nQ

    @property
    def nX(self) -> int:
        return self.nP + self.nQ + self.nD
