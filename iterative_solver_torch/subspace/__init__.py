"""The P/Q/D subspace of the parity solvers (port of iterative_solver_tpu/subspace)."""

from .dimensions import Dimensions
from .solvers import (
    SubspaceSolverDIIS,
    SubspaceSolverLinEig,
    SubspaceSolverRSPT,
    SubspaceSolverUnit,
)
from .xspace import XSpace

__all__ = [
    "Dimensions",
    "XSpace",
    "SubspaceSolverLinEig",
    "SubspaceSolverRSPT",
    "SubspaceSolverDIIS",
    "SubspaceSolverUnit",
]
