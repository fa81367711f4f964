"""Solvers of the port (the names of iterative_solver_tpu/solvers, and the
batched non-hermitian makers)."""

from .banded import BandedEigensolver
from .chebyshev import (
    estimate_spectral_bounds,
    make_chebyshev_davidson,
    make_chebyshev_expand,
)
from .core import IterativeSolverTemplate, Verbosity
from .fused_cg import FusedBlockCG
from .fused_davidson import FusedDavidson
from .fused_diis import FusedDIIS
from .fused_lbfgs import FusedLBFGS
from .fused_linear import FusedLinearEquations
from .fused_nonsym import (
    FusedNonSymDavidson,
    FusedNonSymLinearEquations,
    finalize_nonsym_batch,
    make_batched_nonsym_lineq_solve,
    make_batched_nonsym_solve,
)
from .fused_ppcg import FusedPPCG
from .interpolate import Interpolate, Point
from .linear_eigensystem import LinearEigensystemDavidson, LinearEigensystemRSPT
from .linear_equations import LinearEquationsDavidson
from .nonlinear_diis import NonLinearEquationsDIIS
from .optimize import OptimizeBFGS, OptimizeSD
from .refine import EigenpairRefiner, RefineResult

__all__ = [
    "IterativeSolverTemplate",
    "Verbosity",
    "Interpolate",
    "Point",
    "LinearEigensystemDavidson",
    "LinearEigensystemRSPT",
    "LinearEquationsDavidson",
    "NonLinearEquationsDIIS",
    "OptimizeBFGS",
    "OptimizeSD",
    "FusedDavidson",
    "FusedLinearEquations",
    "FusedLBFGS",
    "FusedDIIS",
    "FusedBlockCG",
    "FusedNonSymDavidson",
    "FusedNonSymLinearEquations",
    "finalize_nonsym_batch",
    "make_batched_nonsym_solve",
    "make_batched_nonsym_lineq_solve",
    "FusedPPCG",
    "EigenpairRefiner",
    "RefineResult",
    "BandedEigensolver",
    "estimate_spectral_bounds",
    "make_chebyshev_davidson",
    "make_chebyshev_expand",
]
