"""iterative_solver_torch — the PyTorch/CUDA port of iterative_solver_tpu.

The JAX package beside it stays the reference; this package mirrors its
names and layout so each function's counterpart is easy to find. It never
imports ``jax`` or ``iterative_solver_tpu``. Its hot kernels are hand-written
CUDA C++ for Hopper (``ops/kernels/csrc``), built with ``nvcc`` at first use.

Quick start (on a CUDA card)::

    import numpy as np, iterative_solver_torch as its
    problem = its.models.MatrixProblem(matrix)
    solver = its.create_linear_eigensystem(n, nroots=4, options="max_size_qspace=10")
    converged, x, r = solver.solve(np.zeros((4, n)), problem=problem,
                                   generate_initial_guess=True)
    solver.eigenvalues()

    from iterative_solver_torch import FusedDavidson
    solver = FusedDavidson.from_dense_symmetric(matrix, nroots=4)
    evals, x, errors, iters = solver.run_on_device(guess)

    opt = its.create_optimize(n, "BFGS", "max_size_qspace=6")
    converged, x, g = opt.solve(np.zeros((1, n)),
                                problem=its.models.QuadraticOptimizeProblem(hessian, b))

Pass ``device="cpu"`` (to the problem, the factory and the fused solvers)
to run the plain PyTorch versions on the host. Importing this package needs
no card.
"""

from . import config as config  # noqa: F401  (pins matmul precision; option store)
from . import models, options, utils
from .factory import (
    create_linear_eigensystem,
    create_linear_equations,
    create_nonlinear_equations,
    create_optimize,
)
from .problem import Problem
from .solvers.core import IterativeSolverTemplate, Verbosity
from .solvers.fused_cg import FusedBlockCG
from .solvers.fused_davidson import FusedDavidson, make_batched_davidson_solve
from .solvers.fused_diis import FusedDIIS
from .solvers.fused_lbfgs import FusedLBFGS
from .solvers.fused_linear import FusedLinearEquations
from .solvers.fused_ppcg import FusedPPCG
from .solvers.implicit_diff import make_differentiable_eigenpairs, make_differentiable_eigenvalues
from .solvers.interpolate import Interpolate, Point
from .solvers.linear_eigensystem import LinearEigensystemDavidson, LinearEigensystemRSPT
from .solvers.linear_equations import LinearEquationsDavidson
from .solvers.nonlinear_diis import NonLinearEquationsDIIS
from .solvers.optimize import OptimizeBFGS, OptimizeSD

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "Verbosity",
    "IterativeSolverTemplate",
    "LinearEigensystemDavidson",
    "LinearEigensystemRSPT",
    "LinearEquationsDavidson",
    "NonLinearEquationsDIIS",
    "OptimizeBFGS",
    "OptimizeSD",
    "FusedDavidson",
    "make_batched_davidson_solve",
    "make_differentiable_eigenvalues",
    "make_differentiable_eigenpairs",
    "FusedLinearEquations",
    "FusedLBFGS",
    "FusedDIIS",
    "Interpolate",
    "Point",
    "FusedPPCG",
    "FusedBlockCG",
    "create_linear_eigensystem",
    "create_linear_equations",
    "create_nonlinear_equations",
    "create_optimize",
    "models",
    "options",
    "utils",
]
