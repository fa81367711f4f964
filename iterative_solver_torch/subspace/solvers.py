"""Subspace-problem solvers (port of iterative_solver_tpu/subspace/solvers.py;
reference: subspace/ISubspaceSolver.h and its implementations).

Each takes the tiny host-side H/S/rhs matrices from the XSpace and produces
a ``solutions`` matrix whose row i holds the subspace coefficients of
solution i, plus eigenvalues and error slots: ``SubspaceSolverLinEig`` and
``SubspaceSolverRSPT`` for the linear families, ``SubspaceSolverDIIS`` for
``NonLinearEquationsDIIS`` and ``SubspaceSolverUnit`` for the optimisers.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ops import dense
from ..utils import Logger
from .xspace import XSpace


class SubspaceSolverLinEig:
    """Generalized eigenproblem or linear equations on the subspace
    (subspace/SubspaceSolverLinEig.h:23-116)."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger or Logger()
        self.solutions = np.zeros((0, 0))
        self.eigenvalues = np.zeros(0)
        self.errors: List[float] = []
        self.hermitian = False
        self.augmented_hessian = 0.0
        self.svd_solver_threshold = 1.0e-14

    def solve(self, xspace: XSpace, nroots_max: int) -> None:
        if xspace.rhs.size:
            self._solve_linear_equations(xspace)
        else:
            self._solve_eigenvalue(xspace, nroots_max)

    def _solve_eigenvalue(self, xspace: XSpace, nroots_max: int) -> None:
        evals, evecs = dense.eigenproblem(
            xspace.h, xspace.s, self.hermitian, self.svd_solver_threshold, condone_complex=True
        )
        nroots = min(nroots_max, evecs.shape[0])
        self.eigenvalues = evals[:nroots].copy()
        self.solutions = evecs[:nroots].copy()
        self.errors = [np.inf] * nroots

    def _solve_linear_equations(self, xspace: XSpace) -> None:
        solutions, eigenvalues = dense.solve_linear_equations(
            xspace.h, xspace.s, xspace.rhs, self.augmented_hessian
        )
        self.solutions = solutions
        self.eigenvalues = eigenvalues
        self.errors = [np.inf] * solutions.shape[0]

    @property
    def size(self) -> int:
        return self.solutions.shape[0]

    def set_error(self, root: int, error: float) -> None:
        self.errors[root] = error

    def set_errors(self, roots, errors) -> None:
        for r, e in zip(roots, errors):
            self.errors[r] = e


class SubspaceSolverRSPT(SubspaceSolverLinEig):
    """Forces the solution onto the newest parameter — Rayleigh-Schrödinger
    perturbation series (subspace/SubspaceSolverRSPT.h:16-25)."""

    def solve(self, xspace: XSpace, nroots_max: int) -> None:
        self._solve_eigenvalue(xspace, nroots_max)
        self.solutions = np.zeros_like(self.solutions)
        if self.solutions.size:
            self.solutions[0, 0] = 1.0


class SubspaceSolverDIIS:
    """DIIS extrapolation over residual overlaps (subspace/SubspaceSolverDIIS.h:27-66)."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger or Logger()
        self.solutions = np.zeros((0, 0))
        self.errors: List[float] = []
        self.converged = False

    def solve(self, xspace: XSpace, nroots_max: int) -> None:
        dim = xspace.h.shape[0]
        self.solutions = np.zeros((1, dim))
        if self.converged:
            self.solutions[0, 0] = 1.0
            return
        coeffs = dense.solve_diis(xspace.h.T)
        self.solutions[0, :] = coeffs
        self.errors = [xspace.h[0, 0]]

    @property
    def eigenvalues(self):
        raise RuntimeError("eigenvalues() not available in non-linear method")

    @property
    def size(self) -> int:
        return self.solutions.shape[0]

    def set_error(self, root: int, error: float) -> None:
        while len(self.errors) <= root:
            self.errors.append(np.inf)
        self.errors[root] = error

    def set_errors(self, roots, errors) -> None:
        for r, e in zip(roots, errors):
            self.set_error(r, e)


class SubspaceSolverUnit:
    """Trivial unit solution on the newest parameter — used by steepest descent
    and BFGS whose step logic lives in the outer solver
    (subspace/SubspaceSolverOptSD.h, SubspaceSolverOptBFGS.h:23-45)."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger or Logger()
        self.solutions = np.zeros((0, 0))
        self.errors: List[float] = []

    def solve(self, xspace: XSpace, nroots_max: int) -> None:
        dim = xspace.h.shape[0]
        self.solutions = np.zeros((1, dim))
        if dim:
            self.solutions[0, 0] = 1.0
        self.errors = [xspace.h[0, 0] if dim else np.inf]

    @property
    def eigenvalues(self):
        raise RuntimeError("eigenvalues() not available in non-linear method")

    @property
    def size(self) -> int:
        return self.solutions.shape[0]

    def set_error(self, root: int, error: float) -> None:
        while len(self.errors) <= root:
            self.errors.append(np.inf)
        self.errors[root] = error

    def set_errors(self, roots, errors) -> None:
        for r, e in zip(roots, errors):
            self.set_error(r, e)
