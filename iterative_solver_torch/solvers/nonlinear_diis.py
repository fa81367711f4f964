"""DIIS solver for nonlinear equations (port of
iterative_solver_tpu/solvers/nonlinear_diis.py).

Reference: src/molpro/linalg/itsolv/NonLinearEquationsDIIS.h:27-183. The
XSpace runs in action-dot-action mode, so H is the residual-overlap matrix;
the least important history vector is dropped by the smallest eigenvalue of H
before each update.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import psum
from ..subspace.solvers import SubspaceSolverDIIS
from .core import IterativeSolverTemplate, _rows
from .optimize import _with_row

Tensor = torch.Tensor


class NonLinearEquationsDIIS(IterativeSolverTemplate):
    nonlinear = True
    linear_eigensystem = False

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverDIIS(self.logger)
        self.xspace.hermitian = True
        self.xspace.action_dot_action = True
        self.norm_thresh = 1e-10
        self.svd_thresh = 1e-12
        self.max_size_qspace = np.iinfo(np.int32).max

    # ------------------------------------------------------------------
    def _least_important_vector(self, h: np.ndarray) -> Tuple[int, float]:
        """Index (by largest component) and relative eigenvalue of the smallest
        eigenmode of the residual-overlap matrix (NonLinearEquationsDIIS.h:52-80)."""
        if h.shape[0] < 2:
            return 0, np.finfo(np.float64).max
        evals, evecs = np.linalg.eigh(h)
        evmax = float(evals.max())
        imin = int(np.argmin(evals))
        vec = evecs[:, imin]
        index = 1 + int(np.argmax(np.abs(vec[1:])))
        rel = float(evals[imin]) / evmax
        if rel > self.svd_thresh:
            return h.shape[0] - 1, np.finfo(np.float64).max
        return index, rel

    # ------------------------------------------------------------------
    def add_vector(self, parameters: Tensor, actions: Tensor, value: Optional[float] = None):
        parameters = _rows(parameters)
        actions = _rows(actions)
        error = float(torch.sqrt(torch.abs(psum(torch.dot(actions[0], actions[0]),
                                                  self.sharding))))
        self.subspace_solver.converged = error < self.convergence_threshold

        while True:
            index, rel = self._least_important_vector(self.xspace.h)
            if self.xspace.size >= self.max_size_qspace or rel < self.svd_thresh:
                self.xspace.eraseq(index)
            else:
                break

        nwork, parameters, actions = super().add_vector(parameters, actions)
        self.errors[0] = error
        return nwork, parameters, actions

    def end_iteration(self, parameters: Tensor, actions: Tensor):
        """x <- x_interp - precond(r_interp) (NonLinearEquationsDIIS.h:103-119)."""
        sol = self.solution_params(self.working_set or [0])
        parameters = _with_row(parameters, sol[0])
        self._end_iteration_needed = False
        if self.errors[0] < self.convergence_threshold:
            self.working_set = []
            return 0, parameters, actions
        self.working_set = [0]
        parameters = _with_row(parameters, parameters[0] + (-actions[0]))
        self.stats.iterations += 1
        return 1, parameters, actions

    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        # nonlinear: actions already contains the residual
        return actions
