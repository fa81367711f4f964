"""Linear equation solver A x = b with an optional augmented-Hessian shift
(port of iterative_solver_tpu/solvers/linear_equations.py).

Reference: src/molpro/linalg/itsolv/LinearEquationsDavidson.h (the Davidson
machinery of the eigensolver with the right-hand sides projected into the
subspace).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..array import vector_ops as vops
from ..subspace.solvers import SubspaceSolverLinEig
from .core import IterativeSolverTemplate
from .propose_rspace import DSpaceResetter, propose_rspace

Tensor = torch.Tensor


class LinearEquationsDavidson(IterativeSolverTemplate):
    nonlinear = False
    linear_eigensystem = False
    shardable = True

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        hermitian = kwargs.pop("hermitian", True)
        augmented_hessian = kwargs.pop("augmented_hessian", 0.0)
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverLinEig(self.logger)
        self.subspace_solver.augmented_hessian = augmented_hessian
        self.propose_rspace_norm_thresh = 1e-10
        self.propose_rspace_svd_thresh = 1e-12
        self.max_size_qspace = np.iinfo(np.int32).max
        self.dspace_resetter = DSpaceResetter()
        self.set_hermiticity(hermitian)

    def set_hermiticity(self, hermitian: bool) -> None:
        self.hermiticity = hermitian
        self.xspace.hermitian = hermitian
        self.subspace_solver.hermitian = hermitian

    def set_reset_D(self, n: int) -> None:
        self.dspace_resetter.nreset = n

    def set_reset_D_maxQ_size(self, n: int) -> None:
        self.dspace_resetter.max_qsize_after_reset = n

    def set_max_size_qspace(self, n: int) -> None:
        self.max_size_qspace = n
        if self.dspace_resetter.max_qsize_after_reset > n:
            self.dspace_resetter.max_qsize_after_reset = n

    def set_augmented_hessian(self, value: float) -> None:
        self.subspace_solver.augmented_hessian = value

    # ------------------------------------------------------------------
    def add_equations(self, rhs) -> None:
        """Copy RHS vectors into Q-type storage and project them onto the
        subspace (LinearEquationsDavidson.h:73-81 + XSpace::add_rhs_equations)."""
        if isinstance(rhs, torch.Tensor):
            rhs = rhs.detach().cpu().numpy()
        rhs = self._vector(np.atleast_2d(np.asarray(rhs, dtype=np.float64)))
        self.xspace.add_rhs_equations(rhs)
        self.set_n_roots(self.xspace.dimensions.nRHS)

    def rhs(self) -> Tensor:
        return self.xspace.rhs_vectors()

    # ------------------------------------------------------------------
    def end_iteration(self, parameters: Tensor, actions: Tensor):
        with self.profiler.push("end_iteration"):
            if self.dspace_resetter.do_reset(self.stats.iterations, self.xspace.dimensions):
                self.working_set, parameters = self.dspace_resetter.run(
                    parameters,
                    self.xspace,
                    self.subspace_solver.solutions,
                    self.propose_rspace_norm_thresh,
                    self.propose_rspace_svd_thresh,
                    self.logger,
                )
            else:
                self.working_set, parameters = propose_rspace(
                    self,
                    parameters,
                    actions,
                    self.xspace,
                    self.subspace_solver,
                    self.logger,
                    self.propose_rspace_svd_thresh,
                    self.propose_rspace_norm_thresh,
                    self.max_size_qspace,
                )
            self.stats.iterations += 1
            self._end_iteration_needed = False
            return len(self.working_set), parameters, actions

    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        """r = (A x - b) / ||b|| (LinearEquationsDavidson.h:173-184)."""
        rhs_block = self.xspace.rhs_vectors()
        idx = np.asarray(list(roots), dtype=int)
        norms = np.asarray(self.xspace.rhs_norm)[idx]
        scale = np.where(norms != 0, 1.0 / np.where(norms != 0, norms, 1.0), 1.0)
        res = actions - rhs_block[torch.as_tensor(idx, device=rhs_block.device)]
        return vops.scale_rows(vops.to_device(scale, self.dtype, self.device), res)

    def report(self, iteration: Optional[int] = None) -> None:
        super().report(iteration)
        print("errors " + ", ".join(f"{e:e}" for e in self.errors))
