"""User-facing problem definition (port of iterative_solver_tpu/problem.py).

The mirror of the reference's Problem interface
(src/molpro/linalg/itsolv/IterativeSolver.h:76-172 and
python/iterative_solver/problem.py):

- linear solvers call ``action`` (the matrix-vector product, the hot user
  kernel; a BSR operator's is ``ops.kernels.spmv.bsr_matmat_kernel``);
- ``diagonals``/``precondition`` drive the Jacobi/Davidson update and the
  automatic P-space / initial-guess selection;
- ``pp_action_matrix``/``p_action`` expose the P-space model hamiltonian.

Vector arguments are ``(m, N)`` row blocks: tensors on the solver's device
in its working dtype. Methods return new tensors rather than mutating their
arguments. The nonlinear solvers (``create_optimize``,
``create_nonlinear_equations``) call ``residual`` instead of ``action``.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .array import vector_ops as vops

Tensor = torch.Tensor


class Problem:
    def __init__(self):
        self.dimension: Optional[int] = None

    # -- linear ---------------------------------------------------------
    def action(self, parameters: Tensor) -> Tensor:
        """Kernel-matrix action on a block of trial vectors: (m, N) -> (m, N)."""
        raise NotImplementedError

    # -- nonlinear ------------------------------------------------------
    def residual(self, parameters: Tensor) -> Tuple[float, Tensor]:
        """Residual vector (and objective value where defined) at ``parameters`` (N,)."""
        raise NotImplementedError

    # -- preconditioning ------------------------------------------------
    def diagonals(self):
        """Diagonal elements of the kernel, or None if unavailable."""
        return None

    def precondition(self, residual: Tensor, shift: Optional[np.ndarray] = None,
                     diagonals=None) -> Tensor:
        """Predict the (negative of the) step from a residual block.

        Default: Jacobi update r_i / (d_i - shift_k + 1e-15), the reference's
        precondition_default (IterativeSolver.h:34-44).
        """
        if diagonals is None:
            diagonals = self.diagonals()
        if diagonals is None:
            raise NotImplementedError("precondition() needs diagonals or an override")
        if shift is None:
            shift = np.zeros(residual.shape[0])
        like = dict(dtype=residual.dtype, device=residual.device)
        return vops.jacobi_precondition_block(
            residual, vops.to_device(np.asarray(shift, dtype=np.float64), **like),
            vops.to_device(diagonals, **like))

    # -- P space --------------------------------------------------------
    def pp_action_matrix(self, pvectors: Sequence[Dict[int, float]]) -> np.ndarray:
        """<p_i | A | p_j> for sparse P-space vectors."""
        return np.zeros((0, 0))

    def p_action(self, p_coefficients: np.ndarray,
                 pvectors: Sequence[Dict[int, float]]) -> Tensor:
        """Action contribution of the P-space projection: (m, nP) coefficients -> (m, N)."""
        raise NotImplementedError("P-space unavailable: unimplemented p_action()")

    # -- testing / reporting --------------------------------------------
    def test_parameters(self, instance: int):
        """Provide trial parameters for self-testing; None ends the scan."""
        return None

    def report(self, iteration, verbosity, errors, value=None, eigenvalues=None) -> bool:
        if (iteration <= 0 and verbosity >= 1) or verbosity >= 2:
            errors = np.asarray(errors, dtype=float)
            if iteration > 0 and verbosity >= 2:
                print("Iteration", iteration, "log10(|residual|)=", np.log10(errors + sys.float_info.min))
            elif iteration == 0:
                print("Converged", "log10(|residual|)=", np.log10(errors + sys.float_info.min))
            else:
                print("Unconverged", "log10(|residual|)=", np.log10(errors + sys.float_info.min))
            if value is not None:
                print("Objective function value", value)
            if eigenvalues is not None:
                print("Eigenvalues", np.asarray(eigenvalues))
            return True
        return False
