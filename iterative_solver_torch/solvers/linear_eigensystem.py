"""Linear eigensystem solvers: Davidson and RSPT (port of
iterative_solver_tpu/solvers/linear_eigensystem.py).

Reference: src/molpro/linalg/itsolv/LinearEigensystemDavidson.h and
LinearEigensystemRSPT.h.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..array import vector_ops as vops
from ..subspace.solvers import SubspaceSolverLinEig, SubspaceSolverRSPT
from .core import IterativeSolverTemplate
from .propose_rspace import DSpaceResetter, propose_rspace

Tensor = torch.Tensor


class LinearEigensystemDavidson(IterativeSolverTemplate):
    """Davidson eigensolver with P/Q/D subspace management
    (LinearEigensystemDavidson.h:28-199)."""

    nonlinear = False
    linear_eigensystem = True
    shardable = True

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        hermitian = kwargs.pop("hermitian", False)
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverLinEig(self.logger)
        self.propose_rspace_norm_thresh = 1e-10
        self.propose_rspace_svd_thresh = 1e-12
        self.max_size_qspace = np.iinfo(np.int32).max
        self.dspace_resetter = DSpaceResetter()
        self.hermiticity = False
        self._last_values: List[float] = []
        self._resetting_in_progress = False
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

    # ------------------------------------------------------------------
    def end_iteration(self, parameters: Tensor, actions: Tensor):
        """Propose new expansion vectors from the preconditioned residuals in
        ``actions`` (LinearEigensystemDavidson.h:63-90)."""
        with self.profiler.push("end_iteration"):
            if self.dspace_resetter.do_reset(self.stats.iterations, self.xspace.dimensions):
                self._resetting_in_progress = True
                self.working_set, parameters = self.dspace_resetter.run(
                    parameters,
                    self.xspace,
                    self.subspace_solver.solutions,
                    self.propose_rspace_norm_thresh,
                    self.propose_rspace_svd_thresh,
                    self.logger,
                )
            else:
                self._resetting_in_progress = False
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
        """r = A x - lambda x (LinearEigensystemDavidson.h:186-192)."""
        eigvals = np.asarray(self.subspace_solver.eigenvalues)[np.asarray(roots, dtype=int)]
        return vops.axpy_rows(vops.to_device(-eigvals, self.dtype, self.device), params, actions)

    def set_value_errors(self) -> None:
        """Eigenvalue-change errors (LinearEigensystemDavidson.h:106-113)."""
        current = list(np.asarray(self.subspace_solver.eigenvalues))
        self.value_errors = [np.finfo(np.float64).max] * len(current)
        for i in range(min(len(self._last_values), len(current))):
            self.value_errors[i] = abs(current[i] - self._last_values[i])
        if not self._resetting_in_progress:
            self._last_values = current

    def report(self, iteration: Optional[int] = None) -> None:
        super().report(iteration)
        print("errors " + ", ".join(f"{e:e}" for e in self.errors))
        print("eigenvalues " + ", ".join(f"{v:.14f}" for v in self.eigenvalues()))


class LinearEigensystemRSPT(IterativeSolverTemplate):
    """Rayleigh-Schrödinger perturbation series (LinearEigensystemRSPT.h:33-194)."""

    nonlinear = False
    linear_eigensystem = True

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverRSPT(self.logger)
        self.xspace.hermitian = True
        self.subspace_solver.hermitian = True
        self.set_n_roots(1)
        self.rspt_values: List[float] = []
        self.propose_rspace_norm_thresh = 1e-10
        self.propose_rspace_svd_thresh = 1e-12

    def end_iteration(self, parameters: Tensor, actions: Tensor):
        """psi_{n+1} = -precond(residual); first order starts from zero
        (LinearEigensystemRSPT.h:66-80)."""
        n = self.xspace.size
        p0 = parameters[0]
        if n == 1:
            p0 = torch.zeros_like(p0)
        p0 = p0 - actions[0]
        parameters = torch.cat([p0[None, :], parameters[1:]], dim=0)
        self._end_iteration_needed = False
        self.stats.iterations += 1
        nwork = 0 if self.errors and self.errors[0] < self.convergence_threshold else 1
        return nwork, parameters, actions

    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        """Accumulate E_n = <psi_{n-1}|H|psi> and subtract sum_k E_{n-k} psi_k
        (LinearEigensystemRSPT.h:164-191). q[k] holds psi_{n-k-1}."""
        q_slots = [s[0] for s in self.xspace.q_slots]
        n = len(q_slots)
        c = params[-1]
        hc = actions[-1]
        if n == 1:
            self.rspt_values = [0.0]
        psi_last = self.xspace.store_v.get(q_slots[n - 1])
        self.rspt_values.append(float(torch.dot(psi_last, hc)))
        hc = hc - self.rspt_values[0] * c
        for k in range(n):
            qk = self.xspace.store_v.get(q_slots[n - k - 1])
            hc = hc - self.rspt_values[n - k] * qk
        return torch.cat([actions[:-1], hc[None, :]], dim=0)

    def report(self, iteration: Optional[int] = None) -> None:
        print(
            "Perturbed energies "
            + ", ".join(f"{v:.8f}" for v in self.rspt_values)
        )
