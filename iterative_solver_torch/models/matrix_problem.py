"""Built-in problem definitions (port of
iterative_solver_tpu/models/matrix_problem.py):

- ``MatrixProblem``: a dense kernel matrix on the device, action x Aᵀ
  (reference: examples/ExampleProblem.h / the tests' Problem classes);
- ``load_hamiltonian``: reader for the FCI ``*.hamiltonian`` text files —
  first token n, then n^2 row-major doubles
  (test/itsolv/test_LinearEigensystem.cpp:53-64);
- ``ExampleProblem``: matrix(i,j) = i+1 if i==j else 0.001*((i+j)%n)
  (examples/ExampleProblem.h);
- ``QuadraticOptimizeProblem``: f = 1/2 (x-b)^T H (x-b)
  (test/itsolv/test_Optimize.cpp);
- ``TrigNonlinearProblem``: trigonometric nonlinear equations
  (test/itsolv/test_NonLinearEquations.cpp:174-205);
- ``RayleighQuotientProblem``: nonlinear Rayleigh-quotient minimisation
  (test/itsolv/test_rayleigh_quotient.cpp, python/test).

Each takes ``device`` (``None``: the CUDA device) and ``dtype`` (``None``:
the device's working dtype), as ``MatrixProblem`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .. import config
from ..problem import Problem

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6)"


def load_hamiltonian(path: str) -> np.ndarray:
    """Parse a .hamiltonian file: dimension token then n^2 doubles."""
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    values = np.asarray([float(t) for t in tokens[1: 1 + n * n]])
    return values.reshape(n, n)


class MatrixProblem(Problem):
    """Linear problem defined by an explicit (hermitian or not) matrix.
    ``device=None`` is the CUDA device; ``dtype=None`` the device's working
    dtype (float32 on CUDA, float64 on the CPU)."""

    def __init__(self, matrix, dtype=None, sharding=None, device=None):
        super().__init__()
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        matrix = np.asarray(matrix, dtype=np.float64)
        self.dimension = matrix.shape[0]
        self.device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.matrix = torch.as_tensor(matrix, dtype=dtype, device=self.device)
        self.n_actions = 0

    def action(self, parameters: Tensor) -> Tensor:
        self.n_actions += parameters.shape[0]
        return torch.matmul(parameters, self.matrix.T)

    def diagonals(self) -> Tensor:
        return torch.diagonal(self.matrix)

    def pp_action_matrix(self, pvectors: Sequence[Dict[int, float]]) -> np.ndarray:
        n_p = len(pvectors)
        mat = np.zeros((n_p, n_p))
        host = self.matrix.to(torch.float64).cpu().numpy()
        for i, pi in enumerate(pvectors):
            for j, pj in enumerate(pvectors):
                mat[i, j] = sum(
                    ci * cj * host[int(a), int(b)] for a, ci in pi.items() for b, cj in pj.items()
                )
        return mat

    def p_action(self, p_coefficients: np.ndarray,
                 pvectors: Sequence[Dict[int, float]]) -> Tensor:
        dense_p = np.zeros((len(pvectors), self.dimension))
        for i, pvec in enumerate(pvectors):
            for idx, val in pvec.items():
                dense_p[i, int(idx)] = val
        like = dict(dtype=self.matrix.dtype, device=self.matrix.device)
        coeff = torch.as_tensor(np.asarray(p_coefficients), **like)
        pblock = torch.as_tensor(dense_p, **like)
        return torch.matmul(torch.matmul(coeff, pblock), self.matrix.T)


class ExampleProblem(MatrixProblem):
    """matrix(i,j) = i+1 on the diagonal, 0.001*((i+j) % n) off it."""

    def __init__(self, n: int, **kwargs):
        i = np.arange(n)[:, None]
        j = np.arange(n)[None, :]
        matrix = np.where(i == j, (i + 1).astype(np.float64), 0.001 * ((i + j) % n))
        super().__init__(matrix, **kwargs)


def _on(device, dtype):
    device = config.resolve_device(device)
    return device, (config.default_dtype(device) if dtype is None else dtype)


class QuadraticOptimizeProblem(Problem):
    """f = 1/2 (x-b)^T H (x-b); gradient H (x-b)."""

    def __init__(self, hessian, b=None, dtype=None, device=None):
        super().__init__()
        hessian = np.asarray(hessian, dtype=np.float64)
        self.dimension = hessian.shape[0]
        if b is None:
            b = np.ones(self.dimension)
        self.device, dtype = _on(device, dtype)
        self.hessian = torch.as_tensor(hessian, dtype=dtype, device=self.device)
        self.b = torch.as_tensor(np.asarray(b, dtype=np.float64), dtype=dtype,
                                 device=self.device)

    def residual(self, parameters: Tensor):
        d = parameters - self.b
        grad = torch.matmul(self.hessian, d)
        value = 0.5 * float(torch.dot(d, grad))
        return value, grad

    def diagonals(self) -> Tensor:
        return torch.diagonal(self.hessian)

    def test_parameters(self, instance: int):
        if instance > 3:
            return None
        rng = np.random.default_rng(instance)
        return rng.standard_normal(self.dimension)


class TrigNonlinearProblem(Problem):
    """Nonlinear equations r_i = x_i + a_i sin(x_i) - b_i (smooth, diagonal-ish)."""

    def __init__(self, n: int, dtype=None, device=None):
        super().__init__()
        self.dimension = n
        self.device, dtype = _on(device, dtype)
        rng = np.random.default_rng(42)
        self.a = torch.as_tensor(0.3 + 0.2 * rng.random(n), dtype=dtype, device=self.device)
        self.b = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=self.device)

    def residual(self, parameters: Tensor):
        res = parameters + self.a * torch.sin(parameters) - self.b
        return 0.0, res

    def diagonals(self) -> Tensor:
        return 1.0 + self.a


class RayleighQuotientProblem(Problem):
    """Minimise the Rayleigh quotient of a matrix via Optimize — the nonlinear
    cross-check of the eigensolver (test_rayleigh_quotient.cpp)."""

    def __init__(self, matrix, dtype=None, device=None):
        super().__init__()
        matrix = np.asarray(matrix, dtype=np.float64)
        self.dimension = matrix.shape[0]
        self.device, dtype = _on(device, dtype)
        self.matrix = torch.as_tensor(matrix, dtype=dtype, device=self.device)

    def residual(self, parameters: Tensor):
        ax = torch.matmul(self.matrix, parameters)
        xx = float(torch.dot(parameters, parameters))
        xax = float(torch.dot(parameters, ax))
        value = xax / xx
        grad = 2.0 * (ax - value * parameters) / xx
        return value, grad

    def precondition(self, residual, shift=None, diagonals=None):
        # The Rayleigh-quotient Hessian is ~2(A - theta); a zero-shift Jacobi
        # update flips the step sign wherever the diagonal is negative, so
        # approximate theta by the smallest diagonal to keep curvature positive.
        d = torch.diagonal(self.matrix)
        denom = d - torch.min(d) + 1.0
        return residual / denom[None, :]
