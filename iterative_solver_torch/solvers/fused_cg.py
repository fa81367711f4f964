"""Fused preconditioned block conjugate gradient for SPD systems A X = B
(port of iterative_solver_tpu/solvers/fused_cg.py).

The subspace family (`fused_linear.FusedLinearEquations`) carries an
(m_max, N) basis and solves a projected system every iteration. For the
symmetric positive definite case the production solver is preconditioned
CG: three (nrhs, N) blocks of state (x, r, p), one matvec and a few
row-wise operations per iteration, no small eigh. Each right-hand side
runs its own scalar CG recurrence; Jacobi preconditioning reuses the
solver family's diagonals contract.

Converged systems freeze (alpha forced to 0), so late right-hand sides
cannot disturb early ones: the working-set shrinking of the reference
(IterativeSolverTemplate.h:105-117) without dynamic shapes. The JAX
``lax.while_loop`` becomes a host loop that checks convergence before
every iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..array.vector_ops import dots_rows as _rows_dot
from ._finite import check_finite
from .fused_davidson import _SHARDING

Tensor = torch.Tensor


class CGState(NamedTuple):
    x: Tensor        # (nrhs, N) iterates
    r: Tensor        # (nrhs, N) residuals b - A x
    p: Tensor        # (nrhs, N) search directions
    rz: Tensor       # (nrhs,) <r, z> carried for beta
    errors: Tensor   # (nrhs,) |r| / |b|


def _jacobi_inverse(diag: Tensor) -> Tensor:
    """Reciprocal of the regularised Jacobi denominator, formed once per
    solve; ``diag`` is (N,) shared or (nrhs, N) per right-hand side."""
    d = diag if diag.dim() == 2 else diag[None, :]
    return 1.0 / (d + 1e-15 * torch.max(torch.abs(d)) + 1e-300)


def _step_body(matvec: Callable[..., Tensor]):
    def step(state: CGState, operand, dinv: Tensor, b_norm: Tensor, tol_) -> CGState:
        x, r, p, rz = state.x, state.r, state.p, state.rz
        ap = matvec(p, operand)
        pap = _rows_dot(p, ap)
        # frozen systems (converged, or p annihilated) take a zero step; the
        # guard is relative to rz, so a non-SPD or ill-conditioned operator
        # driving pap toward 0 stops the iterate instead of exploding it
        eps = 1e-12 if pap.dtype == torch.float64 else 1e-6
        active = (state.errors > tol_) & (pap > eps * rz)
        one = torch.ones_like(pap)
        alpha = torch.where(active, rz / torch.where(active, pap, one), torch.zeros_like(pap))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = r * dinv
        rz_new = _rows_dot(r, z)
        beta = torch.where(active, rz_new / torch.where(rz > 0, rz, one), torch.zeros_like(rz))
        p = z + beta[:, None] * p
        errors = torch.sqrt(torch.abs(_rows_dot(r, r))) / b_norm
        return CGState(x, r, p, rz_new, errors)

    return step


def make_cg_solve(matvec: Callable[..., Tensor]):
    """The whole A X = B solve:
    ``solve(state, operand, diag, b_norm, tol, max_iter) -> (state, iterations)``."""
    step = _step_body(matvec)

    def solve(state: CGState, operand, diag: Tensor, b_norm: Tensor, tol_, max_iter_):
        dinv = _jacobi_inverse(diag)
        s, it = state, 0
        # one scalar sync per iteration; NaN > tol is False, so a NaN error
        # ends the loop and check_finite raises
        while it < max_iter_ and bool(torch.max(s.errors) > tol_):
            s = step(s, operand, dinv, b_norm, tol_)
            it += 1
        return s, it

    return solve


def make_cg_init(matvec: Callable[..., Tensor]):
    def init(x0: Tensor, b: Tensor, operand, diag: Tensor, b_norm: Tensor) -> CGState:
        r = b - matvec(x0, operand)
        z = r * _jacobi_inverse(diag)
        rz = _rows_dot(r, z)
        errors = torch.sqrt(torch.abs(_rows_dot(r, r))) / b_norm
        return CGState(x0, r, z, rz, errors)

    return init


def make_batched_cg_solve(matvec: Callable[..., Tensor]):
    """Many independent SPD systems over a leading batch axis of (operand,
    diag, B) (fused_cg.py:95-113). The CG step has no branch, so the
    single solve's step runs under ``torch.func.vmap`` for the whole batch;
    the loop runs until the slowest element converges, converged rows
    freeze through the per-row active mask as in the single solve, and
    elements past their own stopping test hold their state. Returns
    ``(batched_init, batched_solve)`` with a leading batch axis on every
    tensor; ``batched_solve`` returns ``(final, iters)`` with
    ``iters`` a (B,) int64 tensor, each element's own count (the
    iterations while any of its rows was above ``tol``). The matvec must
    be vmap-compatible (a dense product; not the packed kernel wrappers)."""
    init = make_cg_init(matvec)
    step = _step_body(matvec)
    v_init = torch.func.vmap(init)
    v_dinv = torch.func.vmap(_jacobi_inverse)

    def batched_init(x0, b, operand, diag, b_norm) -> CGState:
        return v_init(x0, b, operand, diag, b_norm)

    def batched_solve(state: CGState, operand, diag, b_norm, tol_, max_iter_):
        v_step = torch.func.vmap(lambda s_, o_, d_, n_: step(s_, o_, d_, n_, tol_))
        dinv = v_dinv(diag)
        nb = state.x.shape[0]
        its = torch.zeros(nb, dtype=torch.int64)
        s = state
        for _ in range(int(max_iter_)):
            going = (torch.amax(s.errors, dim=1) > tol_).cpu()
            if not bool(going.any()):
                break
            new = v_step(s, operand, dinv, b_norm)
            # elements past their own stopping test hold their state
            g = going.to(s.x.device)
            s = CGState(*(torch.where(g.view((-1,) + (1,) * (a.dim() - 1)), an, a)
                          for an, a in zip(new, s)))
            its += going.to(torch.int64)
        return s, its

    return batched_init, batched_solve


class FusedBlockCG:
    """Driver: Jacobi-preconditioned block CG (fused_cg.py:126-219).

    For SPD operators only (the CG invariant); use FusedLinearEquations for
    indefinite or general symmetric systems. Shares the (matvec, diagonals,
    n, nrhs, operand) constructor of the other fused families.
    ``device=None`` means CUDA and raises where CUDA is absent."""

    def __init__(
        self,
        matvec: Callable[..., Tensor],
        diagonals,
        n: int,
        nrhs: int,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 1000,
        operand=None,
        check_symmetric: bool = True,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        self.device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.matvec = matvec
        self.n = n
        self.nrhs = nrhs
        self.dtype = dtype
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.operand = operand
        self.sharding = None
        self.diag = torch.as_tensor(np.array(diagonals), dtype=dtype, device=self.device)
        self._init = make_cg_init(matvec)
        self._solve = make_cg_solve(matvec)
        self.check_symmetric = check_symmetric
        self._symmetry_checked = False

    def _tensor(self, a) -> Tensor:
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return a.to(device=self.device, dtype=self.dtype)

    def solve(self, b, x0=None):
        """Returns ``(x, errors, iterations)``; errors are |A x - b| / |b|.
        ``x`` stays a tensor on the solver's device; errors come back as
        numpy."""
        b = self._tensor(b)
        x0 = torch.zeros_like(b) if x0 is None else self._tensor(x0)
        b_norm = torch.sqrt(torch.abs(_rows_dot(b, b)))
        b_norm = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))
        if self.check_symmetric and not self._symmetry_checked:
            from ._symmetry import check_symmetric_operator

            # row-wise shifted SPD systems stay term-by-term symmetric
            # under the block contraction, so the probe holds for them too
            check_symmetric_operator(
                self.matvec, self.operand, tuple(b.shape), self.dtype,
                "FusedBlockCG",
                "solvers.linear_equations.LinearEquationsDavidson"
                "(hermitian=False)",
                device=self.device,
            )
            self._symmetry_checked = True
        state = self._init(x0, b, self.operand, self.diag, b_norm)
        final, iters = self._solve(state, self.operand, self.diag, b_norm,
                                   self.tol, self.max_iter)
        errors = final.errors.cpu().numpy()
        check_finite(errors, "FusedBlockCG")
        return final.x, errors, int(iters)
