"""DIIS for nonlinear equations g(x) = 0 with a device-resident history
(port of iterative_solver_tpu/solvers/fused_diis.py).

The fused counterpart of ``NonLinearEquationsDIIS``
(NonLinearEquationsDIIS.h:27-183) for residual functions that are tensor
code: residual evaluation, history update, Pulay extrapolation and the
preconditioned step all stay on the device, and the host reads one scalar
(the residual norm) per iteration, where JAX runs one ``lax.while_loop``.

The design is the JAX package's:

- History lives in fixed-capacity (m, N) ring buffers; age-based overwrite
  replaces the reference's deletion of the least important vector, and its
  SVD-threshold deletion becomes eigenvalue clipping inside the
  extrapolation solve.
- The Pulay coefficients solve min ||sum_i c_i r_i|| s.t. sum_i c_i = 1
  through the bordered (m+1) x (m+1) system of the correlation matrix
  D^-1 B D^-1 (D = diag(||r_i||)), an eigenvalue-clipped pseudo-inverse and
  two refinement passes; an average over the valid slots stands in when the
  coefficients' sum collapses.
- x <- x_interp - precondition(r_interp), the default preconditioner the
  sign-preserving Jacobi inverse of the diagonals, identity without them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import config
from ..array import vector_ops as vops
from ._finite import check_finite

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6c)"


class DIISState(NamedTuple):
    x: Tensor        # (N,) current parameters
    r: Tensor        # (N,) residual g(x) (already evaluated)
    x_hist: Tensor   # (m, N) parameter history ring
    r_hist: Tensor   # (m, N) residual history ring
    b: Tensor        # (m, m) residual overlap <r_i, r_j>; zero rows for empty slots
    head: int        # ring index of the next write (host int)
    count: int       # number of valid history entries (host int)
    err: Tensor      # scalar ||r||


def _where(cond: Tensor, a: Tensor, other: float) -> Tensor:
    return torch.where(cond, a, torch.full_like(a, other))


def _clipped_pulay_solve(b: Tensor, valid: Tensor, svd_thresh: float,
                         refine: int = 2) -> Tensor:
    """Coefficients of min ||sum c_i r_i||, sum c_i = 1 over the valid slots
    (fused_diis.py:62-128): the correlation scaling, the bordered eigh
    clipped on |eigenvalue| below ``svd_thresh`` times the largest,
    ``refine`` refinement passes, then c / sum(c), or the average over the
    valid slots where |sum(c)| <= 0.1. Empty slots have zero rows in B and
    get coefficient 0."""
    m = b.shape[0]
    vmask = valid.to(b.dtype)
    d = torch.sqrt(_where(valid, torch.diagonal(b), 0.0))
    dinv = _where(d > 0, 1.0 / _where(d > 0, d, 1.0), 0.0)
    bt = b * dinv[:, None] * dinv[None, :]
    wnorm = torch.sqrt(torch.sum(dinv * dinv))
    wnorm = _where(wnorm > 0, wnorm, 1.0)
    what = dinv / wnorm
    bord = torch.zeros((m + 1, m + 1), dtype=b.dtype, device=b.device)
    bord[:m, :m] = bt
    bord[:m, m] = what
    bord[m, :m] = what
    rhs = torch.zeros((m + 1,), dtype=b.dtype, device=b.device)
    rhs[m] = 1.0 / wnorm
    w, v = torch.linalg.eigh(bord)
    wmax = torch.clamp(torch.max(torch.abs(w)), min=1e-300)
    keep = torch.abs(w) > svd_thresh * wmax  # indefinite: clip on |eigenvalue|
    winv = _where(keep, 1.0 / _where(keep, w, 1.0), 0.0)

    def apply_pinv(y):
        return torch.matmul(v, winv * torch.matmul(v.T, y))

    u = apply_pinv(rhs)
    for _ in range(refine):
        u = u + apply_pinv(rhs - torch.matmul(bord, u))
    c = dinv * u[:m]
    s = torch.sum(c)
    good = torch.abs(s) > 0.1
    nvalid = torch.clamp(torch.sum(vmask), min=1.0)
    return torch.where(good, c / _where(good, s, 1.0), vmask / nvalid)


def _keep_going(err: Tensor, tol: float) -> bool:
    # one scalar sync; a NaN residual norm ends the loop (run() then raises)
    # rather than masquerade as convergence
    return bool((err > tol) & torch.isfinite(err))


def make_diis_solve(
    residual_fn: Callable[..., Tensor],
    m: int,
    svd_thresh: Optional[float] = None,
    precondition: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
):
    """The solve loop (fused_diis.py:131-187). ``residual_fn(x, operand)``
    returns the residual g(x); ``precondition(r, dinv)`` (default: the
    Jacobi multiply r * dinv) maps the interpolated residual to the step.
    Returns ``solve(state, operand, dinv, tol, max_iter) -> (state,
    iterations)``, which steps while ``it < max_iter``, ``err > tol`` and
    ``err`` is finite."""

    if precondition is None:
        def precondition(r, dinv):
            return r * dinv

    def step(state: DIISState, operand, dinv, svd_thresh_) -> DIISState:
        head = state.head
        # the rings are the solve's own: insert the current pair in place
        x_hist, r_hist = state.x_hist, state.r_hist
        x_hist[head] = state.x
        r_hist[head] = state.r
        count = min(state.count + 1, m)
        valid = torch.arange(m, device=x_hist.device) < count
        # incremental overlap row/col <r_new, r_i> over valid slots
        row = _where(valid, torch.matmul(r_hist, state.r), 0.0)
        bmat = state.b.clone()
        bmat[head, :] = row
        bmat[:, head] = row

        c = _clipped_pulay_solve(bmat, valid, svd_thresh_)
        x_interp = torch.matmul(c, x_hist)
        r_interp = torch.matmul(c, r_hist)
        x_new = x_interp - precondition(r_interp, dinv)
        r_new = residual_fn(x_new, operand)
        err = torch.sqrt(torch.abs(torch.matmul(r_new, r_new)))
        return DIISState(x_new, r_new, x_hist, r_hist, bmat, (head + 1) % m, count, err)

    def solve(state: DIISState, operand, dinv, tol_, max_iter_):
        if svd_thresh is not None:
            svd_thresh_ = svd_thresh
        else:
            svd_thresh_ = 1e-12 if state.x.dtype == torch.float64 else 1e-6
        s, it = state, 0
        while it < max_iter_ and _keep_going(s.err, tol_):
            s = step(s, operand, dinv, svd_thresh_)
            it += 1
        return s, it

    return solve


class FusedDIIS:
    """DIIS-accelerated nonlinear-equation solver with its history on the
    device. ``residual_fn(x, operand) -> r`` runs once per iteration.

    ``device=None`` is the CUDA device and raises where CUDA is absent; pass
    ``device="cpu"`` for the host (the tests do). ``dtype=None`` is float32
    on CUDA and float64 on the CPU."""

    def __init__(
        self,
        residual_fn: Callable[..., Tensor],
        n: int,
        max_size_qspace: int = 10,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 100,
        operand=None,
        diagonals=None,
        svd_thresh: Optional[float] = None,
        precondition: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        if max_size_qspace < 2:
            raise ValueError("max_size_qspace must be >= 2 for DIIS extrapolation")
        self.device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.n = n
        self.m = int(max_size_qspace)
        self.dtype = dtype
        self.operand = operand
        self.convergence_threshold = convergence_threshold
        self.max_iter = max_iter
        if diagonals is not None:
            d = vops.to_device(diagonals, dtype, self.device)
            # Sign-preserving magnitude regularisation: the reference's flat
            # ``d + 1e-15`` (precondition_default, IterativeSolver.h:34-44)
            # blows up for a diagonal entry near -1e-15*max|d| and leaves
            # negative entries unregularised; clamping |d| from below keeps
            # the inverse bounded for indefinite diagonals.
            scale = torch.max(torch.abs(d))
            sgn = torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))
            self._dinv = sgn / torch.maximum(torch.abs(d), 1e-15 * scale + 1e-300)
        else:
            self._dinv = torch.ones((), dtype=dtype, device=self.device)
        self._solve = make_diis_solve(residual_fn, self.m, svd_thresh, precondition)
        self._residual_fn = residual_fn

    def run(self, x0):
        """Returns ``(x, err, iterations)``: ``x`` a tensor on the solver's
        device, ``err`` = ||g(x)||. Raises FloatingPointError when the
        residual norm is not finite."""
        x0 = vops.to_device(x0, self.dtype, self.device).reshape(self.n)
        r0 = self._residual_fn(x0, self.operand)
        err0 = torch.sqrt(torch.abs(torch.matmul(r0, r0)))
        like = dict(dtype=self.dtype, device=self.device)
        state = DIISState(
            x0, r0, torch.zeros((self.m, self.n), **like), torch.zeros((self.m, self.n), **like),
            torch.zeros((self.m, self.m), **like), 0, 0, err0,
        )
        final, iters = self._solve(state, self.operand, self._dinv,
                                   self.convergence_threshold, self.max_iter)
        err = float(final.err)
        check_finite(err, "FusedDIIS")
        return final.x, err, int(iters)
