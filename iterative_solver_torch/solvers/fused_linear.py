"""Fused linear-equation solver A X = B with multiple right-hand sides (port
of iterative_solver_tpu/solvers/fused_linear.py).

The counterpart of `LinearEquationsDavidson` on the fused solvers' design:
the same fixed-capacity masked basis as the fused Davidson
(fused_davidson.py), with a step that solves the projected system instead
of an eigenproblem:

  matvec -> masked projected matrix H = V (A V)^T and rhs beta = V B^T ->
  small solve -> X = C V, residual R = A X - B -> Jacobi preconditioning ->
  Gram-Schmidt -> whiten -> append

As in the port's Davidson, the ``lax.while_loop`` becomes a host loop that
checks convergence before every iteration, ``k`` is a host int, and a step
appends into the state's stacks in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..array.vector_ops import chol_jitter
from ..ops.kernels.chain import (
    _cholesky_nan,
    chain_auto,
    fused_expand_chain,
    lower_solve,
    whiten_after_chain,
)
from ._finite import check_finite
from .fused_davidson import (
    _SHARDING,
    _check_tier,
    _dots,
    _eigh_whiten_cols,
    _eye,
    _p_project,
    _stack_rows,
    packed_symmetric_action,
    validate_p_inputs,
)

Tensor = torch.Tensor


class LinearState(NamedTuple):
    v: Tensor        # (m_max, N) basis
    w: Tensor        # (m_max, N) A·basis
    mask: Tensor     # (m_max,)
    k: int           # count of appended slots (host int)
    x: Tensor        # (nrhs, N) current solutions
    r: Tensor        # (nrhs, N) current residuals
    errors: Tensor   # (nrhs,) |A x - b| / |b|


def _step_body(matvec: Callable[..., Tensor], nrhs: int, m_max: int,
               null_thresh: float = 1e-10, fuse_chain: bool = False):
    """One iteration (fused_linear.py:38-115). The step needs no P-awareness:
    the projected solve runs over every masked slot, so frozen P rows enter
    H, beta and the solution through the ordinary mask."""
    if m_max < 2 * nrhs:
        # room for the carried block plus one append
        raise ValueError(f"m_max must be >= 2*nrhs ({2 * nrhs}), got {m_max}")

    def step(state: LinearState, operand, diag: Tensor, b: Tensor,
             b_norm: Tensor) -> LinearState:
        v, w, mask, k = state.v, state.w, state.mask, state.k
        h = torch.matmul(v, w.T)
        # inactive slots solve a trivial identity system with zero rhs; the
        # operator is hermitian here, so the projected solve is an eigh
        h = 0.5 * (h + h.T)
        dead = 1.0 - mask
        h = h * (mask[:, None] * mask[None, :]) + dead[:, None] * dead[None, :] * _eye(m_max, h)
        beta = torch.matmul(v, b.T) * mask[:, None]  # (m_max, nrhs)
        evals_h, c = torch.linalg.eigh(h)
        safe = torch.where(torch.abs(evals_h) > 1e-30, evals_h, torch.ones_like(evals_h))

        def hsolve(rhs):
            return torch.matmul(c, torch.matmul(c.T, rhs) / safe[:, None])

        co = hsolve(beta)
        # two passes of iterative refinement: a low-accuracy eigh (the
        # TPU's f32 eigh is ~1e-3..1e-4) passes its error straight into the
        # subspace solution and stalls the solve; each pass squares the
        # factorisation error for two (m, m) matmuls
        for _ in range(2):
            co = co + hsolve(beta - torch.matmul(h, co))
        coeff = co.T * mask[None, :]  # (nrhs, m_max)
        x = torch.matmul(coeff, v)
        ax = torch.matmul(coeff, w)
        r = ax - b
        errors = torch.sqrt(torch.abs(_dots(r, r))) / b_norm

        # diag is (N,) shared or (nrhs, N) per right-hand side (shifted
        # systems precondition row i with diag - lambda_i); the regulariser
        # is relative to the operator's scale
        d = diag if diag.dim() == 2 else diag[None, :]
        t = r / (d + 1e-15 * torch.max(torch.abs(d)) + 1e-300)
        if fuse_chain:
            # GS + norms + Gram as one kernel launch in K2's raw mode (no
            # Jacobi inside: this family's preconditioner differs)
            t, n0_2, n2, g = fused_expand_chain(t.contiguous(), v, mask)
            t, keep = whiten_after_chain(t, n0_2, n2, nrhs, null_thresh, g=g)
        else:
            n0_2 = _dots(t, t)
            for _ in range(2):
                proj = torch.matmul(t, v.T) * mask[None, :]
                t = t - torch.matmul(proj, v)
            n2 = _dots(t, t)
            t, keep = whiten_after_chain(t, n0_2, n2, nrhs, null_thresh)

        if k + nrhs > m_max:
            raise ValueError(f"append at slot {k} overflows m_max={m_max}")
        v[k:k + nrhs] = t.to(v.dtype)
        w[k:k + nrhs] = matvec(t, operand).to(w.dtype)
        mask_new = mask.clone()
        mask_new[k:k + nrhs] = torch.where(keep, torch.ones_like(mask[:nrhs]),
                                           mask[k:k + nrhs])
        return LinearState(v, w, mask_new, k + nrhs, x, r, errors)

    return step


def _restart_body(matvec, nrhs: int, m_max: int, n_p: int = 0):
    """Collapse the basis onto the current solutions (fused_linear.py:118-155).
    With ``n_p > 0`` the frozen P slots survive (basis and action rows) and
    the solution block is projected against them and eigh-whitened with
    null-drop (a solution converged into the P span projects to zero)."""

    def restart(state: LinearState, operand) -> LinearState:
        x = state.x
        if n_p:
            pv, pw = state.v[:n_p], state.w[:n_p]
            x = _p_project(x, pv)
            xo_t, keep = _eigh_whiten_cols(x.T, thresh=1e-10)
            xo = xo_t.T
            live = keep.to(state.mask.dtype)
            v = _stack_rows([pv, xo.to(pv.dtype)], m_max)
            w = _stack_rows([pw, (matvec(xo, operand) * live[:, None]).to(pw.dtype)], m_max)
            mask = _stack_rows([live.new_ones((n_p,)), live], m_max)
            return LinearState(v, w, mask, n_p + nrhs, state.x, state.r, state.errors)
        g = torch.matmul(x, x.T)
        l = _cholesky_nan(g + 1e-30 * _eye(nrhs, g))
        xo = lower_solve(l, x)
        v = _stack_rows([xo.to(state.v.dtype)], m_max)
        w = _stack_rows([matvec(xo, operand).to(state.w.dtype)], m_max)
        mask = _stack_rows([torch.ones_like(state.mask[:nrhs])], m_max)
        return LinearState(v, w, mask, nrhs, state.x, state.r, state.errors)

    return restart


def make_linear_solve(matvec, nrhs: int, m_max: int, tol: float, max_iter: int,
                      fuse_chain: bool = False, n_p: int = 0):
    """The whole A X = B solve (fused_linear.py:158-189):
    ``solve(state, operand, diag, b, b_norm) -> (final, iterations)``."""
    if m_max < 2 * nrhs + n_p:
        raise ValueError(
            f"m_max must be >= 2*nrhs + n_p ({2 * nrhs + n_p}), got {m_max}")
    step = _step_body(matvec, nrhs, m_max, fuse_chain=fuse_chain)
    restart = _restart_body(matvec, nrhs, m_max, n_p)

    def solve(state: LinearState, operand, diag: Tensor, b: Tensor, b_norm: Tensor):
        s, it = state, 0
        # one scalar sync per iteration; a NaN error ends the loop (NaN > tol
        # is False) and check_finite then raises
        while it < max_iter and bool(torch.max(s.errors) > tol):
            if s.k + nrhs > m_max:
                s = restart(s, operand)
            s = step(s, operand, diag, b, b_norm)
            it += 1
        return s, it

    return solve


def make_linear_init(matvec, nrhs: int, m_max: int, n_p: int = 0,
                     p_actions: bool = False):
    """Whole initialisation (fused_linear.py:192-280): normalise and whiten
    the start block, apply the operator, lay out the stacks; returns
    ``(state, b_norm)``.

    ``n_p > 0`` adds two arguments (densified P rows and their action rows)
    and freezes the whitened P block into slots [0, n_p), as the Davidson
    init does; with ``p_actions`` the caller's exact action rows ride the
    same whitening (``lower_solve``)."""

    def start(b, v0raw):
        b_norm = torch.sqrt(torch.abs(_dots(b, b)))
        n0 = torch.sqrt(torch.abs(_dots(v0raw, v0raw)))
        return b_norm, v0raw / torch.where(n0 > 0, n0, torch.ones_like(n0))[:, None]

    def state_of(v, w, mask, k, b):
        return LinearState(v, w, mask, k, torch.zeros_like(b), torch.zeros_like(b),
                           torch.full((nrhs,), float("inf"), dtype=b.dtype, device=b.device))

    def init_p(b, v0raw, operand, p, wp):
        b_norm, v0 = start(b, v0raw)
        gp = torch.matmul(p, p.T)
        lp = _cholesky_nan(gp + 1e-30 * _eye(n_p, gp))
        pwhite = lower_solve(lp, p)
        wpw = lower_solve(lp, wp) if p_actions else matvec(pwhite, operand)
        v0 = _p_project(v0, pwhite)
        v0o_t, keep = _eigh_whiten_cols(v0.T, thresh=1e-10)
        v0o = v0o_t.T
        live = keep.to(b.dtype)
        w0 = matvec(v0o, operand) * live[:, None]
        v = _stack_rows([pwhite.to(b.dtype), v0o.to(b.dtype)], m_max)
        w = _stack_rows([wpw.to(b.dtype), w0.to(b.dtype)], m_max)
        mask = _stack_rows([live.new_ones((n_p,)), live], m_max)
        return state_of(v, w, mask, n_p + nrhs, b), b_norm

    if n_p:
        return init_p

    def init(b, v0raw, operand):
        b_norm, v0 = start(b, v0raw)
        g = torch.matmul(v0, v0.T)
        g = 0.5 * (g + g.T) + chol_jitter(g.dtype) * _eye(nrhs, g)
        v0 = lower_solve(_cholesky_nan(g), v0)
        w0 = matvec(v0, operand)
        v = _stack_rows([v0.to(b.dtype)], m_max)
        w = _stack_rows([w0.to(b.dtype)], m_max)
        mask = _stack_rows([b.new_ones((nrhs,))], m_max)
        return state_of(v, w, mask, nrhs, b), b_norm

    return init


class FusedLinearEquations:
    """Driver: the whole multi-RHS solve (fused_linear.py:283-477).

    ``device=None`` means CUDA and raises where CUDA is absent; pass
    ``device="cpu"`` for the host. ``dtype=None`` is float32 on CUDA and
    float64 on the CPU. ``fuse_chain=None`` turns the chain kernel (K2, raw
    mode) on for float32 on CUDA."""

    def __init__(
        self,
        matvec: Callable[..., Tensor],
        diagonals,
        n: int,
        nrhs: int,
        m_max: Optional[int] = None,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 200,
        operand=None,
        fuse_chain: Optional[bool] = None,
        check_symmetric: bool = True,
        p_space=None,
        p_actions=None,
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
        self.check_symmetric = check_symmetric
        self._symmetry_checked = False
        self.p_dense, self.n_p, self.p_action_rows = validate_p_inputs(
            p_space, p_actions, n)
        self._p_dev = None
        self.m_max = m_max if m_max is not None else max(
            4 * nrhs + self.n_p, min(n, 24))
        self.dtype = dtype
        self.sharding = None
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.diag = torch.as_tensor(np.array(diagonals), dtype=dtype, device=self.device)
        self.operand = operand
        if fuse_chain is None:
            fuse_chain = chain_auto(self.device, dtype)
        self.fuse_chain = fuse_chain
        self._solve = make_linear_solve(matvec, nrhs, self.m_max, self.tol, self.max_iter,
                                        fuse_chain=fuse_chain, n_p=self.n_p)
        self._init = make_linear_init(
            matvec, nrhs, self.m_max, n_p=self.n_p,
            p_actions=self.n_p > 0 and self.p_action_rows is not None)

    @classmethod
    def from_dense_symmetric(cls, matrix, nrhs: int, tier: Optional[str] = None,
                             b: Optional[int] = None, device=None,
                             **kwargs) -> "FusedLinearEquations":
        """Build the solver around the packed-triangle symmetric action
        (symmetric A X = B, the response-equation shape), with the tiers of
        FusedDavidson.from_dense_symmetric. The operator dimension must be
        a multiple of the tile size: a zero-padded row makes A singular.
        The automatic tile is the largest power of two that divides n, from
        1024 ("fast", "int8", "int8_precise") or 512 down to 128."""
        device = config.resolve_device(device)
        matrix = np.asarray(matrix, dtype=np.float64)
        n = matrix.shape[0]
        tier = _check_tier(tier, device, kwargs.get("dtype"))
        if b is None:
            start = 1024 if tier in ("fast", "int8", "int8_precise") else 512
            b = start
            while b > 128 and n % min(b, n) != 0:
                b //= 2
            if n % min(b, n) != 0:
                b = start  # no admissible tile: report against the preferred size
        b = min(b, n)
        if n % b != 0:
            raise ValueError(
                f"operator dimension {n} must be a multiple of the tile size {b} "
                f"(zero padding would make the linear system singular)")
        matvec, operand, _ = packed_symmetric_action(matrix, tier, b, device)
        return cls(matvec, np.diagonal(matrix).copy(), n, nrhs, operand=operand,
                   device=device, **kwargs)

    def solve(self, b, x0=None):
        """Returns ``(x, errors, iterations)``; ``b`` is (nrhs, N), ``x`` a
        tensor on the solver's device, ``errors`` numpy |A x - b| / |b|."""
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        b_host = np.atleast_2d(np.asarray(b))
        # validate at the solver dtype: a row that underflows to zero in f32
        # would divide the errors by zero
        b_cast = b_host.astype(np.float32 if self.dtype == torch.float32 else np.float64)
        if not np.all(np.linalg.norm(b_cast, axis=1) > 0):
            raise RuntimeError("RHS vector cannot be zero")
        b = torch.as_tensor(b_host, dtype=self.dtype, device=self.device)
        if self.check_symmetric and not self._symmetry_checked:
            from ._symmetry import check_symmetric_operator

            check_symmetric_operator(
                self.matvec, self.operand, tuple(b.shape), self.dtype,
                "FusedLinearEquations",
                "solvers.linear_equations.LinearEquationsDavidson"
                "(hermitian=False)",
                device=self.device,
            )
            self._symmetry_checked = True
        if x0 is None:
            v0raw = b
        else:
            v0raw = (x0 if isinstance(x0, torch.Tensor) else torch.as_tensor(np.asarray(x0)))
            v0raw = v0raw.to(device=self.device, dtype=self.dtype)
        if self.n_p:
            if self._p_dev is None:
                p = torch.as_tensor(self.p_dense, dtype=self.dtype, device=self.device)
                wp = (torch.as_tensor(self.p_action_rows, dtype=self.dtype, device=self.device)
                      if self.p_action_rows is not None else torch.zeros_like(p))
                self._p_dev = (p, wp)
            state, b_norm = self._init(b, v0raw, self.operand, *self._p_dev)
        else:
            state, b_norm = self._init(b, v0raw, self.operand)
        final, iters = self._solve(state, self.operand, self.diag, b, b_norm)
        errors = final.errors.cpu().numpy()
        check_finite(errors, "FusedLinearEquations")
        return final.x, errors, int(iters)
