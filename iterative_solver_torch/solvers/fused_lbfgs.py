"""L-BFGS minimiser with a device-resident history (port of
iterative_solver_tpu/solvers/fused_lbfgs.py).

The fused counterpart of ``OptimizeBFGS`` for objectives that are tensor
code: value and gradient, the two-loop recursion over a fixed-size (s, y)
ring buffer, the backtracking Armijo line search and the history update all
stay on the device. Where JAX runs one ``lax.while_loop``, the host here
reads one scalar per iteration (the gradient norm), one per line-search
trial (the Armijo test) and one for the curvature test that decides the
ring update; ring index and count are host ints.

(The parity ``OptimizeBFGS`` keeps the reference's Wolfe/cubic line search
for black-box callbacks.) ``value_and_grad(x, operand) -> (f, g)`` returns
tensors; g may come from ``torch.autograd.grad``, as the smoke run's does
through ``ops.kernels.symm.make_differentiable_symm_action``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .. import config
from ..array import vector_ops as vops
from ._finite import check_finite

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6)"


class LBFGSState(NamedTuple):
    x: Tensor        # (N,) parameters
    f: Tensor        # scalar value
    g: Tensor        # (N,) gradient
    s_hist: Tensor   # (m, N) steps
    y_hist: Tensor   # (m, N) gradient differences
    rho: Tensor      # (m,) 1/(s.y), 0 for empty slots
    head: int        # ring index of next write (host int)
    count: int       # number of valid pairs (host int)
    gnorm: Tensor    # scalar


def make_lbfgs_solve(
    value_and_grad: Callable[..., Tuple[Tensor, Tensor]],
    history: int,
    tol: float,
    max_iter: int,
    max_ls: int = 20,
    c1: float = 1e-4,
):
    """The solve loop (fused_lbfgs.py:40-131): ``solve(state, operand) ->
    (state, iterations)``, stepping while ``it < max_iter`` and ``gnorm >
    tol``."""

    m = history

    def two_loop(g, s_hist, y_hist, rho, head, count):
        """Standard L-BFGS two-loop recursion over the ring buffer's valid
        pairs. (JAX walks all m slots and masks the empty ones, whose terms
        add exactly zero.)"""
        q = g
        alphas = {}
        for i in range(count):
            idx = (head - 1 - i) % m
            alphas[idx] = rho[idx] * torch.dot(s_hist[idx], q)
            q = q - alphas[idx] * y_hist[idx]
        if count == 0:
            r = q  # gamma = 1
        else:
            # initial Hessian scale gamma = s.y / y.y of the newest pair
            newest = (head - 1) % m
            yy = torch.dot(y_hist[newest], y_hist[newest])
            rn = rho[newest]
            sy = torch.where(rn != 0, 1.0 / torch.where(rn != 0, rn, torch.ones_like(rn)),
                             torch.ones_like(rn))
            gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
                                torch.ones_like(yy))
            r = gamma * q
        for i in range(count):
            idx = (head - count + i) % m
            beta = rho[idx] * torch.dot(y_hist[idx], r)
            r = r + (alphas[idx] - beta) * s_hist[idx]
        return r

    def step(state: LBFGSState, operand) -> LBFGSState:
        d = -two_loop(state.g, state.s_hist, state.y_hist, state.rho, state.head, state.count)
        gd = torch.dot(state.g, d)
        # fall back to steepest descent if not a descent direction
        descent = gd < 0
        d = torch.where(descent, d, -state.g)
        gd = torch.where(descent, gd, -torch.dot(state.g, state.g))

        # backtracking Armijo line search: one host read per trial
        alpha = torch.ones((), dtype=state.x.dtype, device=state.x.device)
        f_new, g_new = value_and_grad(state.x + d, operand)
        tries = 0
        while tries < max_ls and bool(f_new > state.f + c1 * alpha * gd):
            alpha = alpha * 0.5
            f_new, g_new = value_and_grad(state.x + alpha * d, operand)
            tries += 1

        s = alpha * d
        y = g_new - state.g
        sy = torch.dot(s, y)
        good = sy > 1e-12 * torch.sqrt(torch.dot(s, s) * torch.dot(y, y))
        head, count = state.head, state.count
        if bool(good):
            # the rings are the solve's own: write the new pair in place
            state.s_hist[head] = s
            state.y_hist[head] = y
            state.rho[head] = 1.0 / sy
            head, count = (head + 1) % m, min(count + 1, m)
        gnorm = torch.sqrt(torch.dot(g_new, g_new))
        return LBFGSState(state.x + s, f_new, g_new, state.s_hist, state.y_hist, state.rho,
                          head, count, gnorm)

    def solve(state: LBFGSState, operand):
        s, it = state, 0
        # one scalar read per iteration; a NaN norm ends the loop (NaN > tol
        # is False) and run() then raises
        while it < max_iter and bool(s.gnorm > tol):
            s = step(s, operand)
            it += 1
        return s, it

    return solve


class FusedLBFGS:
    """L-BFGS with its history on the device.

    ``device=None`` is the CUDA device and raises where CUDA is absent; pass
    ``device="cpu"`` for the host (the tests do). ``dtype=None`` is float32
    on CUDA and float64 on the CPU."""

    def __init__(
        self,
        value_and_grad: Callable[..., Tuple[Tensor, Tensor]],
        n: int,
        history: int = 10,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 500,
        operand=None,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        self.device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.n = n
        self.history = history
        self.dtype = dtype
        self.operand = operand
        self._solve = make_lbfgs_solve(value_and_grad, history, convergence_threshold, max_iter)
        self._vg = value_and_grad

    def run(self, x0):
        """Returns ``(x, f, gnorm, iterations)``: ``x`` a tensor on the
        solver's device. Raises FloatingPointError when f or the gradient
        norm is not finite."""
        x0 = vops.to_device(x0, self.dtype, self.device)
        f0, g0 = self._vg(x0, self.operand)
        m = self.history
        like = dict(dtype=self.dtype, device=self.device)
        state = LBFGSState(
            x0, f0, g0, torch.zeros((m, self.n), **like), torch.zeros((m, self.n), **like),
            torch.zeros((m,), **like), 0, 0, torch.sqrt(torch.dot(g0, g0)),
        )
        final, iters = self._solve(state, self.operand)
        f, gnorm = float(final.f), float(final.gnorm)
        check_finite([f, gnorm], "FusedLBFGS")
        return final.x, f, gnorm, int(iters)
