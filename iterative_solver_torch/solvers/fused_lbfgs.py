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

``sharding=`` (parallel/mesh.py, e.g. ``block_sharding(mesh)``) runs one
process per shard of the vector axis: x, g and the (s, y) rings are each
rank's slices, and every dot of the two-loop recursion, the Armijo test's
directional derivative, the curvature test and the gradient norm is
all-reduced (``psum``, the ranks' parts added in rank order, so every rank
takes the same branch). ``value_and_grad`` then receives the rank's slice
of x and returns the GLOBAL f (the same on every rank) and the rank's
slice of g; ``run`` takes the global x0 on every rank and returns x
gathered.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .. import config
from ..array import vector_ops as vops
from ..parallel.collectives import psum
from ..parallel.mesh import check_sharding
from ._finite import check_finite

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor, sharding) -> Tensor:
    return psum(torch.dot(a, b), sharding)


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
    sharding=None,
):
    """The solve loop (fused_lbfgs.py:40-131): ``solve(state, operand) ->
    (state, iterations)``, stepping while ``it < max_iter`` and ``gnorm >
    tol``. ``sharding``: the state's vectors are this rank's slices and
    every dot is all-reduced."""
    sh = sharding

    m = history

    def two_loop(g, s_hist, y_hist, rho, head, count):
        """Standard L-BFGS two-loop recursion over the ring buffer's valid
        pairs. (JAX walks all m slots and masks the empty ones, whose terms
        add exactly zero.)"""
        q = g
        alphas = {}
        for i in range(count):
            idx = (head - 1 - i) % m
            alphas[idx] = rho[idx] * _dot(s_hist[idx], q, sh)
            q = q - alphas[idx] * y_hist[idx]
        if count == 0:
            r = q  # gamma = 1
        else:
            # initial Hessian scale gamma = s.y / y.y of the newest pair
            newest = (head - 1) % m
            yy = _dot(y_hist[newest], y_hist[newest], sh)
            rn = rho[newest]
            sy = torch.where(rn != 0, 1.0 / torch.where(rn != 0, rn, torch.ones_like(rn)),
                             torch.ones_like(rn))
            gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, torch.ones_like(yy)),
                                torch.ones_like(yy))
            r = gamma * q
        for i in range(count):
            idx = (head - count + i) % m
            beta = rho[idx] * _dot(y_hist[idx], r, sh)
            r = r + (alphas[idx] - beta) * s_hist[idx]
        return r

    def step(state: LBFGSState, operand) -> LBFGSState:
        d = -two_loop(state.g, state.s_hist, state.y_hist, state.rho, state.head, state.count)
        gd = _dot(state.g, d, sh)
        # fall back to steepest descent if not a descent direction
        descent = gd < 0
        d = torch.where(descent, d, -state.g)
        gd = torch.where(descent, gd, -_dot(state.g, state.g, sh))

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
        # s.y, s.s and y.y in one reduction
        sy, ss, yy = psum(torch.stack([torch.dot(s, y), torch.dot(s, s), torch.dot(y, y)]),
                          sh).unbind(0)
        good = sy > 1e-12 * torch.sqrt(ss * yy)
        head, count = state.head, state.count
        if bool(good):
            # the rings are the solve's own: write the new pair in place
            state.s_hist[head] = s
            state.y_hist[head] = y
            state.rho[head] = 1.0 / sy
            head, count = (head + 1) % m, min(count + 1, m)
        gnorm = torch.sqrt(_dot(g_new, g_new, sh))
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
    on CUDA and float64 on the CPU. Under ``sharding`` the device is the
    mesh's and ``value_and_grad`` follows the module note's contract."""

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
        self.sharding = check_sharding(sharding, 1)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.n = n
        self.history = history
        self.dtype = dtype
        self.operand = operand
        self._solve = make_lbfgs_solve(value_and_grad, history, convergence_threshold, max_iter,
                                       sharding=self.sharding)
        self._vg = value_and_grad

    def run(self, x0):
        """Returns ``(x, f, gnorm, iterations)``: ``x`` a tensor on the
        solver's device (gathered under sharding, from the global ``x0``).
        Raises FloatingPointError when f or the gradient norm is not
        finite."""
        x0 = vops.to_device(x0, self.dtype, self.device, self.sharding)
        f0, g0 = self._vg(x0, self.operand)
        m = self.history
        width = x0.shape[-1]
        like = dict(dtype=self.dtype, device=self.device)
        state = LBFGSState(
            x0, f0, g0, torch.zeros((m, width), **like), torch.zeros((m, width), **like),
            torch.zeros((m,), **like), 0, 0, torch.sqrt(_dot(g0, g0, self.sharding)),
        )
        final, iters = self._solve(state, self.operand)
        f, gnorm = float(final.f), float(final.gnorm)
        check_finite([f, gnorm], "FusedLBFGS")
        x = final.x if self.sharding is None else self.sharding.gather(final.x, self.n)
        return x, f, gnorm, int(iters)
