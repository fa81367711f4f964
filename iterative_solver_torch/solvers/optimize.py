"""Optimisation solvers: L-BFGS (with Wolfe line search) and steepest descent
(port of iterative_solver_tpu/solvers/optimize.py).

Reference: src/molpro/linalg/itsolv/OptimizeBFGS.h:21-266 and OptimizeSD.h.
The two-loop recursion runs as host loops over the Q-space
parameter/action stacks on the device; Wolfe tests and the cubic line search
use the tiny host-side H/S/value matrices.

Rows are replaced in a copy of the caller's block (``_with_row``), never in
place: a block can share storage with what the caller keeps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import psum
from ..subspace.solvers import SubspaceSolverUnit
from .core import IterativeSolverTemplate, _rows
from .interpolate import Interpolate, Point

Tensor = torch.Tensor


def _with_row(block: Tensor, row: Tensor) -> Tensor:
    """A copy of ``block`` with row 0 replaced by ``row``."""
    out = block.clone()
    out[0] = row
    return out


def _pair_dots(z: Tensor, rows: Tensor, a: int, sharding) -> Tuple[Tensor, Tensor]:
    """(z.rows_a, z.rows_{a+1}), in one all-reduce under ``sharding``."""
    dots = psum(torch.stack([torch.dot(z, rows[a]), torch.dot(z, rows[a + 1])]), sharding)
    return dots[0], dots[1]


def _bfgs_forward(r: Tensor, q: Tensor, u: Tensor, denom: Tensor, sharding=None) -> tuple:
    """alpha_a = (r.q_a - r.q_{a+1})/denom_a; r -= alpha_a (u_a - u_{a+1});
    sequential over a (OptimizeBFGS.h:135-146). ``sharding``: the rows are
    this rank's slices and each step's two dots are all-reduced."""
    alphas = torch.zeros_like(denom)
    for a in range(denom.shape[0]):
        rq0, rq1 = _pair_dots(r, q, a, sharding)
        alpha = (rq0 - rq1) / denom[a]
        r = r - alpha * u[a] + alpha * u[a + 1]
        alphas[a] = alpha
    return r, alphas


def _bfgs_backward(z: Tensor, q: Tensor, u: Tensor, denom: Tensor, alphas: Tensor,
                   sharding=None) -> Tensor:
    """beta = (z.u_a - z.u_{a+1})/denom_a; z += (alpha_a - beta)(q_a - q_{a+1});
    reverse sweep (OptimizeBFGS.h:148-157), its dots as ``_bfgs_forward``'s."""
    for a in range(denom.shape[0] - 1, -1, -1):
        zu0, zu1 = _pair_dots(z, u, a, sharding)
        beta = (zu0 - zu1) / denom[a]
        coeff = alphas[a] - beta
        z = z + coeff * q[a] - coeff * q[a + 1]
    return z


class OptimizeBFGS(IterativeSolverTemplate):
    nonlinear = True
    linear_eigensystem = False

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverUnit(self.logger)
        self.max_size_qspace = np.iinfo(np.int32).max
        self.strong_wolfe = True
        self.wolfe_1 = 1e-4
        self.wolfe_2 = 0.9
        self.linesearch_tolerance = 0.2
        self.linesearch_grow_factor = 2.0
        self._alphas = np.zeros(0)
        self._linesearch = False
        self._last_iteration_linesearching = False

    # ------------------------------------------------------------------
    def add_vector(self, parameters: Tensor, actions: Tensor, value: Optional[float] = None):
        parameters = _rows(parameters)
        actions = _rows(actions)
        xs = self.xspace
        while xs.size >= self.max_size_qspace:
            xs.eraseq(xs.size - 1)
        # prepend current value (OptimizeBFGS.h:59-64)
        old_value = xs.value
        xs.value = np.zeros((xs.size + 1, 1))
        if xs.size > 0:
            xs.value[1:, 0] = old_value[:, 0]
        xs.value[0, 0] = value if value is not None else np.nan

        nwork, parameters, actions = super().add_vector(parameters, actions)

        h, s, val = xs.h, xs.s, xs.value
        if xs.size > 1:
            fprev, fcurrent = val[1, 0], val[0, 0]
            gprev = h[0, 1] - h[1, 1]
            gcurrent = h[0, 0] - h[1, 0]
            wolfe_1 = fcurrent <= fprev + self.wolfe_1 * gprev
            wolfe_2 = (
                gcurrent >= self.wolfe_2 * gprev
                if self.strong_wolfe
                else abs(gcurrent) <= self.wolfe_2 * abs(gprev)
            )
            if not (wolfe_1 and wolfe_2):
                inter = Interpolate(Point(-1, fprev, gprev), Point(0, fcurrent, gcurrent),
                                    device=self.device)
                pmin = inter.minimize(-1 - self.linesearch_grow_factor, self.linesearch_grow_factor)
                if abs(pmin.x) > self.linesearch_tolerance:
                    # take the line-search step: x <- (1+x) x_cur - x x_prev
                    self.logger.msg("Line search step taken", 4)
                    q1 = xs.store_v.get(xs.q_slots[1][0])
                    p0 = (1 + pmin.x) * parameters[0] - pmin.x * q1
                    parameters = _with_row(parameters, p0)
                    erased = 0 if fprev < fcurrent else 1
                    xs.eraseq(erased)
                    self._linesearch = True
                    return -1, parameters, actions

        # accept quasi-Newton step; drop redundant-curvature history rows
        # (OptimizeBFGS.h:123-130)
        self._linesearch = False
        while True:
            h = xs.h
            n_alpha = xs.size - 1
            erased_any = False
            for a in range(n_alpha):
                denom = h[a, a] - h[a, a + 1] - h[a + 1, a] + h[a + 1, a + 1]
                if abs(denom) < max(5e-14 * abs(h[a, a]), 1e-15):
                    xs.eraseq(a + 1)
                    self.logger.msg("Erase redundant Q", 4)
                    erased_any = True
                    break
            if not erased_any:
                break

        actions = self._bfgs_update_1(actions)
        return nwork, parameters, actions

    def _denominators(self) -> np.ndarray:
        h = self.xspace.h
        k = self.xspace.size - 1
        return np.asarray(
            [h[a, a] - h[a, a + 1] - h[a + 1, a] + h[a + 1, a + 1] for a in range(k)]
        )

    def _bfgs_update_1(self, actions: Tensor) -> Tensor:
        k = self.xspace.size - 1
        if k <= 0:
            self._alphas = np.zeros(0)
            return actions
        q = self.xspace.params_q()
        u = self.xspace.actions_q()
        denom = torch.as_tensor(self._denominators(), dtype=self.dtype, device=self.device)
        r, alphas = _bfgs_forward(actions[0], q, u, denom, self.sharding)
        self._alphas = alphas.cpu().numpy()
        return _with_row(actions, r)

    # ------------------------------------------------------------------
    def end_iteration(self, parameters: Tensor, actions: Tensor):
        self.working_set = [0]
        self._end_iteration_needed = False
        if not self._linesearch:
            self._last_iteration_linesearching = False
            sol = self.solution_params([0])
            parameters = _with_row(parameters, sol[0])
            if self.errors[0] < self.convergence_threshold:
                self.working_set = []
                self.stats.iterations += 1
                return 0, parameters, actions
            k = self.xspace.size - 1
            if k > 0 and self._alphas.size:
                q = self.xspace.params_q()
                u = self.xspace.actions_q()
                like = dict(dtype=self.dtype, device=self.device)
                denom = torch.as_tensor(self._denominators(), **like)
                z = _bfgs_backward(actions[0], q, u, denom,
                                   torch.as_tensor(self._alphas, **like), self.sharding)
            else:
                z = actions[0]
            parameters = _with_row(parameters, parameters[0] + (-z))
        else:
            self.stats.line_search_steps += 1
            if not self._last_iteration_linesearching:
                self.stats.line_searches += 1
            self._last_iteration_linesearching = True
        self.stats.iterations += 1
        nwork = 0 if self.errors[0] < self.convergence_threshold else 1
        return nwork, parameters, actions

    def set_value_errors(self) -> None:
        val = self.xspace.value
        self.value_errors = [np.finfo(np.float64).max]
        if self.xspace.size > 1 and val.shape[0] > 1 and val[0, 0] < val[1, 0]:
            self.value_errors[0] = val[1, 0] - val[0, 0]

    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        return actions

    def report(self, iteration: Optional[int] = None) -> None:
        super().report(iteration)
        print(
            f"value {self.value}, "
            + ("line-searching" if self._linesearch else "quasi-Newton step")
        )


class OptimizeSD(IterativeSolverTemplate):
    """Steepest descent: x <- x - precond(g) (OptimizeSD.h:20-106)."""

    nonlinear = True
    linear_eigensystem = False

    def __init__(self, n: int, nroots: int = 1, **kwargs):
        super().__init__(n, nroots, **kwargs)
        self.subspace_solver = SubspaceSolverUnit(self.logger)

    def add_vector(self, parameters: Tensor, actions: Tensor, value: Optional[float] = None):
        xs = self.xspace
        n = xs.dimensions.nX
        val = np.zeros((n + 1, 1))
        keep = min(n + 1, xs.value.shape[0])
        val[:keep, 0] = xs.value[:keep, 0]  # resize preserves overlap, like Matrix::resize
        val[0, 0] = value if value is not None else np.nan
        xs.value = val
        return super().add_vector(parameters, actions)

    def end_iteration(self, parameters: Tensor, actions: Tensor):
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

    def set_value_errors(self) -> None:
        val = self.xspace.value
        self.value_errors = [np.finfo(np.float64).max]
        if self.xspace.size > 1 and val.shape[0] > 1 and val[0, 0] < val[1, 0]:
            self.value_errors[0] = val[1, 0] - val[0, 0]

    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        return actions

    def report(self, iteration: Optional[int] = None) -> None:
        super().report(iteration)
        print(f"value {self.value}")
