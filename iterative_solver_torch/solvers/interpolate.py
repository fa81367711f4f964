"""1-D cubic / Morse interpolation for the BFGS line search (port of
iterative_solver_tpu/solvers/interpolate.py).

Reference: src/molpro/linalg/itsolv/Interpolate.{h,cpp} — cubic closed-form
coefficients (Interpolate.cpp:56-66), analytic cubic minimisation, secant
refinement within a bracket, and a Morse interpolant fitted by running the
library's own DIIS nonlinear solver on a 4-parameter residual
(Interpolate.cpp:19-51).

Host Python apart from the Morse fit, whose DIIS solve runs on ``device``
(``None``: the CUDA device, raising without it; the tests pass "cpu").
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Point:
    x: float
    f: float = math.nan
    f1: float = math.nan
    f2: float = math.nan


def _morse_point(y: float, p: List[float]) -> Point:
    # np.exp overflows to inf like C++ std::exp rather than raising, which
    # lets the DIIS fit recover from wild intermediate parameters
    with np.errstate(over="ignore"):
        e = float(np.exp(-p[2] * (y - p[3])))
    f = p[0] + (p[1] / 2) * ((1 - e) / p[2]) ** 2
    f1 = (p[1] / p[2]) * e * (1 - e)
    f2 = -p[1] * (1 - 2 * e)
    return Point(y, f, f1, f2)


class Interpolate:
    def __init__(self, p0: Point, p1: Point, interpolant: str = "cubic", verbosity: int = 0,
                 device=None):
        self.p0 = p0
        self.p1 = p1
        self.interpolant = interpolant
        if interpolant == "cubic":
            # c0 + c1 (x-xbar) + c2 (x-xbar)^2 + c3 (x-xbar)^3, xbar midpoint
            dx = p1.x - p0.x
            f1pf0 = p1.f + p0.f
            f1mf0 = p1.f - p0.f
            g1pg0 = p1.f1 + p0.f1
            g1mg0 = p1.f1 - p0.f1
            self.parameters = [
                0.5 * f1pf0 - 0.125 * g1mg0 * dx,
                -0.25 * g1pg0 + 1.5 * f1mf0 / dx,
                0.5 * g1mg0 / dx,
                (-2 * f1mf0 + g1pg0 * dx) / dx**3,
            ]
        elif interpolant == "morse":
            cubic = Interpolate(p0, p1, "cubic", device=device)
            cubic_min = cubic.minimize(p0.x, p1.x)
            at_min = cubic(cubic_min.x)
            params = [at_min.f, at_min.f2, -3 * cubic.parameters[3] / at_min.f2, cubic_min.x]

            from ..problem import Problem
            from .nonlinear_diis import NonLinearEquationsDIIS

            outer_p0, outer_p1 = p0, p1

            class MorseProblem(Problem):
                def residual(self, parameters):
                    p = [float(v) for v in parameters.tolist()]
                    pp0 = _morse_point(outer_p0.x, p)
                    pp1 = _morse_point(outer_p1.x, p)
                    res = torch.tensor(
                        [pp0.f - outer_p0.f, pp1.f - outer_p1.f, pp0.f1 - outer_p0.f1, pp1.f1 - outer_p1.f1],
                        dtype=parameters.dtype, device=parameters.device,
                    )
                    return 0.0, res

                def precondition(self, residual, shift=None, diagonals=None):
                    return residual

            solver = NonLinearEquationsDIIS(4, device=device)
            solver.verbosity = verbosity
            converged, sol, _ = solver.solve(np.asarray(params), np.zeros(4), MorseProblem())
            if not converged:
                raise RuntimeError("Cannot find Morse interpolant")
            self.parameters = [float(v) for v in sol[0].tolist()]
        else:
            raise RuntimeError(f"Unknown interpolant: {interpolant}")

    @staticmethod
    def interpolants() -> List[str]:
        return ["cubic", "morse"]

    def __call__(self, x: float) -> Point:
        if self.interpolant == "cubic":
            c = self.parameters
            xbar = 0.5 * (self.p1.x + self.p0.x)
            t = x - xbar
            f = c[0] + t * (c[1] + t * (c[2] + t * c[3]))
            f1 = c[1] + t * (2 * c[2] + 3 * t * c[3])
            f2 = 2 * c[2] + 6 * t * c[3]
            return Point(x, f, f1, f2)
        return _morse_point(x, self.parameters)

    def minimize_cubic(self) -> Point:
        c = self.parameters[1]
        b = 2 * self.parameters[2]
        a = 3 * self.parameters[3]
        xbar = 0.5 * (self.p1.x + self.p0.x)
        if abs(a) <= 1e-12 * max(abs(b), abs(c) / max(abs(self.p1.x - self.p0.x), 1e-300)):
            # Degenerate (quadratic) interpolant — the reference's closed form
            # divides by zero here and silently skips the line search
            # (Interpolate.cpp:121-130); use the parabola vertex instead.
            if b > 0:
                return self(xbar - c / b)
            return Point(math.nan)
        disc = b * b / (4 * a * a) - c / a
        if math.isnan(disc) or disc < 0:
            return Point(math.nan)
        pm = self(xbar - b / (2 * a) + math.sqrt(disc))
        pp = self(xbar - b / (2 * a) - math.sqrt(disc))
        return pm if pm.f < pp.f else pp

    def minimize(
        self,
        xa: float,
        xb: float,
        bracket_grid: int = 100,
        max_bracket_grid: int = 100000,
        analytic: bool = True,
    ) -> Point:
        """Bracketed minimisation by grid scan + secant iteration
        (Interpolate.cpp:139-196)."""
        if xa > xb:
            xa, xb = xb, xa
        if analytic and self.interpolant == "cubic":
            return self.minimize_cubic()
        ngrid = bracket_grid
        while ngrid < max(bracket_grid, max_bracket_grid) + 1:
            gridstep = (xb - xa) / ngrid
            plow = self(xa)
            p0 = plow if self(xa).f > self(xb).f else self(xb)
            p1 = p0
            for _ in range(ngrid):
                phigh = self(plow.x + gridstep)
                if min(phigh.f, plow.f) < p0.f and plow.f1 <= 0 and phigh.f1 >= 0:
                    p1 = phigh
                    p0 = plow
                plow, phigh = phigh, plow
            if p0.f1 < 0 and p1.f1 > 0:
                pnew = p1
                tol = (np.nextafter(pnew.x, pnew.x + 1) - pnew.x) * 2
                while abs(p0.x - pnew.x) > tol:
                    pnew = self((p1.x * p0.f1 - p0.x * p1.f1) / (p0.f1 - p1.f1))
                    if pnew.f1 * p0.f1 < 0:
                        p0, p1 = p1, p0
                    p0, pnew = pnew, p0
                return p0
            ngrid *= 2
        return self(xb) if self(xa).f > self(xb).f else self(xa)
