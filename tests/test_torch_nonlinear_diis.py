"""The port's NonLinearEquationsDIIS through create_nonlinear_equations and
its Interpolate against the JAX package's
(test/itsolv/test_NonLinearEquations.cpp's quadratic and trigonometric
problems, test_Interpolate.cpp's cubic and Morse fits), on the CPU in
float64: the same iteration count and stats, solutions within 1e-10.
"""

import math

import numpy as np
import pytest
import torch

import iterative_solver_tpu as J
import iterative_solver_torch as T
from iterative_solver_tpu.solvers.interpolate import Interpolate as JInterpolate
from iterative_solver_tpu.solvers.interpolate import Point as JPoint
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def _quadratic(mod, n, eps=0.05):
    """r = A x + eps x^2 - b (tests/test_nonlinear_equations.py:11)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)) * 0.1
    mat = a + a.T + np.diag(np.arange(2.0, n + 2.0))
    b = rng.standard_normal(n)
    if mod is T:
        mat_t, b_t = torch.as_tensor(mat), torch.as_tensor(b)

        def residual(x):
            return 0.0, mat_t @ x + eps * x**2 - b_t

        diagonals = torch.as_tensor(np.diag(mat).copy())
    else:
        import jax.numpy as jnp

        mat_j, b_j = jnp.asarray(mat), jnp.asarray(b)

        def residual(x):
            return 0.0, mat_j @ x + eps * x**2 - b_j

        diagonals = jnp.asarray(np.diag(mat).copy())

    class Problem(mod.Problem):
        def __init__(self):
            super().__init__()
            self.dimension = n

        def residual(self, parameters):
            return residual(parameters)

        def diagonals(self):
            return diagonals

    return Problem(), mat, b


def _run(mod, problem, n, options=""):
    kw = {"device": "cpu"} if mod is T else {}
    solver = mod.create_nonlinear_equations(n, "DIIS", options, **kw)
    solver.verbosity = mod.Verbosity.NONE
    solver.convergence_threshold = 1e-8
    converged, x, _ = solver.solve(np.zeros((1, n)), problem=problem)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return solver, converged, x[0]


def _same(j, t):
    (js, jconv, jx), (ts, tconv, tx) = j, t
    assert jconv and tconv
    assert str(ts.stats) == str(js.stats)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert ts.xspace.dimensions.nQ == js.xspace.dimensions.nQ


@pytest.mark.parametrize("n", [3, 8, 30])
def test_quadratic_matches_jax(n):
    jp, mat, b = _quadratic(J, n)
    tp, _, _ = _quadratic(T, n)
    j, t = _run(J, jp, n, "max_size_qspace=8"), _run(T, tp, n, "max_size_qspace=8")
    _same(j, t)
    x = t[2]
    assert np.linalg.norm(mat @ x + 0.05 * x**2 - b) < 2e-8


@pytest.mark.parametrize("n", [5, 20])
def test_trig_matches_jax(n):
    j = _run(J, J.models.TrigNonlinearProblem(n), n)
    t = _run(T, T.models.TrigNonlinearProblem(n, device="cpu"), n)
    _same(j, t)
    _, res = T.models.TrigNonlinearProblem(n, device="cpu").residual(torch.as_tensor(t[2]))
    assert float(torch.linalg.norm(res)) < 2e-8


def test_max_size_qspace_cap_matches_jax():
    n = 30
    j = _run(J, J.models.TrigNonlinearProblem(n), n, "max_size_qspace=3")
    t = _run(T, T.models.TrigNonlinearProblem(n, device="cpu"), n, "max_size_qspace=3")
    _same(j, t)
    assert t[0].xspace.dimensions.nQ <= 4
    assert t[0].max_size_qspace == 3


def test_options_and_unknown_method():
    s = T.create_nonlinear_equations(6, "DIIS", "max_size_qspace=5,norm_thresh=1e-9,"
                                     "svd_thresh=1e-11", device="cpu")
    assert (s.max_size_qspace, s.norm_thresh, s.svd_thresh) == (5, 1e-9, 1e-11)
    with pytest.raises(ValueError, match="Unknown NonLinearEquations method"):
        T.create_nonlinear_equations(6, "Broyden", device="cpu")


def test_cubic_interpolant_matches_jax():
    f = lambda x: 1 + x + 0.5 * x**2 - 0.1 * x**3  # noqa: E731
    g = lambda x: 1 + x - 0.3 * x**2  # noqa: E731
    j = JInterpolate(JPoint(-1, f(-1), g(-1)), JPoint(0.5, f(0.5), g(0.5)), "cubic")
    t = T.Interpolate(T.Point(-1, f(-1), g(-1)), T.Point(0.5, f(0.5), g(0.5)), "cubic",
                      device="cpu")
    assert t.parameters == j.parameters
    for x in (-1.0, -0.2, 0.5, 1.7):
        assert t(x) == T.Point(*vars(j(x)).values())
    assert vars(t.minimize(-5, 5)) == vars(j.minimize(-5, 5))
    assert vars(t.minimize(-3, 3, analytic=False)) == vars(j.minimize(-3, 3, analytic=False))
    assert T.Interpolate.interpolants() == ["cubic", "morse"]


def test_morse_interpolant_matches_jax():
    """The Morse fit runs NonLinearEquationsDIIS(4) on the given device."""
    a, k = 0.7, 2.0
    f = lambda x: (k / (2 * a * a)) * (1 - math.exp(-a * (x - 0.3))) ** 2 + 0.1  # noqa: E731
    g = lambda x: (k / a) * math.exp(-a * (x - 0.3)) * (1 - math.exp(-a * (x - 0.3)))  # noqa: E731
    j = JInterpolate(JPoint(-0.5, f(-0.5), g(-0.5)), JPoint(1.0, f(1.0), g(1.0)), "morse")
    t = T.Interpolate(T.Point(-0.5, f(-0.5), g(-0.5)), T.Point(1.0, f(1.0), g(1.0)), "morse",
                      device="cpu")
    np.testing.assert_allclose(t.parameters, j.parameters, rtol=1e-10, atol=1e-12)
    pmin = t.minimize(-2, 2, analytic=False)
    assert abs(pmin.x - 0.3) < 1e-5 and abs(pmin.f - 0.1) < 1e-6
    assert abs(pmin.x - j.minimize(-2, 2, analytic=False).x) < 1e-10
