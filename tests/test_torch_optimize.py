"""The port's OptimizeBFGS and OptimizeSD through create_optimize against the
JAX package's (test/itsolv/test_Optimize.cpp's quadratic form, the stiff
line-search case, the Rayleigh quotient), on the CPU in float64: the same
iteration count and stats, solutions within 1e-10.
"""

import numpy as np
import pytest
import torch

import iterative_solver_tpu as J
import iterative_solver_torch as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_hessian(n, rho=0.1):
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return np.where(i == j, i + 1.0, rho * (1.0 / (1.0 + abs(i - j))))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kw(mod):
    return {"device": "cpu"} if mod is T else {}


def _run(mod, method, problem, n, options="", threshold=1e-10, max_iter=None, x0=None):
    solver = mod.create_optimize(n, method, options, **_kw(mod))
    solver.verbosity = mod.Verbosity.NONE
    solver.convergence_threshold = threshold
    if max_iter is not None:
        solver.max_iter = max_iter
    x0 = np.zeros((1, n)) if x0 is None else x0
    converged, x, _ = solver.solve(x0, problem=problem)
    return solver, converged, _host(x)[0]


def _same(js, jconv, jx, ts, tconv, tx):
    assert jconv and tconv
    assert str(ts.stats) == str(js.stats)
    assert ts.stats.line_searches == js.stats.line_searches
    assert ts.stats.line_search_steps == js.stats.line_search_steps
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert ts.value == pytest.approx(js.value, abs=1e-12)


@pytest.mark.parametrize("n", [2, 5, 20])
@pytest.mark.parametrize("method", ["BFGS", "SD"])
def test_quadratic_matches_jax(method, n):
    hess = make_hessian(n, 0.1 if method == "BFGS" else 0.01)
    b = np.linspace(0.5, 1.5, n)
    opts = "max_size_qspace=8" if method == "BFGS" else ""
    js, jconv, jx = _run(J, method, J.models.QuadraticOptimizeProblem(hess, b), n, opts,
                         max_iter=300)
    ts, tconv, tx = _run(T, method, T.models.QuadraticOptimizeProblem(hess, b, device="cpu"),
                         n, opts, max_iter=300)
    _same(js, jconv, jx, ts, tconv, tx)
    np.testing.assert_allclose(tx, b, atol=1e-7)


class NoPrecond:
    """Identity preconditioner: forces the BFGS line search
    (tests/test_optimize.py:31)."""

    @staticmethod
    def wrap(mod, inner):
        class Wrapped(mod.Problem):
            def __init__(self):
                super().__init__()
                self.dimension = inner.dimension

            def residual(self, p):
                return inner.residual(p)

            def precondition(self, residual, shift=None, diagonals=None):
                return residual

        return Wrapped()


def test_stiff_line_search_matches_jax():
    n = 10
    hess = np.diag(np.logspace(0, 3, n))
    jp = NoPrecond.wrap(J, J.models.QuadraticOptimizeProblem(hess, np.ones(n)))
    tp = NoPrecond.wrap(T, T.models.QuadraticOptimizeProblem(hess, np.ones(n), device="cpu"))
    js, jconv, jx = _run(J, "BFGS", jp, n, threshold=1e-8, max_iter=200)
    ts, tconv, tx = _run(T, "BFGS", tp, n, threshold=1e-8, max_iter=200)
    assert js.stats.line_searches > 0
    _same(js, jconv, jx, ts, tconv, tx)
    np.testing.assert_allclose(tx, np.ones(n), atol=1e-6)


def test_rayleigh_quotient_matches_jax():
    """The Rayleigh quotient of a seeded synthetic matrix (not the
    hamiltonian files) through BFGS and SD; the value is the lowest
    eigenvalue."""
    n = 40
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)) * 0.05
    matrix = a + a.T + np.diag(np.linspace(-1.0, 6.0, n))
    x0 = np.zeros((1, n))
    x0[0, int(np.argmin(np.diag(matrix)))] = 1.0
    e0 = np.linalg.eigvalsh(matrix)[0]
    for method in ("BFGS", "SD"):
        js, jconv, jx = _run(J, method, J.models.RayleighQuotientProblem(matrix), n,
                             threshold=1e-7, max_iter=500, x0=x0)
        ts, tconv, tx = _run(T, method, T.models.RayleighQuotientProblem(matrix, device="cpu"),
                             n, threshold=1e-7, max_iter=500, x0=x0)
        _same(js, jconv, jx, ts, tconv, tx)
        assert abs(ts.value - e0) < 1e-8


def test_options_round_trip_matches_jax():
    opts = ("max_size_qspace=4,convergence_threshold=1e-9,max_iter=50,strong_Wolfe=0,"
            "Wolfe_1=0.001,Wolfe_2=0.5,linesearch_tolerance=0.1,linesearch_grow_factor=3")
    js = J.create_optimize(5, "BFGS", opts)
    ts = T.create_optimize(5, "BFGS", opts, device="cpu")
    for name in ("max_size_qspace", "convergence_threshold", "max_iter", "strong_wolfe",
                 "wolfe_1", "wolfe_2", "linesearch_tolerance", "linesearch_grow_factor"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.max_size_qspace == 4 and ts.strong_wolfe is False
    sd = T.create_optimize(5, "SD", "max_iter=7", device="cpu")
    assert isinstance(sd, T.OptimizeSD) and sd.max_iter == 7
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Unknown Optimize method"):
            mod.create_optimize(5, "CG", **kw)


def test_rows_are_replaced_in_a_copy():
    """end_iteration never writes into the caller's block."""
    n = 6
    solver = T.create_optimize(n, "SD", device="cpu")
    solver.verbosity = T.Verbosity.NONE
    problem = T.models.QuadraticOptimizeProblem(make_hessian(n), device="cpu")
    x = torch.zeros((1, n), dtype=torch.float64)
    _, g = problem.residual(x[0])
    _, p, a = solver.add_vector(x, g[None, :], 0.0)
    before = p.clone()
    solver.end_iteration(p, a)
    assert torch.equal(p, before)


@pytest.mark.parametrize("method", ["BFGS", "SD"])
def test_checkpoint_written_by_jax_loads(tmp_path, method):
    """A nonlinear parity solver saved mid-solve by the JAX package loads in
    the port with its subspace, values, BFGS history coefficients and stats."""
    from iterative_solver_tpu.utils import checkpoint as JC
    from iterative_solver_torch.utils import checkpoint as TC

    n = 12
    hess = make_hessian(n)
    js = J.create_optimize(n, method, "max_size_qspace=5")
    js.verbosity = J.Verbosity.NONE
    js.solve(np.zeros((1, n)), problem=J.models.QuadraticOptimizeProblem(hess), max_iter=3)
    path = str(tmp_path / f"{method}.npz")
    JC.save_checkpoint(js, path)
    loaded = TC.load_checkpoint(path, device="cpu")
    assert type(loaded).__name__ == type(js).__name__
    np.testing.assert_array_equal(loaded.xspace.h, js.xspace.h)
    np.testing.assert_array_equal(loaded.xspace.value, js.xspace.value)
    np.testing.assert_array_equal(loaded.xspace.params_q().numpy(),
                                  np.asarray(js.xspace.params_q()))
    assert str(loaded.stats) == str(js.stats)
    if method == "BFGS":
        assert loaded.max_size_qspace == 5
        np.testing.assert_array_equal(loaded._alphas, np.asarray(js._alphas))
