"""The port's LinearEquationsDavidson through create_linear_equations
against the JAX package's (test/itsolv/test_LinearEquations.cpp's cases:
multiple right-hand sides, the augmented-Hessian sweep), on the CPU in
float64: the same iteration count and stats, solutions within 1e-10.
"""

import numpy as np
import pytest
import torch

import iterative_solver_tpu as J
import iterative_solver_torch as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_system(n, nrhs, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    mat = a + a.T + np.diag(np.arange(5.0, n + 5.0))
    return mat, rng.standard_normal((nrhs, n))


def _solve(mod, mat, rhs, options="", threshold=1e-10, **kw):
    n, nrhs = mat.shape[0], rhs.shape[0]
    solver = mod.create_linear_equations(n, nrhs, "Davidson", options, **kw)
    solver.verbosity = mod.Verbosity.NONE
    solver.convergence_threshold = threshold
    solver.add_equations(rhs)
    conv, *_ = solver.solve(np.zeros((nrhs, n)), problem=mod.models.MatrixProblem(mat, **kw),
                            generate_initial_guess=True)
    x = solver.solution_params(list(range(nrhs)))
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return solver, conv, x


@pytest.mark.parametrize("nrhs", [1, 2, 3])
@pytest.mark.parametrize("n", [20, 96])
def test_multiple_rhs_match_jax(n, nrhs):
    mat, rhs = make_system(n, nrhs)
    js, jconv, jx = _solve(J, mat, rhs)
    ts, tconv, tx = _solve(T, mat, rhs, device="cpu")
    assert tconv and jconv
    assert str(ts.stats) == str(js.stats)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.errors, js.errors, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx, np.linalg.solve(mat, rhs.T).T, atol=1e-7)


@pytest.mark.parametrize("aughes", [0.0, 0.001, 0.01])
def test_augmented_hessian_matches_jax(aughes):
    mat, rhs = make_system(15, 1, seed=3)
    threshold = 1e-9 if aughes == 0.0 else 1e-4
    opts = f"augmented_hessian={aughes}"
    js, jconv, jx = _solve(J, mat, rhs, opts, threshold)
    ts, tconv, tx = _solve(T, mat, rhs, opts, threshold, device="cpu")
    assert tconv and jconv
    assert str(ts.stats) == str(js.stats)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert ts.subspace_solver.augmented_hessian == aughes


def test_options_string_matches_jax():
    mat, rhs = make_system(40, 2, seed=4)
    opts = "max_size_qspace=6,reset_D=3,norm_thresh=1e-9,svd_thresh=1e-11,hermiticity=1"
    js, _, jx = _solve(J, mat, rhs, opts)
    ts, _, tx = _solve(T, mat, rhs, opts, device="cpu")
    assert ts.max_size_qspace == js.max_size_qspace == 6
    assert ts.dspace_resetter.nreset == js.dspace_resetter.nreset == 3
    assert str(ts.stats) == str(js.stats)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)


def test_rhs_accessor_and_errors():
    mat, rhs = make_system(10, 2)
    ts = T.create_linear_equations(10, 2, device="cpu")
    ts.add_equations(torch.as_tensor(rhs))
    np.testing.assert_allclose(ts.rhs().numpy(), rhs, rtol=0, atol=0)
    assert ts.nroots == 2 and isinstance(ts, T.LinearEquationsDavidson)
    messages = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.create_linear_equations(8, 1, "GMRES", **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
