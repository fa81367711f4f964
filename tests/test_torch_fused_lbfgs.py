"""The port's FusedLBFGS against the JAX package's (tests/test_fused_families.py
::TestFusedLBFGS's quadratic and Rosenbrock objectives, and a solve that
wraps the history ring), on the CPU in float64: the same iteration count,
solutions within 1e-10. Also float32 within 2 iterations, and a value and
gradient taken by autograd through the differentiable packed action.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers.fused_lbfgs import FusedLBFGS as JLBFGS
from iterative_solver_torch import FusedLBFGS as TLBFGS
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

_PREC = jax.lax.Precision.HIGHEST


def _quadratic_j(b):
    bj = jnp.asarray(b)

    def vg(x, operand):
        d = x - bj
        g = jnp.matmul(operand, d, precision=_PREC)
        return 0.5 * jnp.matmul(d, g), g

    return vg


def _quadratic_t(b):
    bt = torch.as_tensor(b)

    def vg(x, operand):
        d = x - bt.to(x.dtype)
        g = operand @ d
        return 0.5 * torch.dot(d, g), g

    return vg


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_vg_t(x, operand):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
        (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def _both(jvg, tvg, n, x0, operand=None, **kw):
    j = JLBFGS(jvg, n, operand=None if operand is None else jnp.asarray(operand), **kw)
    t = TLBFGS(tvg, n, operand=None if operand is None else torch.as_tensor(operand),
               device="cpu", **kw)
    jx, jf, jg, jit = j.run(x0)
    tx, tf, tg, tit = t.run(x0)
    return (np.asarray(jx), jf, jg, jit), (tx.numpy(), tf, tg, tit)


def test_quadratic_matches_jax():
    n = 50
    hess = np.diag(np.linspace(1.0, 20.0, n))
    b = np.ones(n)
    (jx, jf, jg, jit), (tx, tf, tg, tit) = _both(
        _quadratic_j(b), _quadratic_t(b), n, np.zeros(n), hess, history=10,
        convergence_threshold=1e-9)
    assert tit == jit
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert tg <= 1e-9 and abs(tf - jf) < 1e-12
    np.testing.assert_allclose(tx, b, atol=1e-7)


def test_rosenbrock_matches_jax():
    n = 8
    (jx, jf, jg, jit), (tx, tf, tg, tit) = _both(
        lambda x, op: (_rosen_j(x), jax.grad(_rosen_j)(x)), _rosen_vg_t, n, np.full(n, -0.5),
        history=10, convergence_threshold=1e-8, max_iter=2000)
    assert tit == jit
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx, np.ones(n), atol=1e-6)
    assert tf < 1e-12


def test_history_wrap_matches_jax():
    """History 3 against a solve of tens of iterations: the ring wraps, and
    the curvature test's branch decides each write as in JAX."""
    n = 40
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)) * 0.1
    hess = a @ a.T + np.diag(np.linspace(0.5, 30.0, n))
    b = rng.standard_normal(n)
    (jx, _, _, jit), (tx, _, tg, tit) = _both(
        _quadratic_j(b), _quadratic_t(b), n, np.zeros(n), hess, history=3,
        convergence_threshold=1e-10, max_iter=500)
    assert tit == jit and tit > 3
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx, b, atol=1e-8)


def test_float32_within_two_iterations_of_jax():
    n = 30
    hess = np.diag(np.linspace(1.0, 10.0, n))
    b = np.linspace(-1.0, 1.0, n)
    j = JLBFGS(_quadratic_j(b.astype(np.float32)), n, operand=jnp.asarray(hess, jnp.float32),
               dtype=jnp.float32, convergence_threshold=1e-4)
    t = TLBFGS(_quadratic_t(b), n, operand=torch.as_tensor(hess, dtype=torch.float32),
               dtype=torch.float32, convergence_threshold=1e-4, device="cpu")
    _, _, jg, jit = j.run(np.zeros(n))
    tx, _, tg, tit = t.run(np.zeros(n))
    assert tx.dtype == torch.float32 and tg <= 1e-4
    assert abs(tit - jit) <= 2


def test_gradient_through_differentiable_packed_action():
    """f = 1/2 xᵀ A x - bᵀ x with g from torch.autograd through
    make_differentiable_symm_action, as chip_smoke.py's solve_lbfgs takes it,
    against JAX's jax.value_and_grad through its twin: the same iterations
    and minimiser. At tol 1e-6: below about 1e-7 the Armijo test compares
    values of f that differ in their last bits, and the two autograd
    engines sum the gradient's two halves in another order."""
    from iterative_solver_tpu.ops.kernels import symm_pallas as jsymm
    from iterative_solver_torch.ops.kernels import symm as tsymm

    n, b_tile = 64, 16
    rng = np.random.default_rng(9)
    a = rng.standard_normal((n, n)) * 0.05
    mat = a + a.T + np.diag(np.linspace(1.0, 8.0, n))
    rhs = rng.standard_normal(n)

    jsym = jsymm.SymmetricBlocked.from_dense(mat, b=b_tile)
    jact = jsymm.make_differentiable_symm_action(jsym, use_pallas=False)
    bj = jnp.asarray(rhs)

    def jf(x, values):
        return 0.5 * jnp.dot(x, jact(x[None, :], values)[0]) - jnp.dot(bj, x)

    sym = tsymm.SymmetricBlocked.from_dense(mat, b=b_tile, device="cpu")
    action = tsymm.make_differentiable_symm_action(sym)
    bt = torch.as_tensor(rhs)

    def tvg(x, values):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = 0.5 * torch.dot(x, action(x[None, :], values)[0]) - torch.dot(bt, x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    jx, _, _, jit = JLBFGS(jax.value_and_grad(jf), n, operand=jsym.values,
                           convergence_threshold=1e-6).run(np.zeros(n))
    tx, _, tg, tit = TLBFGS(tvg, n, operand=sym.values, convergence_threshold=1e-6,
                            device="cpu").run(np.zeros(n))
    assert tit == jit and tg <= 1e-6
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), np.linalg.solve(mat, rhs), atol=1e-6)


def test_sharding_refused():
    # sharding= is ported (tests/test_torch_sharded_families.py) and takes a
    # parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        TLBFGS(_rosen_vg_t, 4, sharding=object(), device="cpu")
