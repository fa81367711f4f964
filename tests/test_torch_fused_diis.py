"""The port's FusedDIIS against the JAX package's (tests/test_fused_diis.py's
trigonometric and quadratic residuals, the ring wrap, exactly parallel
residuals, a converged start, float32), on the CPU: in float64 the same
iteration count and solutions within 1e-10; in float32 within 2
iterations. Also a NaN residual raises and a history below 2 is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers.fused_diis import FusedDIIS as JDIIS
from iterative_solver_torch import FusedDIIS as TDIIS
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

_PREC = jax.lax.Precision.HIGHEST


def _trig_operand(n, seed=42):
    rng = np.random.default_rng(seed)
    return 0.3 + 0.2 * rng.random(n), rng.standard_normal(n)


def _trig_j(x, operand):
    a, b = operand
    return x + a * jnp.sin(x) - b


def _trig_t(x, operand):
    a, b = operand
    return x + a * torch.sin(x) - b


def _quad_operand(n, eps=0.05, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    return a + a.T + np.diag(np.arange(2.0, n + 2.0)), eps, rng.standard_normal(n)


def _quad_j(x, operand):
    mat, eps, b = operand
    return jnp.matmul(mat, x, precision=_PREC) + eps * x**2 - b


def _quad_t(x, operand):
    mat, eps, b = operand
    return mat @ x + eps * x**2 - b


def _ops(operand, dtype=np.float64):
    j = tuple(jnp.asarray(np.asarray(o, dtype=dtype)) for o in operand)
    t = tuple(torch.as_tensor(np.asarray(o, dtype=dtype)) for o in operand)
    return j, t


def _both(jfn, tfn, operand, n, x0=None, **kw):
    jo, to = _ops(operand)
    x0 = np.zeros(n) if x0 is None else x0
    jx, jerr, jit = JDIIS(jfn, n, operand=jo, **kw).run(x0)
    tx, terr, tit = TDIIS(tfn, n, operand=to, device="cpu", **kw).run(x0)
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float64
    return (np.asarray(jx), jerr, jit), (tx.numpy(), terr, tit)


@pytest.mark.parametrize("n", [5, 20, 100])
def test_trig_matches_jax(n):
    (jx, jerr, jit), (tx, terr, tit) = _both(_trig_j, _trig_t, _trig_operand(n), n,
                                             convergence_threshold=1e-10)
    assert tit == jit and tit < 30
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert terr < 1e-10


@pytest.mark.parametrize("n", [8, 30])
def test_quadratic_with_jacobi_matches_jax(n):
    operand = _quad_operand(n)
    (jx, _, jit), (tx, terr, tit) = _both(_quad_j, _quad_t, operand, n,
                                          diagonals=np.diagonal(operand[0]),
                                          convergence_threshold=1e-10, max_size_qspace=8)
    assert tit == jit
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    mat, eps, b = operand
    assert np.linalg.norm(mat @ tx + eps * tx**2 - b) < 2e-10


def test_ring_wrap_matches_jax():
    n = 40
    (jx, _, jit), (tx, terr, tit) = _both(_trig_j, _trig_t, _trig_operand(n, seed=7), n,
                                          max_size_qspace=3, convergence_threshold=1e-10,
                                          max_iter=200)
    assert tit == jit and tit > 3
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10)
    assert terr < 1e-10


def test_parallel_residuals_extrapolate_exactly():
    """A linear residual r = 1e-3 (x - b) makes successive residuals exactly
    parallel; only the bordered solve extrapolates (plain fixed point would
    take ~23000 iterations). Held to the JAX test's own bounds, not to its
    iteration count: the exact extrapolation takes coefficients (-999,
    1000) from an eigh whose kept spectrum spans 5e-7 to 2.4, and the two
    packages' LAPACK eigh differ there by 6e-10 in c, so the error after the
    second step is 1.8e-16 in JAX and 1.3e-12 in the port, one side of the
    1e-12 tolerance each (JAX 2 iterations, the port 3)."""
    n = 10
    b = np.linspace(0.5, 1.5, n)
    jx, _, jit = JDIIS(lambda x, op: 1e-3 * (x - op), n, operand=jnp.asarray(b),
                       convergence_threshold=1e-12, max_iter=50).run(np.zeros(n))
    tx, terr, tit = TDIIS(lambda x, op: 1e-3 * (x - op), n, operand=torch.as_tensor(b),
                          convergence_threshold=1e-12, max_iter=50, device="cpu").run(np.zeros(n))
    assert jit <= 5 and tit <= 5 and terr < 1e-12
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tx.numpy(), b, atol=1e-9)


def test_converged_start_takes_zero_iterations():
    n = 12
    _, to = _ops(_trig_operand(n, seed=3))
    solver = TDIIS(_trig_t, n, operand=to, convergence_threshold=1e-11, device="cpu")
    x, _, _ = solver.run(np.zeros(n))
    x2, err2, iters2 = solver.run(x)
    assert iters2 == 0 and err2 < 1e-11
    assert torch.equal(x2, x)


def test_float32_within_two_iterations_of_jax():
    n = 30
    a, b = _trig_operand(n, seed=5)
    jo, to = _ops((a, b), np.float32)
    _, jerr, jit = JDIIS(_trig_j, n, operand=jo, dtype=jnp.float32,
                         convergence_threshold=2e-6, max_iter=100).run(np.zeros(n))
    tx, terr, tit = TDIIS(_trig_t, n, operand=to, dtype=torch.float32,
                          convergence_threshold=2e-6, max_iter=100, device="cpu").run(np.zeros(n))
    assert tx.dtype == torch.float32 and terr < 2e-6
    assert abs(tit - jit) <= 2


def test_nan_residual_raises():
    n = 6

    def residual(x, operand):
        return x - 1.0 + (float("nan") if bool(torch.any(x != 0)) else 0.0)

    with pytest.raises(FloatingPointError, match="FusedDIIS"):
        TDIIS(residual, n, device="cpu").run(np.zeros(n))


def test_rejects_tiny_history_and_sharding():
    with pytest.raises(ValueError, match=">= 2"):
        TDIIS(_trig_t, 4, max_size_qspace=1, device="cpu")
    # sharding= is ported (tests/test_torch_sharded_families.py) and takes a
    # parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        TDIIS(_trig_t, 4, sharding=object(), device="cpu")


def test_clipped_pulay_solve_matches_jax():
    """The extrapolation coefficients alone, on an overlap matrix with an
    empty slot and two nearly parallel residuals, in float64 and float32."""
    from iterative_solver_tpu.solvers.fused_diis import _clipped_pulay_solve as jsolve
    from iterative_solver_torch.solvers.fused_diis import _clipped_pulay_solve as tsolve

    rng = np.random.default_rng(4)
    r = rng.standard_normal((4, 9))
    near = r.copy()
    near[3] = r[2] * 1.01 + 0.01 * rng.standard_normal(9)
    valid = np.array([True, True, True, True, False])
    # float32 on independent residuals: the nearly parallel pair's
    # condition (about 1e4) leaves f32 coefficients ~1e-3 apart
    for rows, dtype, thresh, tol in ((near, np.float64, 1e-12, 1e-10),
                                     (r, np.float32, 1e-6, 2e-5)):
        b = np.zeros((5, 5))
        b[:4, :4] = rows @ rows.T
        cj = np.asarray(jsolve(jnp.asarray(b.astype(dtype)), jnp.asarray(valid), thresh))
        ct = tsolve(torch.as_tensor(b.astype(dtype)), torch.as_tensor(valid), thresh).numpy()
        assert ct[4] == 0
        np.testing.assert_allclose(ct, cj, rtol=0, atol=tol * max(1.0, np.abs(cj).max()))
        assert abs(ct.sum() - 1) < 10 * tol
