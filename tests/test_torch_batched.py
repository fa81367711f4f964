"""The port's make_batched_davidson_solve against the JAX package's, on the
CPU in float64, on examples/batched_scan.py's inputs: 6 points of a
coupling scan, n=256, 3 roots, m_max 18, couplings 0.1/sqrt(n), diagonal
linspace(0, 12, n), tol 1e-9.

Per element: the same iteration count, eigenvalues and residual norms
within 1e-10 of JAX's batched solve, and the same result as that element
solved alone by the chunked solve (the batch is independent systems).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import fused_davidson as J
from iterative_solver_torch.solvers import fused_davidson as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, NROOTS, M_MAX, POINTS = 256, 3, 18, 6


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N, N)) * (0.1 / np.sqrt(N))
    base = base + base.T
    mats = np.stack([lam * base + np.diag(np.linspace(0.0, 12.0, N))
                     for lam in np.linspace(0.2, 1.2, POINTS)])
    diags = np.stack([np.diag(m) for m in mats])
    v0 = np.zeros((POINTS, NROOTS, N))
    for p in range(POINTS):
        v0[p, np.arange(NROOTS), np.argsort(diags[p])[:NROOTS]] = 1.0
    return mats, diags, v0


def _jax_matvec(x, op):
    return jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST)


def _torch_matvec(x, op):
    return torch.matmul(x, op.T)


def _solve_both(scan, rr):
    mats, diags, v0 = scan
    jinit, jsolve = J.make_batched_davidson_solve(_jax_matvec, NROOTS, M_MAX, rr=rr)
    jfinal, jiters = jsolve(jinit(jnp.asarray(v0), jnp.asarray(mats)), jnp.asarray(mats),
                            jnp.asarray(diags), 1e-9, 800)
    tinit, tsolve = T.make_batched_davidson_solve(_torch_matvec, NROOTS, M_MAX, rr=rr)
    tm = torch.as_tensor(mats)
    tfinal, titers = tsolve(tinit(torch.as_tensor(v0), tm), tm, torch.as_tensor(diags),
                            1e-9, 800)
    return jfinal, jiters, tfinal, titers


@pytest.mark.parametrize("rr", ["full", "window", "window3", "anchored"])
def test_batched_matches_jax(scan, rr):
    mats = scan[0]
    jfinal, jiters, tfinal, titers = _solve_both(scan, rr)
    assert titers.dtype == torch.int64 and titers.shape == (POINTS,)
    np.testing.assert_array_equal(titers.numpy(), np.asarray(jiters))
    np.testing.assert_allclose(tfinal.evals.numpy(), np.asarray(jfinal.evals), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tfinal.errors.numpy(), np.asarray(jfinal.errors), rtol=0,
                               atol=1e-10)
    assert tfinal.k == tuple(int(k) for k in np.asarray(jfinal.k))
    for p in range(POINTS):
        assert tfinal.errors[p].max() < 1e-9
        ref = np.linalg.eigvalsh(mats[p])[:NROOTS]
        np.testing.assert_allclose(np.sort(tfinal.evals[p].numpy()), ref, atol=1e-8)


def test_iterations_quantised_to_the_sweep(scan):
    _, _, _, titers = _solve_both(scan, "full")
    fill = (M_MAX - NROOTS) // NROOTS
    assert np.all(titers.numpy() % fill == 0)
    assert len(set(titers.tolist())) > 1  # the elements stop at their own counts


def test_each_element_equals_its_own_solve(scan):
    """Converged elements hold their state: every element ends where the
    chunked solve of that system alone ends."""
    mats, diags, v0 = scan
    tinit, tsolve = T.make_batched_davidson_solve(_torch_matvec, NROOTS, M_MAX)
    tm = torch.as_tensor(mats)
    final, iters = tsolve(tinit(torch.as_tensor(v0), tm), tm, torch.as_tensor(diags), 1e-9,
                          800)
    init = T.make_davidson_init(_torch_matvec, NROOTS, M_MAX)
    solve = T.make_davidson_solve_chunked(_torch_matvec, NROOTS, M_MAX)
    for p in range(POINTS):
        single, it = solve(init(torch.as_tensor(v0[p]), tm[p]), tm[p],
                           torch.as_tensor(diags[p]), 1e-9, 800)
        assert it == int(iters[p])
        np.testing.assert_allclose(final.evals[p].numpy(), single.evals.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(final.errors[p].numpy(), single.errors.numpy(), rtol=0,
                                   atol=1e-12)


def test_max_iter_bounds_every_element(scan):
    mats, diags, v0 = scan
    tinit, tsolve = T.make_batched_davidson_solve(_torch_matvec, NROOTS, M_MAX)
    tm = torch.as_tensor(mats)
    state = tinit(torch.as_tensor(v0), tm)
    v_before = state.v.clone()
    final, iters = tsolve(state, tm, torch.as_tensor(diags), 1e-9, 5)
    assert np.all(iters.numpy() == 5)  # one sweep of 5 steps
    assert torch.equal(state.v, v_before)  # the input state is not written


def test_batched_rejects_a_small_basis():
    with pytest.raises(ValueError, match="m_max"):
        T.make_batched_davidson_solve(_torch_matvec, 4, 7)
