"""The port's Chebyshev filtering (iterative_solver_torch/solvers/chebyshev.py)
against the JAX package's, on tests/test_chebyshev.py's inputs, on the CPU
in float64.

Tolerances: the spectral bounds within 1e-10 of JAX's (the same Lanczos
start vector from ``default_rng(seed)``; sums in another order); the
filtered block within 1e-10 of JAX's relative to its size; equal iteration
and matvec counts, eigenvalues within 1e-10 of JAX's and 1e-8 of eigvalsh.
The JAX file's sharded-mesh case waits for ROADMAP.md Queue 1, item 6c.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_torch.solvers.chebyshev import (
    estimate_spectral_bounds,
    make_chebyshev_davidson,
    make_chebyshev_expand,
)
from iterative_solver_torch.solvers.fused_davidson import FusedDavidson
from iterative_solver_tpu.solvers import chebyshev as jcheb
from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson as JFused

_PREC = jax.lax.Precision.HIGHEST


def make_matrix(n, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.01
    return a + a.T + np.diag(np.linspace(1.0, spread, n))


def torch_matvec(x, mat):
    return torch.matmul(x, mat.T)


def jax_matvec(x, mat):
    return jnp.matmul(x, mat.T, precision=_PREC)


def initial_guess(matrix, nroots):
    n = matrix.shape[0]
    v0 = np.zeros((nroots, n))
    for row, i in enumerate(np.argsort(np.diag(matrix))[:nroots]):
        v0[row, i] = 1.0
    return v0


def test_spectral_bounds_contain_spectrum_and_match_jax():
    n = 80
    matrix = make_matrix(n, seed=1)
    w = np.linalg.eigvalsh(matrix)
    lo, hi = estimate_spectral_bounds(torch_matvec, n, operand=torch.as_tensor(matrix),
                                      device="cpu")
    assert lo <= w[0] + 1e-6
    assert hi >= w[-1] - 1e-6
    assert hi - lo <= 3.0 * (w[-1] - w[0])
    jlo, jhi = jcheb.estimate_spectral_bounds(jax_matvec, n, operand=jnp.asarray(matrix))
    np.testing.assert_allclose([lo, hi], [jlo, jhi], rtol=0, atol=1e-10)
    # another seed, iteration count and safety: still JAX's numbers
    got = estimate_spectral_bounds(torch_matvec, n, operand=torch.as_tensor(matrix),
                                   iters=7, seed=3, safety=1.2, device="cpu")
    ref = jcheb.estimate_spectral_bounds(jax_matvec, n, operand=jnp.asarray(matrix),
                                         iters=7, seed=3, safety=1.2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_filter_damps_unwanted_amplifies_wanted():
    """The hook on known eigenvector combinations: components above the
    filter edge shrink relative to those below; JAX's hook gives the same
    block. The inactive slots carry a huge padded value that must not
    become the filter edge."""
    n = 60
    matrix = make_matrix(n, seed=2)
    w, vecs = np.linalg.eigh(matrix)
    degree = 6
    lam_max = float(w[-1]) * 1.01
    x = (vecs[:, 0] + vecs[:, -1]).reshape(1, -1)
    nact = 21
    evals_all = np.concatenate([w[:nact], np.full(5, 1e6)])
    mask = np.asarray([1.0] * nact + [0.0] * 5)
    expand = make_chebyshev_expand(torch_matvec, degree, lambda_max=lam_max)
    t = expand(torch.as_tensor(x), None, torch.as_tensor(w[:1]), torch.as_tensor(evals_all),
               torch.as_tensor(mask), None, torch.as_tensor(matrix)).numpy()[0]
    wanted = abs(t @ vecs[:, 0])
    unwanted = abs(t @ vecs[:, -1])
    assert wanted > 1e3 * unwanted
    assert 0.1 < wanted < 10.0
    jexpand = jcheb.make_chebyshev_expand(jax_matvec, degree, lambda_max=lam_max)
    ref = np.asarray(jexpand(jnp.asarray(x), None, jnp.asarray(w[:1]), jnp.asarray(evals_all),
                             jnp.asarray(mask), None, jnp.asarray(matrix)))[0]
    np.testing.assert_allclose(t, ref, atol=1e-10 * np.abs(ref).max())
    # lambda_min floors the scaling point as in JAX
    lmin = float(w[0]) + 0.5
    got = make_chebyshev_expand(torch_matvec, 3, lam_max, lambda_min=lmin)(
        torch.as_tensor(x), None, torch.as_tensor(w[:1]), torch.as_tensor(evals_all),
        torch.as_tensor(mask), None, torch.as_tensor(matrix)).numpy()
    ref = np.asarray(jcheb.make_chebyshev_expand(jax_matvec, 3, lam_max, lambda_min=lmin)(
        jnp.asarray(x), None, jnp.asarray(w[:1]), jnp.asarray(evals_all), jnp.asarray(mask),
        None, jnp.asarray(matrix)))
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max())
    with pytest.raises(ValueError, match="degree"):
        make_chebyshev_expand(torch_matvec, 0, lam_max)


def test_full_rr_hands_the_hook_jax_inputs(monkeypatch):
    """The rr="full" step hands the expand hook the same evals_all and mask
    as JAX's, including the padded inactive slots (a padded value that
    leaked into the filter edge would change the filter silently)."""
    n, nroots = 96, 3
    matrix = make_matrix(n, seed=3)
    seen = {"port": [], "jax": []}

    def port_hook(x, r, evals, evals_all, mask, diag, operand):
        seen["port"].append((evals.numpy(), evals_all.numpy(), mask.numpy()))
        return r

    def jax_hook(x, r, evals, evals_all, mask, diag, operand):
        # the JAX step is traced: read its values through a debug callback
        jax.debug.callback(lambda *a: seen["jax"].append(tuple(map(np.asarray, a))),
                           evals, evals_all, mask)
        return r

    tp = FusedDavidson(torch_matvec, np.diag(matrix), n, nroots, m_max=12, max_iter=6,
                       operand=torch.as_tensor(matrix), expand=port_hook, device="cpu")
    tp.run(initial_guess(matrix, nroots))
    jp = JFused(jax_matvec, np.diag(matrix), n, nroots, m_max=12, max_iter=6,
                operand=jnp.asarray(matrix), expand=jax_hook)
    jp.run(initial_guess(matrix, nroots))
    jax.effects_barrier()
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for (pe, pa, pm), (je, ja, jm) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_allclose(pe, je, atol=1e-10)
        live = jm > 0
        np.testing.assert_allclose(pa[live], ja[live], atol=1e-10)
        # the inactive slots are padded above every active value in both
        assert np.all(pa[~live] > pa[live].max()) and np.all(ja[~live] > ja[live].max())


@pytest.mark.parametrize("nroots", [1, 3])
@pytest.mark.parametrize("driver", ["run", "run_on_device"])
def test_chebyshev_davidson_matches_dense_and_jax(nroots, driver):
    n = 96
    matrix = make_matrix(n, seed=3)
    kw = dict(nroots=nroots, degree=4, m_max=20)
    port = make_chebyshev_davidson(torch_matvec, np.diag(matrix), n,
                                   operand=torch.as_tensor(matrix), device="cpu", **kw)
    evals, x, errors, iters = getattr(port, driver)(initial_guess(matrix, nroots))
    ref = jcheb.make_chebyshev_davidson(jax_matvec, np.diag(matrix), n,
                                        operand=jnp.asarray(matrix), **kw)
    jevals, _, _, jiters = getattr(ref, driver)(initial_guess(matrix, nroots))
    np.testing.assert_allclose(evals, np.linalg.eigvalsh(matrix)[:nroots], atol=1e-8)
    np.testing.assert_allclose(evals, np.asarray(jevals), atol=1e-10)
    assert np.all(errors <= port.tol)
    assert int(iters) == int(jiters)
    # the matvec accounting counts the degree extra applications
    assert port.matvecs == nroots + iters * nroots * 4 == ref.matvecs


def test_chebyshev_beats_jacobi_on_flat_diagonal():
    """On a matrix whose diagonal carries no information the Jacobi
    preconditioner stalls; the filter converges in far fewer subspace
    iterations. Both solves take JAX's iteration counts."""
    n = 128
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.linspace(1.0, 50.0, n)
    matrix = (q * w) @ q.T
    v0 = rng.standard_normal((2, n))
    mt, mj = torch.as_tensor(matrix), jnp.asarray(matrix)

    jac = FusedDavidson(torch_matvec, np.diag(matrix), n, 2, m_max=16, max_iter=300,
                        operand=mt, device="cpu")
    jac.run(v0)
    jjac = JFused(jax_matvec, np.diag(matrix), n, 2, m_max=16, max_iter=300, operand=mj)
    jjac.run(v0)
    # Jacobi stalls here for over 200 iterations, and the two packages'
    # errors drift apart by about 1e-3 of themselves over that run: at
    # iteration 229 the larger error reads 1.0071e-8 (port) and 0.9933e-8
    # (JAX) against the tolerance of 1e-8, so the port stops one iteration
    # later. Up to that stop the counts are equal; within 2 is the bound.
    assert abs(jac.iterations - jjac.iterations) <= 2

    cheb = make_chebyshev_davidson(torch_matvec, np.diag(matrix), n, nroots=2, degree=8,
                                   m_max=16, max_iter=300, operand=mt, device="cpu")
    evals, _, errors, iters = cheb.run(v0)
    jcheb_solver = jcheb.make_chebyshev_davidson(jax_matvec, np.diag(matrix), n, nroots=2,
                                                 degree=8, m_max=16, max_iter=300, operand=mj)
    jevals, _, _, jiters = jcheb_solver.run(v0)
    np.testing.assert_allclose(evals, np.linalg.eigvalsh(matrix)[:2], atol=1e-8)
    np.testing.assert_allclose(evals, np.asarray(jevals), atol=1e-10)
    assert np.all(errors <= cheb.tol)
    assert iters == jiters
    assert iters < jac.iterations / 2


def test_chebyshev_on_device_single_dispatch():
    n = 64
    matrix = make_matrix(n, seed=5)
    kw = dict(nroots=2, degree=3, m_max=12)
    port = make_chebyshev_davidson(torch_matvec, np.diag(matrix), n,
                                   operand=torch.as_tensor(matrix), device="cpu", **kw)
    evals, x, errors, iters = port.run_on_device(initial_guess(matrix, 2))
    ref = jcheb.make_chebyshev_davidson(jax_matvec, np.diag(matrix), n,
                                        operand=jnp.asarray(matrix), **kw)
    jevals, _, _, jiters = ref.run_on_device(initial_guess(matrix, 2))
    np.testing.assert_allclose(evals, np.linalg.eigvalsh(matrix)[:2], atol=1e-8)
    np.testing.assert_allclose(evals, np.asarray(jevals), atol=1e-10)
    assert np.all(errors <= port.tol)
    assert int(iters) == int(jiters)


def test_chebyshev_refuses_window_rr_and_takes_given_bounds(monkeypatch):
    matrix = make_matrix(32, seed=6)
    with pytest.raises(ValueError, match="rr='full'"):
        make_chebyshev_davidson(torch_matvec, np.diag(matrix), 32, nroots=1, rr="window",
                                operand=torch.as_tensor(matrix), device="cpu")
    # given bounds: no Lanczos run
    calls = []
    monkeypatch.setattr("iterative_solver_torch.solvers.chebyshev.estimate_spectral_bounds",
                        lambda *a, **k: calls.append(1))
    s = make_chebyshev_davidson(torch_matvec, np.diag(matrix), 32, nroots=1, lambda_max=20.0,
                                operand=torch.as_tensor(matrix), device="cpu")
    assert not calls and s.matvecs_per_direction == 4 and s.expand is not None
