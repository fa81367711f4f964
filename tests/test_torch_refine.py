"""The port's EigenpairRefiner (iterative_solver_torch/solvers/refine.py)
against the JAX package's, on the CPU with the same operator and start.

With the correction solves in float64 in both packages the two take the
same steps: the same passes, residual histories within 1e-10. With a
float32 device carrier (the emulation of a device tier that
tests/test_refine.py uses) the port alone must break the f32 floor and
reach 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import refine as J
from iterative_solver_torch.solvers import refine as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_gapped(n, nroots, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (noise / np.sqrt(n))
    d = np.concatenate([np.linspace(-2.0, 0.5, nroots), np.linspace(2.0, 30.0, n - nroots)])
    return a + a.T + np.diag(d)


def _start(m, r, eps=1e-4, seed=1):
    refv = np.linalg.eigh(m)[1][:, :r].T
    return refv + eps * np.random.default_rng(seed).standard_normal(refv.shape)


def _jmv(v, op):
    return jnp.matmul(v, op.T, precision=jax.lax.Precision.HIGHEST)


def _tmv(v, op):
    return torch.matmul(v.to(op.dtype), op.T).to(v.dtype)


@pytest.mark.parametrize("inner_tol", [1e-3, 1e-6])
def test_matches_jax(inner_tol):
    n, r = 384, 6
    m = make_gapped(n, r)
    x0 = _start(m, r)
    jr = J.EigenpairRefiner(lambda x: x @ m.T, _jmv, jnp.asarray(m), np.diag(m), n, r,
                            inner_tol=inner_tol)
    tr = T.EigenpairRefiner(lambda x: x @ m.T, _tmv, torch.as_tensor(m), np.diag(m), n, r,
                            inner_tol=inner_tol, device="cpu")
    jo, to = jr.refine(x0, tol=1e-12, max_passes=5), tr.refine(x0, tol=1e-12, max_passes=5)
    assert to.converged == jo.converged and to.converged
    assert to.passes == jo.passes
    np.testing.assert_allclose(to.history, jo.history, rtol=0, atol=1e-10)
    np.testing.assert_allclose(to.eigenvalues, jo.eigenvalues, rtol=0, atol=1e-10)
    np.testing.assert_allclose(to.residual_norms, jo.residual_norms, rtol=0, atol=1e-10)
    np.testing.assert_allclose(to.eigenvalues, np.linalg.eigvalsh(m)[:r], atol=1e-12)


def test_reaches_1e10_from_f32_floor():
    n, r = 384, 6
    m = make_gapped(n, r)
    tr = T.EigenpairRefiner(lambda x: x @ m.T, _tmv, torch.as_tensor(m, dtype=torch.float32),
                            np.diag(m), n, r, dtype=torch.float32, inner_tol=1e-3,
                            device="cpu")
    out = tr.refine(torch.as_tensor(_start(m, r)), tol=1e-10, max_passes=5)
    assert out.converged, out.history
    assert out.residual_norms.max() <= 1e-10
    np.testing.assert_allclose(out.eigenvalues, np.linalg.eigvalsh(m)[:r], atol=1e-12)
    for a, b in zip(out.history, out.history[1:]):
        assert b < 5e-2 * a
    assert len(tr.cg_iterations) == out.passes


def test_wrapped_operator_matches_jax_and_deflates():
    n, r = 128, 3
    m = make_gapped(n, r)
    x = np.linalg.qr(np.random.default_rng(2).standard_normal((n, r)))[0].T
    lam = np.array([-1.5, -1.0, 0.2])
    v = np.random.default_rng(3).standard_normal((r, n))
    jw = J.make_deflated_matvec(_jmv, 7.0)(jnp.asarray(v), (jnp.asarray(m), jnp.asarray(x),
                                                             jnp.asarray(lam)))
    tw = T.make_deflated_matvec(_tmv, 7.0)(torch.as_tensor(v), (torch.as_tensor(m),
                                                                 torch.as_tensor(x),
                                                                 torch.as_tensor(lam)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-12)
    # on the deflated block the operator is 7 I
    tx = T.make_deflated_matvec(_tmv, 7.0)(torch.as_tensor(x), (
        torch.as_tensor(m), torch.as_tensor(x), torch.as_tensor(lam)))
    np.testing.assert_allclose(tx.numpy(), 7.0 * x, atol=1e-12)


def test_stall_reports_not_converged_as_jax():
    """A block whose roots are not the lowest (the deflation gap is
    violated): both packages stop on the stall rule after the same passes.
    The correction operator is indefinite here, and 20 CG iterations on it
    amplify the packages' different rounding to about 1e-7 of the
    residuals, so the histories are held to 1e-6 relative."""
    n, r = 256, 4
    m = make_gapped(n, r, seed=5)
    vecs = np.linalg.eigh(m)[1]
    x0 = vecs[:, [0, 1, 2, 6]].T + 1e-3 * np.random.default_rng(6).standard_normal((r, n))
    jo = J.EigenpairRefiner(lambda x: x @ m.T, _jmv, jnp.asarray(m), np.diag(m), n, r,
                            inner_tol=1e-3, cg_max_iter=20).refine(x0, tol=1e-14)
    to = T.EigenpairRefiner(lambda x: x @ m.T, _tmv, torch.as_tensor(m), np.diag(m), n, r,
                            inner_tol=1e-3, cg_max_iter=20, device="cpu").refine(
                                x0, tol=1e-14)
    assert to.converged == jo.converged and not to.converged
    assert to.passes == jo.passes
    np.testing.assert_allclose(to.history, jo.history, rtol=1e-6, atol=0)
