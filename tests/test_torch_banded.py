"""The port's BandedEigensolver and deflated matvec
(iterative_solver_torch/solvers/banded.py) against the JAX package's, on
tests/test_banded.py's inputs and sizes, on the CPU in float64.

Tolerances: eigenvalues within 1e-9 of JAX's and 1e-7 of eigvalsh (the JAX
file's bound), the JAX file's residual (1e-6; 1e-4 inside the 1e-3-split
pairs) and orthonormality (1e-8) bounds, equal ``n_locked``, and in the
streamed mode the same count of ``run_on_device`` sweeps. The deflated
matvec within 1e-10 of the JAX file's own expectations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterative_solver_tpu.solvers.fused_davidson as jfd
from iterative_solver_torch.solvers.banded import BandedEigensolver, make_deflated_davidson_matvec
from iterative_solver_tpu.solvers.banded import BandedEigensolver as JBanded
from iterative_solver_tpu.solvers.banded import (
    make_deflated_davidson_matvec as j_make_deflated,
)
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_matrix(n, nlow=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.02 / np.sqrt(n))
    d = np.concatenate([np.linspace(-3.0, 0.0, nlow), np.linspace(2.0, 20.0, n - nlow)])
    return a + a.T + np.diag(d)


def make_clustered_matrix(n, seed=11):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    clusters = []
    for c in range(6):  # six pairs: -3.0/-2.999, -2.4/-2.399, ...
        base = -3.0 + 0.6 * c
        clusters += [base, base + 1e-3]
    d = np.concatenate([np.asarray(clusters), np.linspace(2.0, 20.0, n - len(clusters))])
    return a + a.T + np.diag(d)


def torch_matvec(x, op):
    return torch.matmul(x, op.T)


def jax_matvec(x, op):
    return jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST)


def _jax_sweeps(monkeypatch):
    """Count the JAX package's run_on_device calls."""
    calls = []
    real = jfd.FusedDavidson.run_on_device

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(jfd.FusedDavidson, "run_on_device", counted)
    return calls


def _solve_both(m, nroots, band, max_iter, deflate, monkeypatch, with_jax=True):
    n = m.shape[0]
    kw = dict(band=band, m_max=16, convergence_threshold=1e-9, max_iter=max_iter,
              deflate=deflate, store_block_rows=3)
    port = BandedEigensolver(torch_matvec, np.diag(m), n, operand=torch.as_tensor(m),
                             device="cpu", **kw)
    out = port.solve(nroots)
    if not with_jax:
        return port, out, None, None
    calls = _jax_sweeps(monkeypatch)
    ref = JBanded(jax_matvec, np.diag(m), n, operand=jnp.asarray(m), **kw)
    return port, out, ref, (ref.solve(nroots), len(calls))


def _check(m, vals, vecs, nroots, res_bound):
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(m)[:nroots], atol=1e-7)
    for i in range(nroots):
        xi = vecs[i] / np.linalg.norm(vecs[i])
        res = np.linalg.norm(m @ xi - vals[i] * xi)
        assert res < res_bound, f"root {i}: residual {res}"
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(nroots), atol=1e-8)


@pytest.mark.parametrize("deflate", ["device", "streamed"])
def test_banded_matches_dense_and_jax(deflate, monkeypatch):
    n, nroots, band = 256, 12, 4
    m = make_matrix(n)
    port, (vals, vecs, errs), ref, ((jvals, _, _), jsweeps) = _solve_both(
        m, nroots, band, 300, deflate, monkeypatch)
    _check(m, vals, vecs, nroots, 1e-6)
    np.testing.assert_allclose(vals, jvals, atol=1e-9)
    assert port.n_locked == ref.n_locked
    if deflate == "streamed":
        assert port.n_locked == nroots
        assert len(port.runs) == jsweeps
        assert sorted(port._stream_solvers) == sorted(ref._stream_solvers)
    else:
        assert len(port.runs) == jsweeps == nroots // band


def test_streamed_clustered_spectrum_n512(monkeypatch):
    """The windowed-hard-deflation regression at the scale it failed (n=512,
    clustered pairs, band=3 so every band boundary falls inside a cluster),
    held against JAX: the same eigenvalues and sweeps."""
    n, nroots, band = 512, 8, 3
    m = make_clustered_matrix(n)
    port, (vals, vecs, errs), ref, ((jvals, _, _), jsweeps) = _solve_both(
        m, nroots, band, 400, "streamed", monkeypatch)
    # inside a 1e-3-split pair a vector is ill-conditioned (residual ~
    # splitting x mixing angle): the JAX file's 1e-4
    _check(m, vals, vecs, nroots, 1e-4)
    np.testing.assert_allclose(vals, jvals, atol=1e-9)
    assert port.n_locked == ref.n_locked == nroots
    assert len(port.runs) == jsweeps


def test_deflated_matvec_moves_locked_roots():
    n = 64
    m = make_matrix(n, nlow=4, seed=3)
    w, v = np.linalg.eigh(m)
    xl = v[:, :2].T  # lock the two lowest
    sigma = 50.0
    wrapped = make_deflated_davidson_matvec(torch_matvec, sigma)
    packed = (torch.as_tensor(m), torch.as_tensor(xl))
    out = wrapped(torch.as_tensor(xl), packed).numpy()
    np.testing.assert_allclose(out, sigma * xl, atol=1e-10)
    probe = np.eye(n)
    ap = wrapped(torch.as_tensor(probe), packed).numpy().T
    np.testing.assert_allclose(np.linalg.eigvalsh(0.5 * (ap + ap.T))[0], w[2], atol=1e-10)
    jw = j_make_deflated(jax_matvec, sigma)
    ref = np.asarray(jw(jnp.asarray(probe), (jnp.asarray(m), jnp.asarray(xl)))).T
    np.testing.assert_allclose(ap, ref, atol=1e-12)


def test_empty_locked_block_is_noop():
    n = 32
    m = make_matrix(n, nlow=4, seed=5)
    wrapped = make_deflated_davidson_matvec(torch_matvec, 99.0)
    v = np.random.default_rng(0).standard_normal((3, n))
    out = wrapped(torch.as_tensor(v), (torch.as_tensor(m), torch.zeros((0, n),
                                                                       dtype=torch.float64)))
    np.testing.assert_allclose(out.numpy(), v @ m.T, atol=1e-12)


def test_defaults_match_jax():
    m = make_matrix(40, nlow=4, seed=6)
    port = BandedEigensolver(torch_matvec, np.diag(m), 40, band=5, device="cpu")
    ref = JBanded(jax_matvec, np.diag(m), 40, band=5)
    assert port.m_max == ref.m_max == 24
    assert port.sigma == ref.sigma
    assert port.dtype == torch.float64
    with pytest.raises(ValueError, match="deflate"):
        BandedEigensolver(torch_matvec, np.diag(m), 40, deflate="disk", device="cpu")
    # sharding= is ported (tests/test_torch_sharded_families.py) and takes a
    # parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        BandedEigensolver(torch_matvec, np.diag(m), 40, sharding=object(), device="cpu")
