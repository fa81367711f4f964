"""The port's differentiable eigensolves and differentiable packed action
against the JAX package's (tests/test_implicit_diff.py's cases), on the CPU
in float64: gradients within 1e-8 relative of ``jax.grad`` of the same
objective, the packed custom VJP against JAX's interpret-mode Pallas
forward, and ``torch.autograd.gradcheck`` of the plain differentiable
action.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops.kernels import symm_pallas as jsymm
from iterative_solver_tpu.solvers import implicit_diff as jdiff
from iterative_solver_torch.ops.kernels import symm as tsymm
from iterative_solver_torch.solvers import implicit_diff as tdiff
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

_PREC = jax.lax.Precision.HIGHEST


def _sym_pair(n, seed, lo, hi, scale=0.1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    base = a + a.T + np.diag(np.linspace(lo, hi, n))
    p = rng.standard_normal((n, n)) * scale
    return rng, base, p + p.T


def _jmatvec(x, op):
    return jnp.matmul(x, op.T, precision=_PREC)


def _tmatvec(x, op):
    return x @ op.T


def _v0(nroots, n):
    v0 = np.zeros((nroots, n))
    v0[np.arange(nroots), np.arange(nroots)] = 1.0
    return v0


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def test_eigenvalue_gradient_matches_jax():
    n, nroots = 64, 3
    _, base, pert = _sym_pair(n, 41, 0.0, 10.0)
    w = np.array([1.0, -0.5, 2.0])
    theta0 = 0.3
    jfn = jdiff.make_differentiable_eigenvalues(_jmatvec, nroots, 6 * nroots, tol=1e-11,
                                                max_iter=400)
    tfn = tdiff.make_differentiable_eigenvalues(_tmatvec, nroots, 6 * nroots, tol=1e-11,
                                                max_iter=400)
    gj = float(jax.grad(lambda th: jnp.sum(
        jfn(jnp.asarray(_v0(nroots, n)), base + th * pert, jnp.diagonal(base)) * w))(theta0))
    theta = torch.tensor(theta0, dtype=torch.float64, requires_grad=True)
    lam = tfn(_t(_v0(nroots, n)), _t(base) + theta * _t(pert), _t(np.diagonal(base)))
    (lam * _t(w)).sum().backward()
    np.testing.assert_allclose(float(theta.grad), gj, rtol=1e-8)
    evals, vecs = np.linalg.eigh(base + theta0 * pert)
    analytic = sum(wi * vecs[:, i] @ pert @ vecs[:, i] for i, wi in enumerate(w))
    np.testing.assert_allclose(float(theta.grad), analytic, rtol=1e-7)
    np.testing.assert_allclose(lam.detach().numpy(), evals[:nroots], rtol=0, atol=1e-10)
    assert tfn.last_iterations > 0


def test_pytree_operand_matches_jax():
    """(values, scale): every tensor leaf gets its gradient; lambda(s) = s
    lambda(1), so d lambda / ds = lambda(1)."""
    n, nroots = 48, 2
    _, base, _ = _sym_pair(n, 42, 1.0, 9.0)

    def jmv(x, op):
        mat, scale = op
        return scale * jnp.matmul(x, mat.T, precision=_PREC)

    def tmv(x, op):
        mat, scale = op
        return scale * (x @ mat.T)

    jfn = jdiff.make_differentiable_eigenvalues(jmv, nroots, 6 * nroots, tol=1e-11, max_iter=300)
    tfn = tdiff.make_differentiable_eigenvalues(tmv, nroots, 6 * nroots, tol=1e-11, max_iter=300)
    diag = np.diagonal(base)
    gj = jax.grad(lambda s: jfn(jnp.asarray(_v0(nroots, n)), (jnp.asarray(base), s),
                                jnp.asarray(diag) * s)[0])(1.0)
    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    mat = _t(base).requires_grad_(True)
    lam = tfn(_t(_v0(nroots, n)), (mat, scale), _t(diag) * scale)
    lam[0].backward()
    np.testing.assert_allclose(float(scale.grad), float(gj), rtol=1e-8)
    np.testing.assert_allclose(float(scale.grad), float(lam[0].detach()), rtol=1e-8)
    # the matrix leaf: d lambda0 / dA = x0 x0^T (the matvec is x A^T)
    x0 = np.linalg.eigh(base)[1][:, 0]
    np.testing.assert_allclose(mat.grad.numpy(), np.outer(x0, x0), atol=1e-9)


def test_eigenpair_gradient_matches_jax():
    """The eigenvector adjoint (the response solve) for <x0|M|x0>, against
    jax.grad and the dense perturbation formula."""
    n, nroots = 72, 2
    rng, base, pert = _sym_pair(n, 51, 0.0, 9.0)
    mo = rng.standard_normal((n, n)) * 0.2
    m = mo + mo.T
    kw = dict(tol=1e-11, max_iter=500, response_tol=1e-10, response_max_iter=400,
              response_m_max=10 * nroots)
    jfn = jdiff.make_differentiable_eigenpairs(_jmatvec, nroots, 8 * nroots, **kw)
    tfn = tdiff.make_differentiable_eigenpairs(_tmatvec, nroots, 8 * nroots, **kw)
    theta0 = 0.2

    def jexp(th):
        _, x = jfn(jnp.asarray(_v0(nroots, n)), base + th * pert, jnp.diagonal(base))
        return x[0] @ m @ x[0]

    gj = float(jax.grad(jexp)(theta0))
    theta = torch.tensor(theta0, dtype=torch.float64, requires_grad=True)
    _, x = tfn(_t(_v0(nroots, n)), _t(base) + theta * _t(pert), _t(np.diagonal(base)))
    (x[0] @ _t(m) @ x[0]).backward()
    np.testing.assert_allclose(float(theta.grad), gj, rtol=1e-8)
    w, v = np.linalg.eigh(base + theta0 * pert)
    mx0 = m @ v[:, 0]
    analytic = sum(2.0 * (mx0 @ v[:, j]) * (v[:, j] @ pert @ v[:, 0]) / (w[0] - w[j])
                   for j in range(1, n))
    np.testing.assert_allclose(float(theta.grad), analytic, rtol=1e-6)
    iters, errors = tfn.last_response
    assert iters > 0 and float(errors.max()) <= 1e-10


def test_eigenpair_eigenvalue_part_matches_eigenvalues():
    n, nroots = 48, 2
    _, base, pert = _sym_pair(n, 52, 1.0, 8.0)
    grads = []
    for make in (tdiff.make_differentiable_eigenvalues, tdiff.make_differentiable_eigenpairs):
        fn = make(_tmatvec, nroots, 8 * nroots, tol=1e-11, max_iter=400)
        theta = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
        out = fn(_t(_v0(nroots, n)), _t(base) + theta * _t(pert), _t(np.diagonal(base)))
        lam = out if make is tdiff.make_differentiable_eigenvalues else out[0]
        lam.sum().backward()
        grads.append(float(theta.grad))
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-9)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_packed_custom_vjp_matches_jax(use_pallas):
    """Eigenvalue gradients w.r.t. the tile values through
    make_differentiable_symm_action, against JAX's through its twin (the
    XLA forward, or the Pallas forward in interpret mode, as
    test_gradient_through_packed_custom_vjp runs it) and the dense
    outer-product formula."""
    n, b, nroots = 64, 16, 1
    rng = np.random.default_rng(71)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    mat = a + a.T + np.diag(np.linspace(1.0, 8.0, n))
    jsym = jsymm.SymmetricBlocked.from_dense(mat, b=b)
    jact = jsymm.make_differentiable_symm_action(jsym, use_pallas=use_pallas, interpret=True)
    jfn = jdiff.make_differentiable_eigenvalues(lambda x, op: jact(x, op), nroots, 8,
                                                tol=1e-11, max_iter=400)
    v0 = _v0(nroots, n)
    gj = np.asarray(jax.grad(lambda v: jfn(jnp.asarray(v0), v, jnp.diagonal(jnp.asarray(mat)))[0])(
        jsym.values))

    tsym = tsymm.SymmetricBlocked.from_dense(mat, b=b, device="cpu")
    tact = tsymm.make_differentiable_symm_action(tsym)
    tfn = tdiff.make_differentiable_eigenvalues(lambda x, op: tact(x, op), nroots, 8,
                                                tol=1e-11, max_iter=400)
    values = tsym.values.clone().requires_grad_(True)
    tfn(_t(v0), values, _t(np.diagonal(mat)))[0].backward()
    gt = values.grad.numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-8 * np.abs(gj).max())
    x0 = np.linalg.eigh(mat)[1][:, 0]
    outer = np.outer(x0, x0)
    for t, (i, j) in enumerate(zip(tsym.ii.tolist(), tsym.jj.tolist())):
        blk = outer[i * b:(i + 1) * b, j * b:(j + 1) * b]
        np.testing.assert_allclose(gt[t], blk if i == j else 2 * blk, atol=1e-9)


def test_differentiable_action_vjp_matches_jax():
    """xbar and vbar of one action against JAX's custom VJP on the same
    cotangent, and against plain autograd through symm_matmat."""
    n, b, m = 48, 16, 3
    rng = np.random.default_rng(81)
    a = rng.standard_normal((n, n))
    mat = a + a.T
    x = rng.standard_normal((m, n))
    ybar = rng.standard_normal((m, n))
    jsym = jsymm.SymmetricBlocked.from_dense(mat, b=b)
    jact = jsymm.make_differentiable_symm_action(jsym, use_pallas=False)
    _, vjp = jax.vjp(jact, jnp.asarray(x), jsym.values)
    jx, jv = (np.asarray(g) for g in vjp(jnp.asarray(ybar)))

    tsym = tsymm.SymmetricBlocked.from_dense(mat, b=b, device="cpu")
    tact = tsymm.make_differentiable_symm_action(tsym)
    for fn in (tact, lambda xx, vv: tsymm.symm_matmat(xx, dataclasses.replace(tsym, values=vv))):
        xt = _t(x).requires_grad_(True)
        vt = tsym.values.clone().requires_grad_(True)
        fn(xt, vt).backward(_t(ybar))
        np.testing.assert_allclose(xt.grad.numpy(), jx, rtol=0, atol=1e-12)
        np.testing.assert_allclose(vt.grad.numpy(), jv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jx, ybar @ mat, atol=1e-12)


def test_differentiable_action_gradcheck():
    n, b = 24, 8
    rng = np.random.default_rng(91)
    a = rng.standard_normal((n, n))
    sym = tsymm.SymmetricBlocked.from_dense(a + a.T, b=b, device="cpu")
    act = tsymm.make_differentiable_symm_action(sym)
    x = _t(rng.standard_normal((2, n))).requires_grad_(True)
    values = sym.values.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(act, (x, values))


def test_differentiable_action_refuses_rather_than_falls_back():
    """On the CPU the forward is the plain version; an operand the plain
    version cannot take raises (nothing silently changes path)."""
    sym = tsymm.SymmetricBlocked.from_dense(np.eye(32), b=16, device="cpu")
    act = tsymm.make_differentiable_symm_action(sym)
    with pytest.raises(RuntimeError):
        act(torch.zeros((2, 40), dtype=torch.float64), sym.values)


def _bench_matrix(n):
    """chip_smoke.bench_matrix: spectrum linspace(-2, 3, 32) ∪ linspace(6, 50,
    n - 32), couplings 0.05/sqrt(n), default_rng(0)."""
    rng = np.random.default_rng(0)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


@pytest.mark.parametrize("roots", [(0,), (0, 1, 2, 3)], ids=["one_root", "four_roots"])
def test_eigenpair_response_with_cotangents_on_several_roots(roots, monkeypatch):
    """d/dθ Σ_{i in roots} <x_i|M|x_i> at n = 1024 (4 roots, m_max 24,
    response tol 1e-8, 100 response iterations), both packages. With a
    cotangent on one root the response solve converges and the gradient is
    the perturbation formula's. With cotangents on four it does not
    converge in either package (ROADMAP Queue 3: the block response solve
    shares one basis across rows whose projected operators differ): the
    errors stay far above the tolerance, both packages read the same
    errors, and the gradient is off the formula. A fix in both packages
    turns the four-root case into the one-root case's checks."""
    from iterative_solver_tpu.solvers import fused_linear as jfl

    n, nroots, m_max, response_tol, response_max_iter = 1024, 4, 24, 1e-8, 100
    mat = _bench_matrix(n)
    diag = np.diagonal(mat)
    v0 = np.zeros((nroots, n))
    v0[np.arange(nroots), np.argsort(diag)[:nroots]] = 1.0
    mvec = np.random.default_rng(7).standard_normal(n)
    p = np.random.default_rng(8).standard_normal((n, n)) * 0.01
    pert = p + p.T
    kw = dict(tol=1e-10, max_iter=300, response_tol=response_tol,
              response_max_iter=response_max_iter)

    # JAX's response solve's final errors, read where its backward calls it
    jax_response = []
    make_solve = jfl.make_linear_solve

    def recording_make_linear_solve(*args, **kwargs):
        solve = make_solve(*args, **kwargs)

        def run(*a):
            final, iters = solve(*a)
            jax_response.append((int(iters), np.asarray(final.errors)))
            return final, iters
        return run

    monkeypatch.setattr(jfl, "make_linear_solve", recording_make_linear_solve)
    jfn = jdiff.make_differentiable_eigenpairs(_jmatvec, nroots, m_max, **kw)

    def jexp(th):
        _, x = jfn(jnp.asarray(v0), mat + th * pert, jnp.asarray(diag))
        return sum(jnp.sum(x[i] * x[i] * mvec) for i in roots)

    gj = float(jax.grad(jexp)(0.0))
    tfn = tdiff.make_differentiable_eigenpairs(_tmatvec, nroots, m_max, **kw)
    theta = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    _, x = tfn(_t(v0), _t(mat) + theta * _t(pert), _t(diag))
    sum((x[i] * x[i] * _t(mvec)).sum() for i in roots).backward()
    gt = float(theta.grad)
    t_iters, t_errors = tfn.last_response
    t_errors = t_errors.numpy()
    (j_iters, j_errors), = jax_response

    w, v = np.linalg.eigh(mat)
    analytic = 0.0
    for i in roots:
        terms = 2.0 * (v.T @ (mvec * v[:, i])) * (v.T @ (pert @ v[:, i]))
        others = np.arange(n) != i
        analytic += float(np.sum(terms[others] / (w[i] - w[others])))
    if len(roots) == 1:
        assert j_iters == t_iters < response_max_iter
        assert max(j_errors.max(), t_errors.max()) <= response_tol
        np.testing.assert_allclose(gt, gj, rtol=1e-8)
        np.testing.assert_allclose(gt, analytic, rtol=1e-6)
    else:
        assert j_iters == t_iters == response_max_iter
        assert min(j_errors.min(), t_errors.min()) > 1e6 * response_tol
        np.testing.assert_allclose(t_errors, j_errors, rtol=1e-4)
        for g in (gj, gt):
            assert abs(g - analytic) > 0.5 * abs(analytic)
