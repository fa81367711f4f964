"""The port's FusedBlockCG and make_batched_cg_solve against the JAX
package's, on the CPU in float64 with the same operators and right-hand
sides: solutions within 1e-10 and the same iteration counts.

The operators are the bench spectrum cut to n=384 plus 3 I (SPD), applied
densely or through the packed "precise" tier (FusedLinearEquations'
operand), and per-RHS shifted diagonals (the response-equation form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import fused_cg as J
from iterative_solver_tpu.solvers import fused_linear as JL
from iterative_solver_torch.solvers import fused_cg as T
from iterative_solver_torch.solvers import fused_linear as TL

N = 384


def _matrix(n=N, seed=0):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals) + 3.0 * np.eye(n)


def _jmv(x, op):
    return jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST)


def _tmv(x, op):
    return torch.matmul(x, op.T)


@pytest.fixture(scope="module")
def mat():
    return _matrix()


def _pair(mat, nrhs, diag=None, **kw):
    diag = np.diag(mat) if diag is None else diag
    return (J.FusedBlockCG(_jmv, diag, N, nrhs, operand=jnp.asarray(mat), **kw),
            T.FusedBlockCG(_tmv, diag, N, nrhs, operand=torch.as_tensor(mat), device="cpu",
                           **kw))


def _compare(jres, tres, tol):
    jx, jerr, jit = jres
    tx, terr, tit = tres
    assert isinstance(tx, torch.Tensor) and isinstance(terr, np.ndarray)
    assert np.max(terr) <= tol
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=0, atol=1e-10)
    assert tit == jit


@pytest.mark.parametrize("nrhs", [1, 3])
def test_matches_jax_and_direct_solve(mat, nrhs):
    b = np.random.default_rng(nrhs).standard_normal((nrhs, N))
    js, ts = _pair(mat, nrhs, convergence_threshold=1e-11)
    tres = ts.solve(b)
    _compare(js.solve(b), tres, 1e-11)
    np.testing.assert_allclose(tres[0].numpy(), np.linalg.solve(mat, b.T).T, atol=1e-9)


def test_shifted_per_rhs_diagonals(mat):
    """Row i solves (A - s_i) x_i = b_i through a row-wise operator, with
    the per-RHS Jacobi diagonal diag - s_i."""
    shifts = np.array([0.0, 0.5, 0.9])
    diag = np.diag(mat)[None, :] - shifts[:, None]
    b = np.random.default_rng(7).standard_normal((3, N))
    kw = dict(convergence_threshold=1e-11)

    def jmv(x, op):
        return _jmv(x, op[0]) - op[1][:, None] * x

    def tmv(x, op):
        return _tmv(x, op[0]) - op[1][:, None] * x

    js = J.FusedBlockCG(jmv, diag, N, 3, operand=(jnp.asarray(mat), jnp.asarray(shifts)), **kw)
    ts = T.FusedBlockCG(tmv, diag, N, 3, operand=(torch.as_tensor(mat),
                                                   torch.as_tensor(shifts)), device="cpu", **kw)
    tres = ts.solve(b)
    _compare(js.solve(b), tres, 1e-11)
    for i, s in enumerate(shifts):
        np.testing.assert_allclose(tres[0][i].numpy(),
                                   np.linalg.solve(mat - s * np.eye(N), b[i]), atol=1e-9)


def test_mixed_convergence_freezes_early_systems(mat):
    """One right-hand side is an exact multiple of a unit vector's image:
    it converges at once and freezes, as in JAX."""
    b = np.random.default_rng(5).standard_normal((3, N))
    b[0] = mat[:, 0]
    js, ts = _pair(mat, 3, convergence_threshold=1e-10)
    x0 = np.zeros((3, N))
    x0[0, 0] = 1.0
    _compare(js.solve(b, x0=x0), ts.solve(b, x0=x0), 1e-10)


def test_warm_start_and_zero_rhs(mat):
    b = np.random.default_rng(6).standard_normal((2, N))
    js, ts = _pair(mat, 2, convergence_threshold=1e-10)
    x0 = np.linalg.solve(mat, b.T).T + 1e-4
    tres = ts.solve(b, x0=x0)
    _compare(js.solve(b, x0=x0), tres, 1e-10)
    assert tres[2] < ts.solve(b)[2]
    _, errs, iters = ts.solve(np.zeros((2, N)))
    assert iters == 0 and np.all(errs == 0.0)


def test_packed_precise_tier_action(mat):
    """The CG on the "precise" packed action (float32 planes, f64 x in both
    packages) built by FusedLinearEquations.from_dense_symmetric."""
    b = np.random.default_rng(8).standard_normal((2, N))
    jl = JL.FusedLinearEquations.from_dense_symmetric(mat, 2, tier="precise", b=128)
    tl = TL.FusedLinearEquations.from_dense_symmetric(mat, 2, tier="precise", b=128,
                                                      device="cpu")
    js = J.FusedBlockCG(jl.matvec, np.diag(mat), N, 2, operand=jl.operand,
                        convergence_threshold=1e-6)
    ts = T.FusedBlockCG(tl.matvec, np.diag(mat), N, 2, operand=tl.operand, device="cpu",
                        convergence_threshold=1e-6)
    jx, jerr, jit = js.solve(b)
    tx, terr, tit = ts.solve(b)
    assert np.max(terr) <= 1e-6
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    assert abs(tit - jit) <= 2


def test_states_match_jax(mat):
    b = np.random.default_rng(9).standard_normal((2, N))
    jinit, tinit = J.make_cg_init(_jmv), T.make_cg_init(_tmv)
    jsolve, tsolve = J.make_cg_solve(_jmv), T.make_cg_solve(_tmv)
    jd, td = jnp.asarray(np.diag(mat)), torch.as_tensor(np.diag(mat).copy())
    bn = np.linalg.norm(b, axis=1)
    js = jinit(jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b), jnp.asarray(mat), jd,
               jnp.asarray(bn))
    ts = tinit(torch.zeros((2, N), dtype=torch.float64), torch.as_tensor(b),
               torch.as_tensor(mat), td, torch.as_tensor(bn))
    jf, jit = jsolve(js, jnp.asarray(mat), jd, jnp.asarray(bn), 1e-6, 4)
    tf, tit = tsolve(ts, torch.as_tensor(mat), td, torch.as_tensor(bn), 1e-6, 4)
    assert tit == int(jit) == 4
    for name in T.CGState._fields:
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_batched_matches_jax():
    """Four SPD systems of n=128 at different couplings, 2 right-hand sides
    each, in one batched solve: per-element solutions, errors and
    iteration counts equal JAX's batched solve."""
    n, nb, nrhs = 128, 4, 2
    rng = np.random.default_rng(0)
    base = rng.standard_normal((n, n)) * (0.3 / np.sqrt(n))
    base = base + base.T
    mats = np.stack([lam * base + np.diag(np.linspace(1.0, 5.0 + 3 * lam, n))
                     for lam in np.linspace(0.2, 1.5, nb)])
    diags = np.stack([np.diag(m) for m in mats])
    bs = rng.standard_normal((nb, nrhs, n))
    bn = np.linalg.norm(bs, axis=2)
    x0 = np.zeros_like(bs)
    jinit, jsolve = J.make_batched_cg_solve(_jmv)
    jf, jit = jsolve(jinit(jnp.asarray(x0), jnp.asarray(bs), jnp.asarray(mats),
                           jnp.asarray(diags), jnp.asarray(bn)),
                     jnp.asarray(mats), jnp.asarray(diags), jnp.asarray(bn), 1e-10, 500)
    tinit, tsolve = T.make_batched_cg_solve(_tmv)
    tm, td = torch.as_tensor(mats), torch.as_tensor(diags)
    tf, tit = tsolve(tinit(torch.as_tensor(x0), torch.as_tensor(bs), tm, td,
                           torch.as_tensor(bn)), tm, td, torch.as_tensor(bn), 1e-10, 500)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    assert len(set(tit.tolist())) > 1
    for name in T.CGState._fields:
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    for e in range(nb):
        np.testing.assert_allclose(tf.x[e].numpy(), np.linalg.solve(mats[e], bs[e].T).T,
                                   atol=1e-8)


def test_defaults_and_refusals(mat):
    ts = T.FusedBlockCG(_tmv, np.diag(mat), N, 2, operand=torch.as_tensor(mat), device="cpu")
    assert ts.dtype == torch.float64 and ts.max_iter == 1000
    # sharding is ported (tests/test_torch_sharded_solvers.py) and takes a
    # parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        T.FusedBlockCG(_tmv, np.diag(mat), N, 2, device="cpu", sharding=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FusedBlockCG(_tmv, np.diag(mat), N, 2)
