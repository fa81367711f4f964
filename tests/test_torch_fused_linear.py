"""The port's FusedLinearEquations against the JAX package's, on the CPU with
the same operator, right-hand sides and options.

The operator is the bench spectrum cut to n=384 plus 3 I (positive
definite, spectrum >= 1), packed in b=128 tiles; 4 right-hand sides from
``default_rng(2)``; m_max 16.

- "exact" and "fast" run f64 arithmetic in both packages ("fast" on bf16
  tiles): solutions within 1e-10, the same iteration count.
- "precise", "int8" and "int8_precise" compute their action in float32 in
  both packages, so the two drift apart at the f32 level: solutions within
  1e-5 and iteration counts within 2 (the rule of the Davidson tests).
- ``fuse_chain=True``: the port's chain wrapper (plain on the CPU) against
  the JAX package's interpreted chain kernel, in K2's raw mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import fused_linear as J
from iterative_solver_torch.solvers import fused_linear as T

N, B, NRHS, M_MAX = 384, 128, 4, 16
TOL = {"exact": 1e-10, "fast": 1e-10, "precise": 1e-5, "int8": 5e-3, "int8_precise": 1e-5}
F64_TIERS = ("exact", "fast")


def _matrix(n=N, seed=0):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals) + 3.0 * np.eye(n)


@pytest.fixture(scope="module")
def mat():
    return _matrix()


@pytest.fixture(scope="module")
def rhs():
    return np.random.default_rng(2).standard_normal((NRHS, N))


def _pair(mat, tier, **kw):
    kw = {**dict(tier=tier, b=B, m_max=M_MAX, convergence_threshold=TOL[tier]), **kw}
    return (J.FusedLinearEquations.from_dense_symmetric(mat, NRHS, **kw),
            T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, device="cpu", **kw))


def _compare(tier, jres, tres):
    jx, jerr, jit = jres
    tx, terr, tit = tres
    assert isinstance(tx, torch.Tensor) and isinstance(terr, np.ndarray)
    assert np.max(terr) <= TOL[tier] and np.max(jerr) <= TOL[tier]
    if tier in F64_TIERS:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
        assert tit == jit
    else:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
        assert abs(tit - jit) <= 2


@pytest.mark.parametrize("fuse_chain", [False, True])
@pytest.mark.parametrize("tier", list(TOL))
def test_tiers_match_jax(mat, rhs, tier, fuse_chain):
    js, ts = _pair(mat, tier, fuse_chain=fuse_chain)
    assert ts.fuse_chain is fuse_chain
    tres = ts.solve(rhs)
    _compare(tier, js.solve(rhs), tres)
    if tier in F64_TIERS:
        ref = np.linalg.solve(mat, rhs.T).T
        scale = np.abs(ref).max()
        band = 1e-8 if tier == "exact" else 5e-2
        assert np.abs(tres[0].numpy() - ref).max() <= band * scale


def test_shifted_per_rhs_diagonals_match_jax(mat, rhs):
    """A (nrhs, N) diagonal: row i preconditions with diag - shift_i (the
    eigenvector-response form), through the generic constructor."""
    shifts = np.array([0.5, 0.25, 0.0, -0.5])
    diag = np.diag(mat)[None, :] - shifts[:, None]
    kw = dict(m_max=M_MAX, convergence_threshold=1e-10)
    js = J.FusedLinearEquations(
        lambda x, op: jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST),
        diag, N, NRHS, operand=jnp.asarray(mat), **kw)
    ts = T.FusedLinearEquations(lambda x, op: x @ op.T, diag, N, NRHS,
                                operand=torch.as_tensor(mat), device="cpu", **kw)
    assert ts.diag.shape == (NRHS, N)
    _compare("exact", js.solve(rhs), ts.solve(rhs))


@pytest.mark.parametrize("with_actions", [False, True])
def test_p_space_matches_jax(mat, rhs, with_actions):
    idx = np.argsort(np.diag(mat))[:6]
    kw = {"p_space": [{int(i): 1.0} for i in idx], "m_max": 24}
    if with_actions:
        kw["p_actions"] = mat[idx]
    js, ts = _pair(mat, "exact", **kw)
    assert ts.n_p == 6
    tres = ts.solve(rhs)
    _compare("exact", js.solve(rhs), tres)
    np.testing.assert_allclose(tres[0].numpy(), np.linalg.solve(mat, rhs.T).T, atol=1e-9)


def test_p_space_restart_matches_jax(mat, rhs):
    """A basis of 3 nrhs + n_p rows restarts every second iteration, and
    the restart keeps the P rows."""
    idx = np.argsort(np.diag(mat))[:4]
    js, ts = _pair(mat, "exact", p_space=[{int(i): 1.0} for i in idx], m_max=3 * NRHS + 4)
    tres = ts.solve(rhs)
    _compare("exact", js.solve(rhs), tres)
    assert tres[2] > 2


def test_warm_start_matches_jax(mat, rhs):
    x0 = np.linalg.solve(mat, rhs.T).T + 1e-3 * np.random.default_rng(4).standard_normal(
        (NRHS, N))
    js, ts = _pair(mat, "exact")
    jres, tres = js.solve(rhs, x0=x0), ts.solve(rhs, x0=x0)
    _compare("exact", jres, tres)
    assert tres[2] < ts.solve(rhs)[2]


def test_states_match_jax(mat, rhs):
    """The init and two steps of the solve's bodies, field by field; a third
    step would append past m_max and raises."""
    jstep = J._step_body(lambda x, op: jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST),
                         NRHS, 12)
    tstep = T._step_body(lambda x, op: x @ op.T, NRHS, 12)
    jinit = J.make_linear_init(lambda x, op: jnp.matmul(
        x, op.T, precision=jax.lax.Precision.HIGHEST), NRHS, 12)
    tinit = T.make_linear_init(lambda x, op: x @ op.T, NRHS, 12)
    b = jnp.asarray(rhs)
    tb = torch.as_tensor(rhs)
    jop, top = jnp.asarray(mat), torch.as_tensor(mat)
    jd, td = jnp.asarray(np.diag(mat)), torch.as_tensor(np.diag(mat).copy())
    js, jn = jinit(b, b, jop)
    ts, tn = tinit(tb, tb, top)
    for _ in range(2):
        js, ts = jstep(js, jop, jd, b, jn), tstep(ts, top, td, tb, tn)
    assert ts.k == int(js.k) == 12
    for name in ("v", "w", "mask", "x", "r", "errors"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    with pytest.raises(ValueError, match="overflows"):
        tstep(ts, top, td, tb, tn)


def test_tile_rule_matches_jax():
    for n, tier in ((384, "exact"), (640, "fast"), (1536, "int8"), (768, "precise")):
        m = _matrix(n)
        js = J.FusedLinearEquations.from_dense_symmetric(m, 2, tier=tier)
        ts = T.FusedLinearEquations.from_dense_symmetric(m, 2, tier=tier, device="cpu")
        jshape = [tuple(np.asarray(a).shape) for a in js.operand]
        tshape = [tuple(a.shape) for a in ts.operand]
        assert tshape == jshape, (n, tier)
    with pytest.raises(ValueError, match="multiple of the tile size"):
        T.FusedLinearEquations.from_dense_symmetric(_matrix(400), 2, b=128, device="cpu")


def test_bad_inputs_raise(mat, rhs):
    ts = T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, b=B, device="cpu")
    bad = rhs.copy()
    bad[1] = 0.0
    with pytest.raises(RuntimeError, match="RHS vector cannot be zero"):
        ts.solve(bad)
    with pytest.raises(ValueError, match="m_max"):
        T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, b=B, m_max=7, device="cpu")
    with pytest.raises(ValueError, match="tier"):
        T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, tier="banana", device="cpu")
    # sharding is ported (tests/test_torch_sharded_solvers.py) and takes a
    # parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, device="cpu",
                                                    sharding=object())


def test_defaults(mat):
    ts = T.FusedLinearEquations.from_dense_symmetric(mat, NRHS, device="cpu")
    assert ts.dtype == torch.float64 and ts.fuse_chain is False
    assert ts.m_max == max(4 * NRHS, 24)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FusedLinearEquations.from_dense_symmetric(mat, NRHS)
