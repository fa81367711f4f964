"""The port's FusedPPCG (iterative_solver_torch/solvers/fused_ppcg.py) against
the JAX package's, on the CPU with the same operators and guesses.

- Dense f64 matvec (the bench spectrum at n=256, 6 roots): both packages
  take the same steps. The packed 3x3 Jacobi and the per-root Rayleigh-Ritz
  agree to 1e-12, the solve takes the same iteration count with
  eigenvalues equal to 1e-10, and the residual history agrees to 1e-9 of
  its first entry.
- The int8 tiers through ``from_dense_symmetric``: their action is f32 in
  both packages (as the "precise" rule of test_torch_fused_davidson.py),
  so eigenvalues agree to 1e-5 and iteration counts within 2.
- A float32 state whose correction row is of subnormal size: XLA reads it
  as zero and drops the direction; the port must drop it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_torch import convert
from iterative_solver_torch.solvers import fused_ppcg as T
from iterative_solver_tpu.solvers import fused_ppcg as J

N, NROOTS, RR_EVERY = 256, 6, 4


def _matrix(n=N, seed=3):
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(d)


def _guess(mat, nroots=NROOTS):
    v0 = np.zeros((nroots, mat.shape[0]))
    for row, i in enumerate(np.argsort(np.diag(mat))[:nroots]):
        v0[row, i] = 1.0
    return v0


def _dense_matvec(x, op):
    return x @ op


@pytest.fixture(scope="module")
def mat():
    return _matrix()


def _pair(mat, **kw):
    kw = dict(rr_every=RR_EVERY, convergence_threshold=1e-9, max_iter=300, **kw)
    d = np.diag(mat).copy()
    return (J.FusedPPCG(_dense_matvec, d, mat.shape[0], NROOTS,
                        operand=jnp.asarray(mat), **kw),
            T.FusedPPCG(_dense_matvec, d, mat.shape[0], NROOTS,
                        operand=torch.from_numpy(mat), device="cpu", **kw))


def _vec(rng, shape=(NROOTS,)):
    return rng.standard_normal(shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jacobi3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    comps = [_vec(rng, (40,)) for _ in range(6)]
    comps[3][:5] = 0.0     # already diagonal in (0, 1)
    comps[4][5:10] = 1e-40  # below the 1e-36 rotation floor
    ref = J._jacobi3_packed(*[jnp.asarray(c) for c in comps])
    got = T._jacobi3_packed(*[torch.from_numpy(c) for c in comps])
    for k in range(3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-12)
    for i in range(3):
        for j in range(3):
            np.testing.assert_allclose(got[3][i][j].numpy(), np.asarray(ref[3][i][j]),
                                       rtol=0, atol=1e-12)


def test_batched_eigh3_matches_eigh():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((30, 3, 3))
    a = a + a.transpose(0, 2, 1)
    w, v = T._batched_eigh3(torch.from_numpy(a))
    wr, _ = np.linalg.eigh(a)
    np.testing.assert_allclose(w.numpy(), wr, rtol=0, atol=1e-12)
    recon = np.einsum("bij,bj,bkj->bik", v.numpy(), w.numpy(), v.numpy())
    np.testing.assert_allclose(recon, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dead", ["none", "w", "p"])
def test_batched_rr3_matches_jax(mat, dead):
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((NROOTS, N)) for _ in range(3)]
    x, w, p = (b / np.linalg.norm(b, axis=1, keepdims=True) for b in blocks)
    live_w = np.ones(NROOTS, bool)
    live_p = np.ones(NROOTS, bool)
    if dead == "w":
        live_w[1] = False
        w[1] = 0.0
    elif dead == "p":
        live_p[::2] = False
        p[::2] = 0.0
    args = (x, x @ mat, w, w @ mat, p, p @ mat)
    ref = J._batched_rr3(*[jnp.asarray(a) for a in args], jnp.asarray(live_w),
                         jnp.asarray(live_p), NROOTS)
    got = T._batched_rr3(*[torch.from_numpy(a) for a in args], torch.from_numpy(live_w),
                         torch.from_numpy(live_p), NROOTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_run_on_device_matches_jax(mat):
    js, ts = _pair(mat)
    v0 = _guess(mat)
    je, jx, jerr, jit = js.run_on_device(v0)
    te, tx, terr, tit = ts.run_on_device(v0)
    assert tit == int(jit)
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float64
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-10)
    np.testing.assert_allclose(terr, jerr, rtol=0, atol=1e-9)
    assert np.max(terr) <= 1e-9
    sign = np.sign(np.sum(np.asarray(jx) * tx.numpy(), axis=1))
    np.testing.assert_allclose(tx.numpy() * sign[:, None], np.asarray(jx), rtol=0, atol=1e-7)
    np.testing.assert_allclose(te, np.linalg.eigvalsh(mat)[:NROOTS], rtol=0, atol=1e-9)


@pytest.mark.parametrize("rr_every", [1, 3, 8])
def test_solve_history_matches_jax(mat, rr_every):
    js, ts = _pair(mat)
    v0 = _guess(mat)
    jsolve = J.make_ppcg_solve(js.matvec, NROOTS, rr_every, history=40)
    tsolve = T.make_ppcg_solve(ts.matvec, NROOTS, rr_every, history=40)
    jf, jit, jh = jsolve(js.init_state(v0), js.operand, js.diag, 1e-9, 300)
    tf, tit, th = tsolve(ts.init_state(v0), ts.operand, ts.diag, 1e-9, 300)
    assert tit == int(jit)
    assert tf.it == int(jf.it) == tit
    jh, th = np.asarray(jh), th.numpy()
    assert np.isnan(th).tolist() == np.isnan(jh).tolist()
    live = ~np.isnan(jh)
    np.testing.assert_allclose(th[live], jh[live], rtol=0, atol=1e-9 * jh[0])
    np.testing.assert_allclose(tf.evals.numpy(), np.asarray(jf.evals), rtol=0, atol=1e-10)


def test_max_iter_exit_matches_jax(mat):
    js, ts = _pair(mat)
    v0 = _guess(mat)
    jsolve = J.make_ppcg_solve(js.matvec, NROOTS, RR_EVERY, history=3)
    tsolve = T.make_ppcg_solve(ts.matvec, NROOTS, RR_EVERY, history=3)
    jf, jit, jh = jsolve(js.init_state(v0), js.operand, js.diag, 1e-14, 5)
    tf, tit, th = tsolve(ts.init_state(v0), ts.operand, ts.diag, 1e-14, 5)
    assert tit == int(jit) == 5
    # the last slot keeps the latest value past the buffer's length
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-9)
    # the returned Rayleigh data is refreshed for the returned rows
    np.testing.assert_allclose(tf.evals.numpy(), np.asarray(jf.evals), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tf.errors.numpy(), np.asarray(jf.errors), rtol=0, atol=1e-10)
    assert np.max(tf.errors.numpy()) > 1e-14


def test_step_from_a_converted_jax_state(mat):
    js, ts = _pair(mat)
    jstate = js.init_state(_guess(mat))
    jstep = J.make_ppcg_step(js.matvec, NROOTS, RR_EVERY)
    for _ in range(3):
        jstate = jstep(jstate, js.operand, js.diag)
    fields = [np.asarray(f) for f in jstate]
    tstate = convert.ppcg_state(*fields, device="cpu")
    assert tstate.it == 3
    jnext = jstep(jstate, js.operand, js.diag)   # it 4: a full RR step
    tnext = T.make_ppcg_step(ts.matvec, NROOTS, RR_EVERY)(tstate, ts.operand, ts.diag)
    assert tnext.it == int(jnext.it) == 4
    for name in ("x", "ax", "p", "ap", "evals", "errors"):
        ref = np.asarray(getattr(jnext, name))
        got = getattr(tnext, name).numpy()
        if name in ("x", "ax", "p", "ap"):  # rows up to the eigh's sign choice
            sign = np.sign(np.sum(np.asarray(jnext.x) * tnext.x.numpy(), axis=1))
            got = got * sign[:, None]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10 * max(1.0, np.abs(ref).max()))


def test_subnormal_correction_is_dropped_in_float32():
    """Root 0 sits on coordinate 0 (diagonal 1.0) and couples to coordinate
    5 (diagonal 0.5, lower) by 1e-21, a normal float32. The correction row
    is then ~2e-21 and its squared norm ~4e-42, subnormal: XLA reads it as
    zero and drops the direction, so root 0 stays on coordinate 0. Were the
    subnormal norm live, the 3x3 Rayleigh-Ritz would swing root 0 onto the
    lower coordinate 5."""
    n = 16
    d = np.arange(n, dtype=np.float64) + 1.0
    d[5] = 0.5
    a = np.diag(d)
    a[0, 5] = a[5, 0] = 1e-21
    a32 = a.astype(np.float32)
    x = np.zeros((2, n), np.float32)
    x[0, 0] = x[1, 1] = 1.0
    ax = x @ a32
    zeros = np.zeros_like(x)
    d32 = d.astype(np.float32)
    assert 0.0 < float(np.sum((ax[0] - x[0] * d32[0]) ** 2)) < np.finfo(np.float32).tiny

    jstep = J.make_ppcg_step(_dense_matvec, 2, 100)
    jstate = J.PPCGState(*(jnp.asarray(v) for v in (x, ax, zeros, zeros)),
                         jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.float32),
                         jnp.asarray(0, jnp.int32))
    jnext = jstep(jstate, jnp.asarray(a32), jnp.asarray(d32))
    tstate = T.PPCGState(*(torch.from_numpy(v.copy()) for v in (x, ax, zeros, zeros)),
                         torch.zeros(2), torch.zeros(2), 0)
    tnext = T.make_ppcg_step(_dense_matvec, 2, 100)(
        tstate, torch.from_numpy(a32), torch.from_numpy(d32))
    assert tnext.x.dtype == torch.float32
    assert abs(float(np.asarray(jnext.x)[0, 0])) > 0.999   # the reference keeps root 0
    np.testing.assert_allclose(tnext.x.numpy(), np.asarray(jnext.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnext.p.numpy(), np.asarray(jnext.p), rtol=0, atol=1e-6)


def test_floors_in_float32():
    assert T._floor(1e-300, torch.float32) == 0.0
    assert T._floor(1e-300, torch.float64) == 1e-300
    assert T._floor(1e-4, torch.float32) == float(np.float32(1e-4))
    t = torch.tensor([0.0, 1e-40, 1e-30, -1e-40], dtype=torch.float32)
    assert T._flush(t).tolist() == [0.0, 0.0, float(np.float32(1e-30)), 0.0]


INT8_TOL = {"int8": 5e-3, "int8_precise": 1e-4}


@pytest.mark.parametrize("tier", sorted(INT8_TOL))
def test_from_dense_int8_tiers_match_jax(tier):
    mat = _matrix(192, seed=50)
    kw = dict(tier=tier, b=64, rr_every=4, convergence_threshold=INT8_TOL[tier],
              max_iter=400)
    js = J.FusedPPCG.from_dense_symmetric(mat, 3, **kw)
    ts = T.FusedPPCG.from_dense_symmetric(mat, 3, device="cpu", **kw)
    assert ts.n == js.n == 192 and ts.dtype == torch.float64
    v0 = _guess(mat, 3)
    je, _, jerr, jit = js.run_on_device(v0)
    te, tx, terr, tit = ts.run_on_device(v0)
    assert abs(tit - int(jit)) <= 2
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-5)
    assert np.max(terr) <= INT8_TOL[tier] and np.max(jerr) <= INT8_TOL[tier]
    assert ts.unpad(tx).shape == (3, 192)


def test_from_dense_pads_to_the_tile():
    mat = _matrix(150, seed=51)
    ts = T.FusedPPCG.from_dense_symmetric(mat, 2, tier="exact", b=64, device="cpu",
                                          convergence_threshold=1e-9)
    js = J.FusedPPCG.from_dense_symmetric(mat, 2, tier="exact", b=64,
                                          convergence_threshold=1e-9)
    assert ts.n == js.n == 192 and ts.n_orig == 150
    np.testing.assert_array_equal(ts.diag.numpy(), np.asarray(js.diag))
    te, tx, _, tit = ts.run_on_device(_guess(mat, 2))
    je, _, _, jit = js.run_on_device(_guess(mat, 2))
    assert tit == int(jit)
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-10)
    assert ts.unpad(tx).shape == (2, 150)


def test_bad_arguments_raise(mat):
    d = np.diag(mat).copy()
    with pytest.raises(ValueError, match="rr_every"):
        T.FusedPPCG(_dense_matvec, d, N, 2, rr_every=0, device="cpu")
    # sharding is ported (tests/test_torch_sharded_solvers.py); it takes a
    # parallel.mesh.Sharding and refuses anything else
    with pytest.raises(TypeError, match="Sharding"):
        T.FusedPPCG(_dense_matvec, d, N, 2, sharding=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FusedPPCG(_dense_matvec, d, N, 2)


def test_asymmetric_operator_is_refused():
    a = np.random.default_rng(52).standard_normal((64, 64))
    ts = T.FusedPPCG(_dense_matvec, np.diag(a).copy(), 64, 2, operand=torch.from_numpy(a),
                     device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        ts.run_on_device(_guess(a, 2))
