"""The port's FusedDavidson (iterative_solver_torch/solvers/fused_davidson.py)
against the JAX package's, on the CPU with the same matrix and guesses.

The matrix is the bench spectrum cut to n=384 (gapped low block, dense
weak couplings), packed in b=128 tiles; 4 roots, m_max 16; the guess is
bench.py's one-hot block on the lowest diagonal entries.

- "exact" and "fast" run f64 arithmetic on the CPU ("fast" on bf16 tiles),
  so both packages take the same steps: eigenvalues equal to 1e-10, errors
  to 1e-8, the same iteration count, Ritz vectors equal up to a row sign.
- "precise" runs its action in f32 (as the JAX package does off the TPU),
  so the two drift apart at the f32 level: eigenvalues equal to 1e-5 and
  iteration counts within 2, at the per-tier residual tolerance 1e-4.
- "int8" and "int8_precise" quantize and act in f32 in both packages, so
  they keep the "precise" rule: eigenvalues equal to 1e-5 and iteration
  counts within 2, at residual tolerances 5e-3 and 1e-4.
"""

import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import fused_davidson as J
from iterative_solver_torch.solvers import fused_davidson as T

N, B, NROOTS, M_MAX = 384, 128, 4, 16
TOL = {"exact": 1e-9, "fast": 1e-9, "precise": 1e-4}


def _matrix(n=N, seed=0):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


def _guess(mat, nroots=NROOTS):
    v0 = np.zeros((nroots, mat.shape[0]))
    for row, i in enumerate(np.argsort(np.diag(mat))[:nroots]):
        v0[row, i] = 1.0
    return v0


@pytest.fixture(scope="module")
def mat():
    return _matrix()


def _pair(mat, tier, **kw):
    kw = dict(tier=tier, b=B, m_max=M_MAX, convergence_threshold=TOL[tier],
              max_iter=200, **kw)
    return (J.FusedDavidson.from_dense_symmetric(mat, NROOTS, **kw),
            T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", **kw))


def _drive(solver, driver, v0):
    if driver == "run":
        return solver.run(v0)
    if driver == "run_fast":
        return solver.run_fast(v0)
    return solver.run_on_device(v0, chunked=(driver == "chunked"))


def _compare(tier, jres, tres):
    je, jx, jerr, jit = jres
    te, tx, terr, tit = tres
    assert isinstance(te, np.ndarray) and isinstance(terr, np.ndarray)
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float64
    assert np.max(terr) <= TOL[tier] and np.max(jerr) <= TOL[tier]
    if tier == "precise":
        np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-5)
        assert abs(int(jit) - tit) <= 2
        return
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-10)
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=0, atol=1e-8)
    assert tit == int(jit)
    jx, tx = np.asarray(jx), tx.numpy()
    sign = np.sign(np.sum(jx * tx, axis=1))
    assert np.all(sign != 0)
    np.testing.assert_allclose(tx * sign[:, None], jx, rtol=0, atol=1e-7)


@pytest.mark.parametrize("rr", ["full", "window", "window3", "anchored"])
@pytest.mark.parametrize("tier", ["exact", "fast", "precise"])
def test_run_on_device_matches_jax(mat, tier, rr):
    js, ts = _pair(mat, tier, rr=rr, fuse_chain=False)
    v0 = _guess(mat)
    _compare(tier, js.run_on_device(v0), ts.run_on_device(v0))
    ref = np.linalg.eigvalsh(mat)[:NROOTS]
    band = {"exact": 1e-8, "fast": 5e-2, "precise": 1e-4}[tier]
    np.testing.assert_allclose(np.sort(ts.run_on_device(v0)[0]), ref, atol=band)


@pytest.mark.parametrize("tier,rr", [("exact", "full"), ("fast", "window"),
                                     ("precise", "window3")])
def test_fused_chain_matches_jax(mat, tier, rr):
    """fuse_chain=True: the port's chain wrapper (plain on the CPU) against
    the JAX package's interpreted chain kernel, through the whole solve."""
    js, ts = _pair(mat, tier, rr=rr, fuse_chain=True)
    assert ts.fuse_chain is True
    v0 = _guess(mat)
    _compare(tier, js.run_on_device(v0), ts.run_on_device(v0))


@pytest.mark.parametrize("driver", ["run", "chunked", "run_fast"])
def test_drivers_match_jax(mat, driver):
    js, ts = _pair(mat, "exact", rr="window")
    v0 = _guess(mat)
    _compare("exact", _drive(js, driver, v0), _drive(ts, driver, v0))
    assert ts.iterations == js.iterations
    assert ts.matvecs == js.matvecs


def test_history_matches_jax(mat):
    js, ts = _pair(mat, "exact", rr="full")
    v0 = _guess(mat)
    jsolve = J.make_davidson_solve(js.matvec, NROOTS, M_MAX, history=12)
    tsolve = T.make_davidson_solve(ts.matvec, NROOTS, M_MAX, history=12)
    jfinal, jit, jh = jsolve(js.init_state(v0), js.operand, js.diag, 1e-9, 200)
    tfinal, tit, th = tsolve(ts.init_state(v0), ts.operand, ts.diag, 1e-9, 200)
    assert tit == int(jit)
    jh = np.asarray(jh)
    assert np.isnan(th.numpy()).tolist() == np.isnan(jh).tolist()
    live = ~np.isnan(jh)
    np.testing.assert_allclose(th.numpy()[live], jh[live], rtol=1e-6, atol=1e-13)


def test_padded_dimension_matches_jax():
    mat = _matrix(300, seed=1)
    kw = dict(tier="exact", b=B, m_max=M_MAX, convergence_threshold=1e-9, max_iter=200)
    js = J.FusedDavidson.from_dense_symmetric(mat, NROOTS, **kw)
    ts = T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", **kw)
    assert ts.n == js.n == 384 and ts.n_orig == 300
    np.testing.assert_array_equal(ts.diag.numpy(), np.asarray(js.diag))
    v0 = _guess(mat)
    _compare("exact", js.run_on_device(v0), (tres := ts.run_on_device(v0)))
    x = tres[1]
    assert ts.unpad(x).shape == (NROOTS, 300)
    assert float(x[:, 300:].abs().max()) < 1e-12


def test_window_sign_flip_keeps_subspace(mat):
    """LAPACK and cuSOLVER may return eigenvectors of opposite sign. The
    window mode carries the Ritz coefficients ``c`` forward, so a flipped
    column of ``c`` must not change the next step's subspace: the same
    eigenvalues and errors, Ritz vectors up to sign."""
    ts = T.FusedDavidson.from_dense_symmetric(
        mat, NROOTS, tier="exact", b=B, m_max=M_MAX, rr="window", device="cpu")
    state = ts.init_state(_guess(mat))
    for it in range(2):
        state = ts.step(state, ts.operand, ts.diag, it)
    flip = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=torch.float64)
    flipped = state._replace(v=state.v.clone(), w=state.w.clone(), c=state.c * flip)
    a = ts.step(state, ts.operand, ts.diag, 2)
    b = ts.step(flipped, ts.operand, ts.diag, 2)
    np.testing.assert_allclose(b.evals.numpy(), a.evals.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.errors.numpy(), a.errors.numpy(), rtol=0, atol=1e-12)
    sign = torch.sign(torch.sum(a.x * b.x, dim=1))
    np.testing.assert_allclose((b.x * sign[:, None]).numpy(), a.x.numpy(), atol=1e-10)


def test_tile_size_rule():
    """The JAX package's rule: "fast" takes b=1024 only when it adds no zero
    padding over b=512; other tiers and awkward n stay at 512."""
    rng = np.random.default_rng(30)
    for n, tier, n_pad in ((1500, "fast", 1536), (2048, "fast", 2048), (1100, "exact", 1536)):
        a = rng.standard_normal((n, n)) * 0.01
        s = T.FusedDavidson.from_dense_symmetric(a + a.T, 1, tier=tier, device="cpu")
        assert s.n == n_pad
    a = rng.standard_normal((2048, 2048)) * 0.01
    s = T.FusedDavidson.from_dense_symmetric(a + a.T, 1, tier="fast", device="cpu")
    assert s.operand[0].shape[1:] == (1024, 1024)


INT8_TOL = {"int8": 5e-3, "int8_precise": 1e-4}


def _compare_int8(tier, jres, tres, mat):
    je, jx, jerr, jit = jres
    te, tx, terr, tit = tres
    assert tx.dtype == torch.float64
    assert np.max(terr) <= INT8_TOL[tier] and np.max(np.asarray(jerr)) <= INT8_TOL[tier]
    assert abs(int(jit) - tit) <= 2
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-5)
    # the f64 Rayleigh quotients of the Ritz vectors against the true matrix
    xs = tx.numpy()[:, : mat.shape[0]]
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ mat), axis=1))
    np.testing.assert_allclose(rq, np.linalg.eigvalsh(mat)[:NROOTS], rtol=0,
                               atol=1e-5 if tier == "int8" else 1e-8)


@pytest.mark.parametrize("rr", ["full", "window", "anchored"])
@pytest.mark.parametrize("tier", ["int8", "int8_precise"])
def test_int8_tiers_match_jax(mat, tier, rr):
    kw = dict(tier=tier, b=B, m_max=M_MAX, convergence_threshold=INT8_TOL[tier],
              max_iter=200, rr=rr, fuse_chain=False)
    js = J.FusedDavidson.from_dense_symmetric(mat, NROOTS, **kw)
    ts = T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", **kw)
    v0 = _guess(mat)
    _compare_int8(tier, js.run_on_device(v0), ts.run_on_device(v0), mat)


@pytest.mark.parametrize("tier,rr", [("int8", "window"), ("int8_precise", "anchored")])
def test_int8_fused_chain_matches_jax(mat, tier, rr):
    """bench.py's int8 legs: the fused chain on, "window" for "int8" and
    "anchored" with anchor_every=2 for "int8_precise"."""
    kw = dict(tier=tier, b=B, m_max=M_MAX, convergence_threshold=INT8_TOL[tier],
              max_iter=200, rr=rr, fuse_chain=True, anchor_every=2)
    js = J.FusedDavidson.from_dense_symmetric(mat, NROOTS, **kw)
    ts = T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", **kw)
    v0 = _guess(mat)
    _compare_int8(tier, js.run_on_device(v0), ts.run_on_device(v0), mat)


@pytest.mark.parametrize("tier", ["int8", "int8_precise"])
def test_int8_operand_matches_jax(mat, tier):
    """The solver's operand (planes, scales, diagonal, topology) is
    byte-identical to the JAX solver's."""
    js = J.FusedDavidson.from_dense_symmetric(mat, NROOTS, tier=tier, b=B, m_max=M_MAX)
    ts = T.FusedDavidson.from_dense_symmetric(mat, NROOTS, tier=tier, b=B, m_max=M_MAX,
                                              device="cpu")
    assert len(ts.operand) == len(js.operand)
    for got, ref in zip(ts.operand, js.operand):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ts.diag.numpy(), np.asarray(js.diag))


@pytest.mark.parametrize("tier", ["int8", "int8_precise"])
def test_int8_tile_size_rule(tier):
    """The int8 tiers take b=1024 when it adds no padding over b=512."""
    rng = np.random.default_rng(31)
    for n, n_pad, b in ((1500, 1536, 512), (2048, 2048, 1024)):
        a = rng.standard_normal((n, n)) * 0.01
        s = T.FusedDavidson.from_dense_symmetric(a + a.T, 1, tier=tier, device="cpu")
        assert s.n == n_pad
        assert s.operand[0].shape[1:] == (b, b) and s.operand[0].dtype == torch.int8


def test_defaults_on_cpu(mat):
    ts = T.FusedDavidson.from_dense_symmetric(mat, 2, device="cpu")
    assert ts.dtype == torch.float64 and ts.fuse_chain is False
    assert ts.operand[0].dtype == torch.float64  # tier "exact" on the CPU


def test_default_device_raises_without_cuda(mat):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FusedDavidson.from_dense_symmetric(mat, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FusedDavidson(lambda x, op: x, np.ones(8), 8, 1, m_max=4)


@pytest.mark.parametrize("case", ["p_space", "p_actions", "sharding", "checkpoint",
                                  "resume", "batched"])
def test_unported_inputs_raise(mat, case, tmp_path):
    """The inputs that raised before P-space, checkpointing, the batched
    solve and sharding were ported are now accepted; sharding takes a
    parallel.mesh.Sharding (tests/test_torch_sharded_solvers.py drives it)
    and refuses anything else."""
    if case == "sharding":
        with pytest.raises(TypeError, match="Sharding"):
            T.FusedDavidson.from_dense_symmetric(mat, 2, device="cpu", sharding=object())
    elif case in ("p_space", "p_actions"):
        arg = {"p_space": [{0: 1.0}]}
        if case == "p_actions":
            arg["p_actions"] = mat[:1]
        ts = T.FusedDavidson.from_dense_symmetric(mat, 2, device="cpu", **arg)
        assert ts.n_p == 1 and (ts.p_action_rows is not None) == (case == "p_actions")
    elif case == "batched":
        binit, bsolve = T.make_batched_davidson_solve(lambda x, op: x @ op.T, 2, 8)
        assert callable(binit) and callable(bsolve)
    else:
        ts = T.FusedDavidson.from_dense_symmetric(mat, 2, device="cpu")
        path = str(tmp_path / "x.npz")
        if case == "checkpoint":
            ts.run_fast(_guess(mat, 2), checkpoint_path=path)
            assert (tmp_path / "x.npz").exists()
        else:
            with pytest.raises(FileNotFoundError):
                ts.resume_fast(path)


def test_bad_arguments_raise(mat):
    with pytest.raises(ValueError, match="tier"):
        T.FusedDavidson.from_dense_symmetric(mat, 2, tier="banana", device="cpu")
    with pytest.raises(ValueError, match="rr"):
        T.FusedDavidson.from_dense_symmetric(mat, 2, rr="nope", device="cpu")
    with pytest.raises(ValueError, match="m_max"):
        T.FusedDavidson.from_dense_symmetric(mat, 4, m_max=10, rr="window3", device="cpu")
