"""The port's dense int8 tiers (iterative_solver_torch/ops/kernels/
dense_int8.py) against the JAX package's, on the CPU with the same numpy
inputs, seeded from tests/test_dense_int8.py (not its sharded test).

- The host packing is numpy in both: q, q1, q2, gr, gc and d equal byte
  for byte.
- The actions: float32 in both, the int8 product exact in int32
  (``torch._int_mm`` here, XLA's int8 ``dot_general`` there), the epilogue
  in the same order: within 1e-6 relative (they come out equal).
- Solves through ``from_dense(tier=...)``: the int8 tiers' action is f32
  inside an f64 solve in both packages, so f64 solves take JAX's iteration
  counts, eigenvalues within 1e-10 (int8 solutions within 1e-6 of max|x|:
  basis rows that differ in their last bits can quantize to another int8
  at a rounding tie); float32 solves within 2 iterations of JAX's at tol
  1e-4, and at the two-plane floor converged with counts that split.
- The "fast" dense tier in float32 rounds x to bf16 (the TPU's default
  precision); JAX's CPU path does not (ROADMAP Queue 3): compared at its
  floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from iterative_solver_tpu.ops.kernels import dense_int8 as JD
from iterative_solver_tpu.solvers import fused_nonsym as J
from iterative_solver_torch.ops.kernels import dense_int8 as TD
from iterative_solver_torch.solvers import fused_nonsym as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_op(n=400, strength=0.15, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.linspace(1.0, 20.0, n))
    m[np.tril_indices(n, -1)] *= 1.0 - strength
    return m


def guess(m, r):
    v0 = np.zeros((r, m.shape[0]))
    for i, j in enumerate(np.argsort(np.diag(m))[:r]):
        v0[i, j] = 1.0
    return v0


TIERS = {"int8": (JD.DenseInt8, TD.DenseInt8, JD.dense_int8_matvec, TD.dense_int8_matvec),
         "int8_precise": (JD.DenseInt8Split, TD.DenseInt8Split, JD.dense_int8_matvec_split,
                          TD.dense_int8_matvec_split)}


@pytest.mark.parametrize("n,seed", [(400, 0), (64, 3), (200, 9)])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_packing_byte_identical(tier, n, seed):
    jcls, tcls, _, _ = TIERS[tier]
    m = make_op(n, seed=seed)
    jt, tt = jcls.from_dense(m).tree(), tcls.from_dense(m, device="cpu").tree()
    assert len(jt) == len(tt)
    for ja, ta in zip(jt, tt):
        ja = np.asarray(ja)
        assert ta.dtype == torch.int8 or ta.dtype == torch.float32
        assert ja.dtype == ta.numpy().dtype
        assert ja.tobytes() == ta.numpy().tobytes()


@pytest.mark.parametrize("rows", [1, 6, 16, 17, 40])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_action_matches_jax(tier, rows):
    jcls, tcls, jmv, tmv = TIERS[tier]
    m = make_op()
    x = np.random.default_rng(1).standard_normal((rows, m.shape[0]))
    for dtype in (np.float32, np.float64):
        yj = np.asarray(jmv(jnp.asarray(x, dtype), jcls.from_dense(m).tree()))
        yt = tmv(torch.as_tensor(x.astype(dtype)), tcls.from_dense(m, device="cpu").tree())
        assert yt.dtype == torch.from_numpy(x.astype(dtype)).dtype
        rel = np.abs(yt.numpy() - yj).max() / np.abs(yj).max()
        assert rel <= 1e-6, (dtype, rel)


@pytest.mark.parametrize("tier,bound", [("int8", 3e-4), ("int8_precise", 5e-6)])
def test_action_error_class(tier, bound):
    """One plane: the bf16 class, honestly lossy; two planes: the split-bf16
    class."""
    _, tcls, _, tmv = TIERS[tier]
    m = make_op()
    x = np.random.default_rng(1).standard_normal((6, m.shape[0]))
    ref = x @ m.T
    y = tmv(torch.as_tensor(x, dtype=torch.float32), tcls.from_dense(m, device="cpu").tree())
    rel = np.linalg.norm(y.double().numpy() - ref) / np.linalg.norm(ref)
    assert rel < bound
    if tier == "int8":
        assert rel > 1e-7


def test_exact_diagonal_preserved():
    d = np.linspace(-3.0, 25.0, 64)
    y = TD.dense_int8_matvec(torch.eye(64, dtype=torch.float32),
                             TD.DenseInt8.from_dense(np.diag(d), device="cpu").tree())
    np.testing.assert_allclose(y.double().numpy(), np.diag(d), atol=1e-5)


def test_int8_dot_pads_rows_and_is_exact():
    rng = np.random.default_rng(2)
    for m in (1, 16, 33):
        a = torch.as_tensor(rng.integers(-127, 128, (m, 64)), dtype=torch.int8)
        b = torch.as_tensor(rng.integers(-127, 128, (24, 64)), dtype=torch.int8)
        got = TD._int8_dot(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, 24)
        assert torch.equal(got, (a.long() @ b.long().T).int())
    with pytest.raises(ValueError, match="int8"):
        TD._int8_dot(a.float(), b)


def test_refusals():
    from iterative_solver_torch.ops.kernels.symm_int8 import _check_acc_headroom

    with pytest.raises(ValueError, match="headroom"):
        _check_acc_headroom(200000, 200000, 1, "DenseInt8")
    with pytest.raises(ValueError, match="headroom"):
        _check_acc_headroom(100000, 100000, 2, "DenseInt8Split")
    with pytest.raises(ValueError, match="square"):
        TD.DenseInt8.from_dense(np.ones((4, 5)), device="cpu")
    # shard() is ported (tests/test_torch_sharded_families.py) and takes a
    # parallel.mesh.Mesh
    with pytest.raises(TypeError, match="Mesh"):
        TD.DenseInt8Split.from_dense(np.eye(8), device="cpu").shard(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.DenseInt8.from_dense(np.eye(8))


# ---------------------------------------------------------------------------
# solves through from_dense


def _both(cls_name, m, r, tier, **kw):
    jcls, tcls = getattr(J, cls_name), getattr(T, cls_name)
    jd = kw.pop("jdtype", None)
    td = kw.pop("tdtype", None)
    return (jcls.from_dense(m, r, tier=tier, dtype=jd, **kw),
            tcls.from_dense(m, r, tier=tier, dtype=td, device="cpu", **kw))


@pytest.mark.parametrize("rr", ["host", "device"])
@pytest.mark.parametrize("tier", ["precise", "fast", "int8", "int8_precise"])
def test_eigen_tiers_f64_match_jax(tier, rr):
    """float64: every tier's iteration count and eigenvalues are JAX's (the
    int8 tiers' action is the same f32 arithmetic in both)."""
    m = make_op(seed=1)
    tol = {"int8": 5e-4, "int8_precise": 5e-5}.get(tier, 1e-9)
    js, ts = _both("FusedNonSymDavidson", m, 4, tier, convergence_threshold=tol,
                   max_iter=120, rr=rr, m_max=16)
    jev, _, jerr, jit = js.solve(guess(m, 4))
    tev, _, terr, tit = ts.solve(guess(m, 4))
    assert tit == jit, (tit, jit)
    np.testing.assert_allclose(np.sort_complex(tev), np.sort_complex(jev), atol=1e-10)
    assert terr.max() <= tol


@pytest.mark.parametrize("rr", ["host", "device"])
def test_int8_precise_eigen_f32(rr):
    """float32 at tol 1e-4: within 2 iterations of JAX (both take 6). At
    the two-plane floor (tol 5e-5, the JAX test's) both converge in under
    60 iterations, but the counts split (host 18 and 42, device 36 and 18:
    the f32 sums round in other orders; ROADMAP Queue 3)."""
    m = make_op()
    ref = np.sort(scipy.linalg.eigvals(m).real)[:4]
    for tol in (1e-4, 5e-5):
        js, ts = _both("FusedNonSymDavidson", m, 4, "int8_precise", jdtype=jnp.float32,
                       tdtype=torch.float32, convergence_threshold=tol, max_iter=120, rr=rr)
        jev, _, jerr, jit = js.solve(guess(m, 4))
        tev, _, terr, tit = ts.solve(guess(m, 4))
        assert terr.max() <= tol and tit < 60, (terr, tit)
        if tol == 1e-4:
            assert abs(tit - jit) <= 2, (tit, jit)
        assert np.max(np.abs(np.sort(tev.real) - ref[:len(tev)])) < 1e-4


def test_int8_one_plane_floor_is_action_noise():
    m = make_op()
    ref = np.sort(scipy.linalg.eigvals(m).real)[:4]
    js, ts = _both("FusedNonSymDavidson", m, 4, "int8", jdtype=jnp.float32,
                   tdtype=torch.float32, convergence_threshold=1e-8, max_iter=40, rr="device")
    jev, _, jerr, _ = js.solve(guess(m, 4))
    tev, _, terr, _ = ts.solve(guess(m, 4))
    for ev, errs in ((tev, terr), (jev, np.asarray(jerr))):
        assert 1e-6 < errs.max() < 1e-3, errs
        assert np.max(np.abs(np.sort(np.asarray(ev).real) - ref[:len(ev)])) < 5e-3


def test_fast_tier_f32_rounds_x_and_floors():
    """float32 "fast": bf16 storage and bf16 x (the TPU's default
    precision); JAX's CPU path keeps x in f32. Both converge at 5e-3 and
    agree on the eigenvalues to the bf16 class."""
    m = make_op()
    ref = np.sort(scipy.linalg.eigvals(m).real)[:4]
    js, ts = _both("FusedNonSymDavidson", m, 4, "fast", jdtype=jnp.float32,
                   tdtype=torch.float32, convergence_threshold=5e-3, max_iter=60, rr="device")
    assert ts.operand.dtype == torch.bfloat16
    jev, _, jerr, jit = js.solve(guess(m, 4))
    tev, _, terr, tit = ts.solve(guess(m, 4))
    assert terr.max() <= 5e-3 and np.asarray(jerr).max() <= 5e-3
    np.testing.assert_allclose(np.sort(tev.real), np.sort(np.asarray(jev).real), atol=5e-3)
    assert np.max(np.abs(np.sort(tev.real) - ref)) < 5e-3
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((4, 400)),
                        dtype=torch.float32)
    y = ts.matvec(x, ts.operand)
    xb = x.to(torch.bfloat16).double()
    ref_y = xb @ ts.operand.double().T
    assert y.dtype == torch.float32
    assert float((y.double() - ref_y).abs().max() / ref_y.abs().max()) < 1e-6


@pytest.mark.parametrize("rr", ["host", "device"])
def test_int8_precise_lineq(rr):
    m = make_op(seed=3)
    b = np.random.default_rng(4).standard_normal((3, m.shape[0]))
    refx = np.linalg.solve(m, b.T).T
    for jd, td, tol in ((None, None, 1e-5), (jnp.float32, torch.float32, 1e-5)):
        js, ts = _both("FusedNonSymLinearEquations", m, 3, "int8_precise", jdtype=jd,
                       tdtype=td, convergence_threshold=tol, max_iter=120, rr=rr)
        jx, jerr, jit = js.solve(b)
        tx, terr, tit = ts.solve(b)
        assert terr.max() <= tol, terr
        if td is None:
            # f64 basis rows that differ in their last bits can quantize to
            # another int8 at a rounding tie: solutions agree to the action's
            # f32 class
            assert tit == jit
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                       atol=1e-6 * np.abs(refx).max())
        else:
            assert abs(tit - jit) <= 2, (tit, jit)
        rel = np.linalg.norm(tx.double().numpy() - refx) / np.linalg.norm(refx)
        assert rel < 5e-5, rel


@pytest.mark.filterwarnings("ignore::UserWarning")   # _int_mm has no batching rule
def test_batched_nonsym_with_int8_trees():
    """Stacked int8 trees through the batched solve (``torch._int_mm`` runs
    once per element under vmap): the iteration counts and eigenvalues of
    JAX's, at the two-plane floor."""
    B, n, r = 3, 200, 2
    rng = np.random.default_rng(0)
    mats, diags, v0s = [], [], []
    for b in range(B):
        a = rng.standard_normal((n, n)) * (0.04 / np.sqrt(n))
        m = a + a.T + np.diag(np.linspace(1.0 + 0.3 * b, 18.0, n))
        m[np.tril_indices(n, -1)] *= 0.9
        mats.append(m)
        diags.append(np.diag(m).copy())
        v0s.append(guess(m, r))
    jtree = tuple(jnp.stack([JD.DenseInt8Split.from_dense(m).tree()[i] for m in mats])
                  for i in range(5))
    ttree = tuple(torch.stack([TD.DenseInt8Split.from_dense(m, device="cpu").tree()[i]
                               for m in mats]) for i in range(5))
    binit, bsolve = J.make_batched_nonsym_solve(
        lambda x, t: JD.dense_int8_matvec_split(x, t), r, 10)
    jout = bsolve(*binit(jnp.asarray(np.stack(v0s), jnp.float32), jtree), jtree,
                  jnp.asarray(np.stack(diags), jnp.float32), 5e-4, 100)
    jev = J.finalize_nonsym_batch(jout[3], jout[4], jout[5])[0]
    tinit, tsolve = T.make_batched_nonsym_solve(TD.dense_int8_matvec_split, r, 10)
    tout = tsolve(*tinit(torch.as_tensor(np.stack(v0s), dtype=torch.float32), ttree), ttree,
                  torch.as_tensor(np.stack(diags), dtype=torch.float32), 5e-4, 100)
    tev, _, terr = T.finalize_nonsym_batch(tout[3], tout[4], tout[5])
    assert np.all(np.abs(tout[6].numpy() - np.asarray(jout[6])) <= 2 * ((10 - r) // r))
    for b in range(B):
        assert np.max(terr[b]) <= 5e-4, (b, terr[b])
        ref = np.sort(scipy.linalg.eigvals(mats[b]).real)[:r]
        assert np.max(np.abs(np.sort(tev[b].real) - ref)) <= 1e-3
        np.testing.assert_allclose(np.sort(tev[b].real), np.sort(jev[b].real), atol=1e-4)
