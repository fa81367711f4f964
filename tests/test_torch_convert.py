"""Carrying the JAX package's objects across into the port
(iterative_solver_torch/convert.py): packed operators bit for bit, a
DavidsonState field by field, and one step from the carried state against
the JAX package's ``make_davidson_step``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops.kernels import symm_pallas as JS
from iterative_solver_tpu.solvers import fused_davidson as JF
from iterative_solver_torch import convert
from iterative_solver_torch.ops.kernels import symm as TS
from iterative_solver_torch.solvers import fused_davidson as TF
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, B, NROOTS, M_MAX = 256, 64, 3, 12


def _matrix(n=N, seed=4):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 16), np.linspace(6.0, 50.0, n - 16)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


def _fields(sym, names):
    return {k: np.asarray(getattr(sym, k)) for k in names}


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32, jnp.bfloat16])
def test_symmetric_blocked_carries_bit_for_bit(dtype):
    mat = _matrix()
    js = JS.SymmetricBlocked.from_dense(mat, b=B, dtype=dtype)
    got = convert.symmetric_blocked(**_fields(js, ("values", "ii", "jj", "diagonal")),
                                    shape=js.shape, b=js.b, device="cpu")
    own = TS.SymmetricBlocked.from_dense(mat, b=B, dtype=got.values.dtype, device="cpu")
    assert got.values.dtype == {jnp.float64: torch.float64, jnp.float32: torch.float32,
                                jnp.bfloat16: torch.bfloat16}[dtype]
    for name in ("values", "ii", "jj", "diagonal"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    assert got.shape == own.shape and got.b == own.b
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, N)))
    assert torch.equal(TS.symm_matmat(x, got), TS.symm_matmat(x, own))


def test_symmetric_blocked_split_carries_bit_for_bit():
    mat = _matrix()
    js = JS.SymmetricBlockedSplit.from_dense(mat, b=B)
    got = convert.symmetric_blocked_split(
        **_fields(js, ("hi", "lo", "ii", "jj", "diagonal")), shape=js.shape, b=js.b,
        device="cpu")
    own = TS.SymmetricBlockedSplit.from_dense(mat, b=B, device="cpu")
    for name in ("hi", "lo", "ii", "jj", "diagonal"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    x = np.random.default_rng(1).standard_normal((2, N)).astype(np.float32)
    y = TS.symm_matmat_split(torch.from_numpy(x), got).numpy()
    y_jax = np.asarray(JS.symm_matmat_split(jnp.asarray(x), js))
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-6 * np.abs(y_jax).max())


def _state_arrays(state):
    return {f: (None if getattr(state, f) is None else np.asarray(getattr(state, f)))
            for f in state._fields}


def _jax_operator(mat):
    js = JS.SymmetricBlocked.from_dense(mat, b=B)
    nb = js.shape[0] // B

    def matvec(x, op):
        return JS._symm_matmat_xla(x, op[0], (op[1], op[2]), B, nb)

    return js, (js.values, js.ii, js.jj), matvec


def _torch_operator(js):
    ts = convert.symmetric_blocked(**_fields(js, ("values", "ii", "jj", "diagonal")),
                                   shape=js.shape, b=js.b, device="cpu")

    def matvec(x, op):
        return TS.symm_matmat(x, dataclasses.replace(ts, values=op[0], ii=op[1], jj=op[2]))

    return (ts.values, ts.ii, ts.jj), matvec


def test_davidson_state_carries_across():
    mat = _matrix()
    js, jop, jmv = _jax_operator(mat)
    v0 = np.eye(NROOTS, N)
    jstate = JF.make_davidson_init(jmv, NROOTS, M_MAX)(jnp.asarray(v0), jop)
    tstate = convert.davidson_state(**_state_arrays(jstate), device="cpu")
    assert isinstance(tstate.k, int) and tstate.k == int(jstate.k)
    for f in jstate._fields:
        if f == "k":
            continue
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)))
    # the port's own init from the same guess lands on the same state
    top, tmv = _torch_operator(js)
    own = TF.make_davidson_init(tmv, NROOTS, M_MAX)(torch.from_numpy(v0), top)
    for f in jstate._fields:
        if f != "k":
            np.testing.assert_allclose(getattr(own, f).numpy(), getattr(tstate, f).numpy(),
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("rr,fuse", [("full", False), ("window", False),
                                     ("window3", True), ("anchored", False)])
def test_one_step_from_carried_state_matches_jax(rr, fuse):
    mat = _matrix()
    js, jop, jmv = _jax_operator(mat)
    top, tmv = _torch_operator(js)
    diag = np.diag(mat).copy()
    v0 = np.zeros((NROOTS, N))
    for row, i in enumerate(np.argsort(diag)[:NROOTS]):
        v0[row, i] = 1.0
    jstate = JF.make_davidson_init(jmv, NROOTS, M_MAX)(jnp.asarray(v0), jop)
    jstep = JF.make_davidson_step(jmv, NROOTS, M_MAX, rr=rr, fuse_chain=fuse)
    jstate = jstep(jstate, jop, jnp.asarray(diag), 1)  # a carried state mid-solve
    tstate = convert.davidson_state(**_state_arrays(jstate), device="cpu")
    tstep = TF.make_davidson_step(tmv, NROOTS, M_MAX, rr=rr, fuse_chain=fuse)
    tnext = tstep(tstate, top, torch.from_numpy(diag), 2)
    jnext = jstep(jstate, jop, jnp.asarray(diag), 2)
    assert tnext.k == int(jnext.k)
    np.testing.assert_allclose(tnext.evals.numpy(), np.asarray(jnext.evals), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tnext.errors.numpy(), np.asarray(jnext.errors), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(tnext.mask.numpy(), np.asarray(jnext.mask))
    # the appended rows may differ by sign (LAPACK eigenvector signs): the
    # Ritz block's projector is sign-free
    px_t = tnext.x.T @ tnext.x
    px_j = np.asarray(jnext.x).T @ np.asarray(jnext.x)
    np.testing.assert_allclose(px_t.numpy(), px_j, rtol=0, atol=1e-10)
    pv_t = tnext.v.T @ tnext.v
    pv_j = np.asarray(jnext.v).T @ np.asarray(jnext.v)
    np.testing.assert_allclose(pv_t.numpy(), pv_j, rtol=0, atol=1e-10)


def _unplaced_constructors():
    """Every packed-storage constructor of the port, each called without
    ``device``, on small inputs."""
    from iterative_solver_torch.array.basis_store import BasisStore
    from iterative_solver_torch.models import synthetic_fci
    from iterative_solver_torch.ops.kernels import spmv, symm_int8
    from iterative_solver_torch.solvers._symmetry import check_symmetric_operator
    from iterative_solver_torch.subspace.xspace import XSpace

    mat = _matrix(64)
    z8 = np.zeros((1, 32, 32), dtype=np.int8)
    f32 = np.zeros(64, dtype=np.float32)
    idx = np.zeros(1, dtype=np.int32)
    return {
        "SymmetricBlocked.from_dense": lambda: TS.SymmetricBlocked.from_dense(mat, b=32),
        "SymmetricBlockedSplit.from_dense":
            lambda: TS.SymmetricBlockedSplit.from_dense(mat, b=32),
        "SymmetricBlockedInt8.from_dense":
            lambda: symm_int8.SymmetricBlockedInt8.from_dense(mat, b=32),
        "SymmetricBlockedInt8Split.from_dense":
            lambda: symm_int8.SymmetricBlockedInt8Split.from_dense(mat, b=32),
        "make_int8_matvec": lambda: symm_int8.make_int8_matvec(mat, b=32),
        "synthetic_packed_int8": lambda: synthetic_fci.synthetic_packed_int8(64, b=32),
        "convert.tensor_from_numpy": lambda: convert.tensor_from_numpy(f32),
        "convert.symmetric_blocked":
            lambda: convert.symmetric_blocked(z8, idx, idx, (32, 32), 32),
        "convert.symmetric_blocked_split":
            lambda: convert.symmetric_blocked_split(z8, z8, idx, idx, (32, 32), 32),
        "convert.symmetric_blocked_int8":
            lambda: convert.symmetric_blocked_int8(z8, f32[:32], idx, idx, (32, 32), 32),
        "convert.symmetric_blocked_int8_split": lambda: convert.symmetric_blocked_int8_split(
            z8, z8, f32[:32], idx, idx, (32, 32), 32),
        "convert.bsr": lambda: convert.bsr(z8, idx, idx, np.array([0, 1], np.int32),
                                           (32, 32), 32, 32),
        "convert.bsr_int8": lambda: convert.bsr_int8(
            z8, f32[:32], f32[:32], idx, idx, np.array([0, 1], np.int32), (32, 32), 32, 32),
        "convert.ppcg_state": lambda: convert.ppcg_state(f32, f32, f32, f32, f32, f32, 0),
        "convert.davidson_state": lambda: convert.davidson_state(
            f32, f32, f32, 0, f32, f32, f32, f32),
        "BSRMatrix.from_dense": lambda: spmv.BSRMatrix.from_dense(mat, bm=32),
        "BasisStore": lambda: BasisStore(4, 64),
        "XSpace": lambda: XSpace(64),
        "check_symmetric_operator": lambda: check_symmetric_operator(
            lambda x, op: x, None, (2, 64), torch.float64, "solver", "hint"),
    }


@pytest.mark.parametrize("name", sorted(_unplaced_constructors()))
def test_constructors_default_to_cuda(name):
    """Called without ``device``, each constructor puts its tensors on the
    card, so where CUDA is absent it raises and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        _unplaced_constructors()[name]()
