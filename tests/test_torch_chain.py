"""The port's expand chain (iterative_solver_torch/ops/kernels/chain.py)
against the JAX package's fused chain kernel K2 (ops/kernels/chain_pallas.py,
run in interpret mode on the CPU, as its own tests run it) and its
whitening, in f64 to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops.kernels import chain_pallas as J
from iterative_solver_torch.ops.kernels import chain as T


def _setup(nroots=4, m_max=12, n=256, seed=0):
    rng = np.random.default_rng(seed)
    v = np.linalg.qr(rng.standard_normal((n, m_max)))[0].T
    mask = np.zeros(m_max)
    mask[: m_max // 2] = 1.0
    v = v * mask[:, None]  # dead slots hold zeros like the real stack
    r = rng.standard_normal((nroots, n))
    diag = rng.standard_normal(n) + 5.0
    evals = np.linspace(-1.0, 0.0, nroots)
    return r, v, mask, diag, evals


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("seed,shape", [(0, (4, 12, 256)), (1, (3, 16, 200))])
def test_plain_chain_matches_interpreted_k2(jacobi, seed, shape):
    nroots, m_max, n = shape
    r, v, mask, diag, evals = _setup(nroots, m_max, n, seed)
    extra = (diag, evals) if jacobi else ()
    got = T.expand_chain(*_t(r, v, mask, *extra))
    ref = J.fused_expand_chain(*(jnp.asarray(a) for a in (r, v, mask, *extra)))
    for name, a, b in zip(("t", "n0", "n2", "g"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)


def test_wrapper_takes_plain_version_on_cpu():
    r, v, mask, diag, evals = _t(*_setup(seed=3))
    before = dict(T.LAUNCHES)
    for got, ref in zip(T.fused_expand_chain(r, v, mask, diag, evals),
                        T.expand_chain(r, v, mask, diag, evals)):
        assert torch.equal(got, ref)
    assert T.LAUNCHES == before


def test_null_direction_annihilated():
    """A direction already in the basis span comes out ~zero (the step's
    keep logic then drops it)."""
    r, v, mask, _, _ = _setup(seed=2)
    r[1] = 3.7 * v[0]  # slot 0 is active
    t, n0, n2, _ = T.fused_expand_chain(*_t(r, v, mask))
    assert float(n2[1]) < 1e-20 * float(n0[1])
    assert float(t[1].abs().max()) < 1e-10


def _whiten_inputs(seed, dead_row):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((4, 96))
    n0 = np.sum(t * t, axis=1) * 4.0
    if dead_row:
        t[2] *= 1e-12  # annihilated relative to its pre-GS norm
    n2 = np.sum(t * t, axis=1)
    return t, n0, n2, t @ t.T


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dead_row", [False, True])
def test_whiten_after_chain_matches_jax(fused, dead_row):
    t, n0, n2, g = _whiten_inputs(5, dead_row)
    out, keep = T.whiten_after_chain(*_t(t, n0, n2), 4, 1e-10,
                                     g=torch.from_numpy(g) if fused else None)
    jout, jkeep = J.whiten_after_chain(jnp.asarray(t), jnp.asarray(n0), jnp.asarray(n2),
                                       4, 1e-10, g=jnp.asarray(g) if fused else None)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool(keep[2]) is not dead_row
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-12)
    live = keep.numpy()
    gram = out.numpy()[live] @ out.numpy()[live].T
    np.testing.assert_allclose(gram, np.eye(live.sum()), atol=1e-10)


def test_whiten_parallel_rows_no_nan():
    """Two mutually parallel surviving rows must whiten to FINITE output in
    f32 (tests/test_chain_pallas.py:177)."""
    n = 64
    rng = np.random.default_rng(0)
    row = rng.standard_normal(n).astype(np.float32)
    t = torch.from_numpy(np.stack([row, row * (1.0 + 1e-7)]))
    n2 = torch.einsum("in,in->i", t, t)
    out, keep = T.whiten_after_chain(t, n2, n2, 2, 1e-10)
    assert bool(torch.all(keep))
    assert torch.isfinite(out).all()
    assert abs(float(torch.linalg.norm(out[0])) - 1.0) < 1e-3
    assert float(out.abs().max()) < 1e4


def test_cholesky_failure_is_nan():
    """cholesky_ex's failure becomes NaN, jnp.linalg.cholesky's contract."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(T._cholesky_nan(bad)).all()
    good = torch.tensor([[4.0, 2.0], [2.0, 3.0]], dtype=torch.float64)
    np.testing.assert_allclose(T._cholesky_nan(good).numpy(),
                               np.linalg.cholesky(good.numpy()))


@pytest.mark.parametrize("device,dtype,on", [
    ("cuda", torch.float32, True), ("cuda", torch.float64, False),
    ("cpu", torch.float32, False), ("cpu", torch.float64, False),
])
def test_gpu_auto_policy(device, dtype, on):
    """fuse_chain auto: on for float32 on CUDA (no VMEM arena to guard)."""
    assert T.chain_auto(device, dtype) is on
