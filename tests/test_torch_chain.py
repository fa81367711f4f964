"""The port's expand chain (iterative_solver_torch/ops/kernels/chain.py)
against the JAX package's fused chain kernel K2 (ops/kernels/chain_pallas.py,
run in interpret mode on the CPU, as its own tests run it) and its
whitening, in f64 to 1e-12; and the plain emulation of the CUDA kernel's
column partition and summation order (``expand_chain_emulated``) in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops.kernels import chain_pallas as J
from iterative_solver_torch.ops.kernels import chain as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


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


def _phenol_like(n, nroots=16, m_max=64, active=48, seed=0):
    """The phenol check's kind of step in f32: a random orthonormal basis
    with its last rows dead, Ritz values just below the lowest of 64 low
    diagonal entries (one large column per row of t)."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(0.5, 50.0, n)
    diag[rng.choice(n, 64, replace=False)] = np.linspace(-2.0, 3.0, 64)
    evals = np.sort(diag)[:nroots] - 1e-4
    mask = np.zeros(m_max)
    mask[:active] = 1.0
    v = np.linalg.qr(rng.standard_normal((n, m_max)))[0].T * mask[:, None]
    r = rng.standard_normal((nroots, n))
    return [torch.tensor(a, dtype=torch.float32) for a in (r, v, mask, diag, evals)]


@pytest.mark.parametrize("ctas", [1, 3, 64])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("shape", [(4, 12, 256), (3, 16, 200), (16, 64, 1000),
                                   (1, 128, 384), (20, 100, 777)])
def test_emulated_chain_matches_plain_and_interpreted_k2(shape, jacobi, ctas):
    """The CUDA kernel's partition and order of sums, emulated in f32, is
    the same chain as the plain version and JAX's interpreted K2, within
    1e-5 of each result's largest entry."""
    nroots, m_max, n = shape
    r, v, mask, diag, evals = _t(*_setup(nroots, m_max, n, seed=nroots))
    f32 = [a.float() for a in (r, v, mask, diag, evals)]
    extra = f32[3:] if jacobi else ()
    got = T.expand_chain_emulated(*f32[:3], *extra, ctas=ctas)
    ref = T.expand_chain(*f32[:3], *extra)
    jref = J.fused_expand_chain(*(jnp.asarray(a.numpy()) for a in (*f32[:3], *extra)))
    for name, a, b, c in zip(("t", "n0", "n2", "g"), got, ref, jref):
        assert a.dtype == torch.float32
        c = torch.from_numpy(np.array(c)).reshape(b.shape)
        assert c.dtype == torch.float32
        for other in (b, c):
            err = float((a.double() - other.double()).abs().max())
            assert err <= 1e-5 * float(other.abs().max()), name


@pytest.mark.parametrize("ctas", [1, 2, 5, 64, 264])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 8192, 8193, 1 << 17])
def test_chain_steps_cover_every_column_once(n, ctas):
    plan = T.chain_steps(n, ctas)
    assert len(plan) == ctas
    cols = np.concatenate([np.arange(c0, c1) for steps in plan for c0, c1 in steps])
    np.testing.assert_array_equal(np.sort(cols), np.arange(n))
    for b, steps in enumerate(plan):
        for k, (c0, c1) in enumerate(steps):
            # CTA b streams the steps b, b + ctas, ... of CHAIN_STEP columns
            assert c0 == (b + k * ctas) * T.CHAIN_STEP and 0 < c1 - c0 <= T.CHAIN_STEP


@pytest.mark.parametrize("shape,capacity,ctas", [
    ((16, 64, 8192), 264, 64), ((16, 64, 1 << 20), 264, 264), ((16, 64, 1 << 20), 132, 132),
    ((3, 12, 300), 264, 3), ((32, 128, 256), 132, 64), ((1, 1, 5), 264, 1)])
def test_chain_cta_count(shape, capacity, ctas):
    """One CTA per step, at least one per 64 entries of a pass's partials,
    at most what the card holds."""
    assert T.chain_ctas(*shape, capacity) == ctas


@pytest.mark.parametrize("seed", [0, 3])
def test_emulated_chain_accuracy_at_2_17(seed):
    """At n = 2^17 in f32 the kernel's order of sums errs against float64
    (on the same f32 inputs) no more than the plain f32 version in n2 and
    g, up to two roundings of the result (2^-23 of its largest entry: both
    round the same t, and a plain sum can cancel part of t's own error),
    and everything lies within 1e-5. The first design's order (each CTA's
    partial added atomically into one global sum) erred by 4.6e-5 at
    n = 2^20 on the card."""
    args = _phenol_like(1 << 17, seed=seed)
    ref = T.expand_chain(*(a.double() for a in args))
    emul = T.expand_chain_emulated(*args, ctas=264)
    plain = T.expand_chain(*args)

    def err(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    for name, e, p, f in zip(("t", "n0", "n2", "g"), emul, plain, ref):
        assert err(e, f) <= 1e-5, name
        if name in ("n2", "g"):
            assert err(e, f) <= err(p, f) + 2.0 ** -23, name


def test_emulated_chain_refuses_the_second_paths_shapes():
    r, v, mask, _, _ = _t(*_setup(40, 150, 256))
    with pytest.raises(ValueError):
        T.expand_chain_emulated(r.float(), v.float(), mask.float())
    assert T.chain_fast_dims(40, 150) is None
    assert T.chain_fast_dims(16, 64) == (16, 64)
    assert T.chain_fast_dims(17, 65) == (32, 128)


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
