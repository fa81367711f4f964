"""The port's SplitOperator, precise_matmat and refine_on_host
(iterative_solver_torch/ops/precise.py) against the JAX package's, on the
CPU with the same matrices and blocks: products within 1e-12 in float64
(and the same bits in float32), refine_on_host's values and vectors within
1e-12 with the same iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops import precise as J
from iterative_solver_tpu.solvers import fused_davidson as JD
from iterative_solver_torch.ops import precise as T
from iterative_solver_torch.solvers import fused_davidson as TD
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def make_gapped(n, nroots, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (noise / np.sqrt(n))
    d = np.concatenate([np.linspace(-2.0, 0.5, nroots), np.linspace(2.0, 30.0, n - nroots)])
    return a + a.T + np.diag(d)


@pytest.mark.parametrize("n,chunks", [(256, 64), (300, 64), (192, 7)])
def test_split_operator_matches_jax(n, chunks):
    m = make_gapped(n, 4)
    jop = J.SplitOperator.from_dense(m, chunks)
    top = T.SplitOperator.from_dense(m, chunks, device="cpu")
    assert top.n_chunks == jop.n_chunks and n % top.n_chunks == 0
    np.testing.assert_array_equal(top.hi.numpy(), np.asarray(jop.hi))
    np.testing.assert_array_equal(top.lo.numpy(), np.asarray(jop.lo))
    np.testing.assert_array_equal(top.diagonal, jop.diagonal)
    assert top.operand()[0] is top.hi


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_precise_matmat_matches_jax(dtype):
    n = 256
    m = make_gapped(n, 4)
    jop = J.SplitOperator.from_dense(m, 64)
    top = T.SplitOperator.from_dense(m, 64, device="cpu")
    x = np.random.default_rng(5).standard_normal((4, n)).astype(dtype)
    jy = np.asarray(J.precise_matmat(jnp.asarray(x), jop))
    ty = T.precise_matmat(torch.as_tensor(x), top).numpy()
    assert ty.dtype == np.dtype(dtype)
    if dtype == "float64":
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(ty, jy)
        # the split-K f32 product beats a plain f32 product against f64
        exact = x.astype(np.float64) @ m.T
        plain = (x @ m.astype(np.float32).T).astype(np.float64)
        assert np.abs(ty - exact).max() < np.abs(plain - exact).max()
    mv = T.precise_matvec_fn(top)
    np.testing.assert_array_equal(mv(torch.as_tensor(x), top.operand()).numpy(), ty)


def test_fused_davidson_on_the_precise_operand():
    n, r = 256, 4
    m = make_gapped(n, r)
    jop = J.SplitOperator.from_dense(m, 64)
    top = T.SplitOperator.from_dense(m, 64, device="cpu")
    v0 = np.zeros((r, n))
    v0[np.arange(r), np.argsort(np.diag(m))[:r]] = 1.0
    kw = dict(m_max=16, convergence_threshold=1e-10)
    js = JD.FusedDavidson(J.precise_matvec_fn(jop), np.diag(m), n, r, operand=jop.operand(),
                          **kw)
    ts = TD.FusedDavidson(T.precise_matvec_fn(top), np.diag(m), n, r, operand=top.operand(),
                          device="cpu", **kw)
    je, _, _, jit = js.run_on_device(v0)
    te, _, _, tit = ts.run_on_device(v0)
    assert tit == int(jit)
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.sort(te), np.linalg.eigvalsh(m)[:r], atol=1e-10)


@pytest.mark.parametrize("start", ["close", "rough"])
def test_refine_on_host_matches_jax(start):
    n, r = 256, 4
    m = make_gapped(n, r, seed=2)
    eps = 1e-5 if start == "close" else 1e-2
    x0 = np.linalg.eigh(m)[1][:, :r].T + eps * np.random.default_rng(3).standard_normal((r, n))
    jev, jx, jinfo = J.refine_on_host(m, x0, r)
    tev, tx, tinfo = T.refine_on_host(m, torch.as_tensor(x0), r)
    assert tinfo.iterations == jinfo.iterations
    np.testing.assert_allclose(tev, jev, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tinfo.errors, jinfo.errors, rtol=0, atol=1e-12)
    assert max(tinfo.errors) <= 1e-8
