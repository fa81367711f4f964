"""The port's synthetic operators (iterative_solver_torch/models/synthetic_fci.py)
against the JAX package's: the same seed gives byte-identical output
(tolerance 0), and the implied operator's f64 action agrees with its dense
matrix to 1e-12 of its scale."""

import numpy as np
import pytest
import torch

from iterative_solver_torch.models import synthetic_fci as T
from iterative_solver_tpu.models import synthetic_fci as J
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


@pytest.mark.parametrize("n,b,seed", [(256, 64, 0), (512, 128, 1), (384, 128, 7),
                                      (96, 96, 2)])
def test_packed_int8_is_byte_identical(n, b, seed):
    jsym, jdiag = J.synthetic_packed_int8(n, b=b, seed=seed, chunk_tiles=3)
    tsym, tdiag = T.synthetic_packed_int8(n, b=b, seed=seed, chunk_tiles=3, device="cpu")
    assert tsym.shape == jsym.shape and tsym.b == jsym.b
    for name in ("q", "gq", "ii", "jj", "diagonal"):
        ref = np.asarray(getattr(jsym, name))
        got = getattr(tsym, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_array_equal(tdiag, jdiag)


def test_packed_int8_chunking_does_not_change_the_draw():
    a, _ = T.synthetic_packed_int8(256, b=64, seed=4, chunk_tiles=1, device="cpu")
    b, _ = T.synthetic_packed_int8(256, b=64, seed=4, chunk_tiles=32, device="cpu")
    assert torch.equal(a.q, b.q)


def test_packed_int8_custom_diagonal():
    diag = np.linspace(-1.0, 1.0, 128) ** 3
    jsym, jdiag = J.synthetic_packed_int8(128, b=32, seed=5, diag=diag, coupling=0.2)
    tsym, tdiag = T.synthetic_packed_int8(128, b=32, seed=5, diag=diag, coupling=0.2,
                                         device="cpu")
    np.testing.assert_array_equal(tdiag, jdiag)
    np.testing.assert_array_equal(tsym.diagonal.numpy(), np.asarray(jsym.diagonal))
    np.testing.assert_array_equal(tsym.gq.numpy(), np.asarray(jsym.gq))


def test_packed_int8_refusals():
    with pytest.raises(ValueError, match="multiple"):
        T.synthetic_packed_int8(100, b=64)
    with pytest.raises(ValueError, match="headroom"):
        # 2^31/127^2 ~= 133k columns; the check comes before any tile is drawn
        T.synthetic_packed_int8(140 * 1024, b=1024)


def test_implied_dense_matches_jax_and_is_symmetric():
    jsym, jdiag = J.synthetic_packed_int8(256, b=64, seed=6)
    tsym, tdiag = T.synthetic_packed_int8(256, b=64, seed=6, device="cpu")
    ref = J.implied_dense_int8(jsym, jdiag)
    got = T.implied_dense_int8(tsym, tdiag)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_implied_matmat_matches_dense(chunk):
    sym, diag = T.synthetic_packed_int8(320, b=64, seed=8, device="cpu")
    dense = T.implied_dense_int8(sym, diag)
    x = np.random.default_rng(9).standard_normal((5, 320))
    y = T.implied_matmat_int8(torch.from_numpy(x).float(), sym, diag, chunk_tiles=chunk)
    assert y.dtype == torch.float64
    ref = x.astype(np.float32).astype(np.float64) @ dense
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 3)])
def test_dense_matches_jax(n, seed):
    np.testing.assert_array_equal(T.synthetic_fci_dense(n, seed=seed),
                                  J.synthetic_fci_dense(n, seed=seed))
