"""The port's masked Gram matrix (iterative_solver_torch/ops/kernels/gram.py)
against the JAX package's Pallas kernel run as its own tests run it
(``masked_gram_pallas(interpret=True)``, tests/test_spmv.py:108-134), on
the CPU with the same float32 inputs.

The Pallas body sums each tile's product in float32 and adds the tiles in
order; the plain version is one float32 product. Tolerance: 1e-5 of the
largest sum of |terms| (|v| |w|ᵀ), the scale both sums round at. The tile
argument keeps the Pallas wrapper's check: the calls JAX accepts succeed,
and those it refuses fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_torch.ops.kernels import gram as T
from iterative_solver_tpu.ops.kernels import masked_gram_pallas
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

TOL = 1e-5


def _stacks(m, n, seed, same=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((m, n)).astype(np.float32)
    w = v if same else rng.standard_normal((m, n)).astype(np.float32)
    return v, w


def _close(got, ref, v, w):
    scale = (np.abs(v).astype(np.float64) @ np.abs(w).astype(np.float64).T).max()
    assert np.abs(got.astype(np.float64) - ref.astype(np.float64)).max() <= TOL * scale


@pytest.mark.parametrize("active", [16, 10, 0])
def test_masked_gram_matches_pallas(active):
    """tests/test_spmv.py:109-121: (16, 1024), the first ``active`` rows live."""
    v, w = _stacks(16, 1024, 0)
    mask = (np.arange(16) < active).astype(np.float32)
    ref = np.asarray(masked_gram_pallas(jnp.asarray(v), jnp.asarray(w), jnp.asarray(mask),
                                        interpret=True))
    got = T.masked_gram_kernel(torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(mask))
    assert got.dtype == torch.float32 and got.shape == (16, 16)
    got = got.numpy()
    _close(got, ref, v, w)
    assert np.array_equal(got, got.T)
    assert not np.any(got[active:]) and not np.any(got[:, active:])


@pytest.mark.parametrize("tile", [128, 256, 512, 1024])
def test_tile_sweep_matches_pallas(tile):
    """tests/test_spmv.py:123-134: a Gram of one (8, 512) stack with itself."""
    v, _ = _stacks(8, 512, 1)
    mask = np.ones(8, dtype=np.float32)
    ref = np.asarray(masked_gram_pallas(jnp.asarray(v), jnp.asarray(v), jnp.asarray(mask),
                                        tile=tile, interpret=True))
    got = T.masked_gram(torch.as_tensor(v), torch.as_tensor(v), torch.as_tensor(mask),
                        tile=tile).numpy()
    _close(got, ref, v, v)


@pytest.mark.parametrize("n,tile", [(1000, 100), (1000, 300), (777, 512), (96, 40),
                                    (1024, 1000)])
def test_tile_check_agrees_with_pallas(n, tile):
    v, w = _stacks(4, n, 2)
    mask = np.ones(4, dtype=np.float32)
    try:
        ref = np.asarray(masked_gram_pallas(jnp.asarray(v), jnp.asarray(w), jnp.asarray(mask),
                                            tile=tile, interpret=True))
    except AssertionError:
        ref = None
    args = (torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(mask))
    if ref is None:
        with pytest.raises(ValueError, match="tile grid"):
            T.masked_gram_kernel(*args, tile=tile)
    else:
        _close(T.masked_gram_kernel(*args, tile=tile).numpy(), ref, v, w)


def test_tile_grid():
    assert T.tile_grid(8192, 512) == (512, 16)
    assert T.tile_grid(300, 1024) == (300, 1)
    with pytest.raises(ValueError):
        T.tile_grid(1000, 300)   # 3 tiles do not divide 1000


def test_wrapper_takes_the_plain_version_on_the_cpu():
    v, w = _stacks(6, 64, 3)
    args = (torch.as_tensor(v, dtype=torch.float64), torch.as_tensor(w, dtype=torch.float64),
            torch.ones(6, dtype=torch.float64))
    before = T.LAUNCHES["gram"]
    got = T.masked_gram_kernel(*args)
    assert T.LAUNCHES["gram"] == before and got.dtype == torch.float64
    g = v.astype(np.float64) @ w.astype(np.float64).T
    np.testing.assert_allclose(got.numpy(), 0.5 * (g + g.T), rtol=0, atol=1e-13)


@pytest.mark.parametrize("m", [1, 17, 64])
@pytest.mark.parametrize("n", [512, 8192, 1 << 20, 777, 96, 1, 33, 1 << 16])
def test_chunk_plan_covers_each_column_once(n, m):
    chunk, nchunks = T.chunk_plan(n, m)
    assert chunk % T.STEP == 0
    # one CTA per block pair at least, at most two per SM
    assert T.block_pairs(m) <= nchunks <= T.TARGET_CHUNKS
    covered = np.zeros(n, dtype=np.int64)
    for c in range(nchunks):
        covered[c * chunk:min(n, (c + 1) * chunk)] += 1
    assert np.all(covered == 1)
    # chunks past N only where the block pairs need the CTAs
    assert nchunks == T.block_pairs(m) or (nchunks - 1) * chunk < n


def test_block_pairs():
    assert [T.block_pairs(m) for m in (1, 4, 5, 17, 64)] == [1, 1, 3, 15, 136]
    assert T.chunk_plan(8192, 64) == (32, 256)
    assert T.chunk_plan(1 << 20, 64) == (4000, 263)
    assert T.chunk_plan(8192, 64, ctas=200) == (64, 136)


@pytest.mark.parametrize("tile", [128, 256, 512, 1024])
def test_chunk_plan_ignores_the_tile(tile):
    """The tiles of test_tile_sweep_matches_pallas pass the Pallas check,
    and the kernel's chunks do not depend on them."""
    tile_n, n_tiles = T.tile_grid(512, tile)
    assert tile_n * n_tiles == 512
    assert T.chunk_plan(512, 8) == (T.STEP, 16)


@pytest.mark.parametrize("m,n", [(40, 8192), (64, 5000), (7, 777), (64, 1 << 16)])
def test_chunked_sum_matches_plain(m, n):
    """K7's order of the sum, emulated in float64: each chunk's partial;
    in the block pair's CTA, lane group q of warp w adds chunks 4w + q,
    4w + q + 32, ... in order; each warp adds its four groups as (s0 + s2)
    + (s1 + s3); the 8 warps are added in order; then the mask and the
    symmetrisation."""
    v, w = _stacks(m, n, 4)
    mask = (np.arange(m) < max(1, 5 * m // 8)).astype(np.float32)
    chunk, nchunks = T.chunk_plan(n, m)
    parts = [v[:, c * chunk:(c + 1) * chunk].astype(np.float64)
             @ w[:, c * chunk:(c + 1) * chunk].astype(np.float64).T for c in range(nchunks)]
    groups = [sum(parts[g::32], np.zeros((m, m))) for g in range(32)]
    warps = [(groups[4 * w] + groups[4 * w + 2]) + (groups[4 * w + 1] + groups[4 * w + 3])
             for w in range(8)]
    hmat = sum(warps[1:], warps[0]) * mask[:, None] * mask[None, :]
    got = 0.5 * (hmat + hmat.T)
    ref = T.masked_gram(torch.as_tensor(v, dtype=torch.float64),
                        torch.as_tensor(w, dtype=torch.float64),
                        torch.as_tensor(mask, dtype=torch.float64), tile=n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
