"""The port's packed symmetric operator (iterative_solver_torch/ops/kernels/
symm.py) against the JAX package's (iterative_solver_tpu/ops/kernels/
symm_pallas.py), on the CPU.

Storage must be bit-identical (one host packing feeds both packages). The
plain f64 action must match the JAX XLA path and the interpreted Pallas
kernel K1 to 1e-12; with f32 x the plain versions must match the
interpreted K1 (bf16 tiles) and K3 to 1e-6, the f32 order-of-sum level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.ops.kernels import symm_pallas as J
from iterative_solver_torch.ops.kernels import symm as T

_TDTYPE = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
_JDTYPE = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}


def _random_symmetric(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * scale
    return (a + a.T) / 2


def _bits(x):
    """Raw bits of a torch tensor or a JAX/numpy array, as an integer array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        width = {8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()]
        return x.view(width).numpy()
    x = np.asarray(x)
    return x.view({8: np.int64, 4: np.int32, 2: np.int16}[x.dtype.itemsize])


@pytest.mark.parametrize("n,b,dtype", [
    (96, 32, "f64"), (128, 64, "f32"), (80, 32, "bf16"), (300, 128, "bf16"),
])
def test_from_dense_bit_identical(n, b, dtype):
    mat = _random_symmetric(n, seed=n)
    js = J.SymmetricBlocked.from_dense(mat, b=b, dtype=_JDTYPE[dtype])
    ts = T.SymmetricBlocked.from_dense(mat, b=b, dtype=_TDTYPE[dtype], device="cpu")
    assert ts.shape == js.shape and ts.b == js.b and ts.n_pairs == js.n_pairs
    assert ts.values.dtype == _TDTYPE[dtype]
    np.testing.assert_array_equal(_bits(ts.values), _bits(js.values))
    np.testing.assert_array_equal(ts.ii.numpy(), np.asarray(js.ii))
    np.testing.assert_array_equal(ts.jj.numpy(), np.asarray(js.jj))
    assert ts.ii.dtype == torch.int32 and ts.jj.dtype == torch.int32
    np.testing.assert_array_equal(_bits(ts.diagonal), _bits(js.diagonal))


def test_from_dense_tile_dropping_matches():
    mat = _random_symmetric(128, seed=3)
    mat[64:, :64] = 0.0
    mat[:64, 64:] = 0.0
    js = J.SymmetricBlocked.from_dense(mat, b=32, tol=0.0)
    ts = T.SymmetricBlocked.from_dense(mat, b=32, tol=0.0, device="cpu")
    assert ts.n_pairs == js.n_pairs < 10
    np.testing.assert_array_equal(ts.ii.numpy(), np.asarray(js.ii))
    np.testing.assert_array_equal(ts.jj.numpy(), np.asarray(js.jj))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))


@pytest.mark.parametrize("n,b,scale", [(96, 32, 10.0), (200, 64, 1e-3)])
def test_split_from_dense_bit_identical(n, b, scale):
    mat = _random_symmetric(n, seed=7, scale=scale)
    js = J.SymmetricBlockedSplit.from_dense(mat, b=b)
    ts = T.SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu")
    assert ts.hi.dtype == torch.bfloat16 and ts.lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ts.hi), _bits(js.hi))
    np.testing.assert_array_equal(_bits(ts.lo), _bits(js.lo))
    assert np.abs(ts.lo.float().numpy()).max() > 0.0
    np.testing.assert_array_equal(ts.ii.numpy(), np.asarray(js.ii))
    np.testing.assert_array_equal(ts.jj.numpy(), np.asarray(js.jj))
    np.testing.assert_array_equal(_bits(ts.diagonal), _bits(js.diagonal))


def _split_inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 64)) * np.logspace(-6, 6, 64)
    special = np.array([0.0, -0.0, 1.0, -1.0, 3.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9,
                        1.0 + 3 * 2.0 ** -9, np.float32(np.pi), -np.float32(np.e),
                        6.1e-5, -1e30, 2.0 ** -100, 65504.0, 1e-30, 7.0])
    # no subnormal parts: XLA on the CPU flushes them to zero, PyTorch keeps them
    return np.concatenate([x.ravel(), special])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_bf16_split_bit_identical(dtype):
    x = _split_inputs().astype(np.float32 if dtype == "f32" else np.float64)
    jh, jl = J.bf16_split(jnp.asarray(x))
    th, tl = T.bf16_split(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(th), _bits(jh))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))


def test_bf16_split_truncates_not_rounds():
    x = torch.tensor([1.0 + 3 * 2.0 ** -9], dtype=torch.float32)  # rounds up in bf16
    hi, lo = T.bf16_split(x)
    assert float(hi) == 1.0                        # top 16 bits kept, the rest cut
    assert float(x.bfloat16()) == 1.0 + 2.0 ** -7  # rounding would go up
    assert float(hi) + float(lo) == float(x)


def _x(m, n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


@pytest.mark.parametrize("n,b,m", [(96, 32, 3), (128, 64, 4), (300, 128, 5)])
def test_plain_f64_matches_jax(n, b, m):
    mat = _random_symmetric(n, seed=2)
    js = J.SymmetricBlocked.from_dense(mat, b=b)
    ts = T.SymmetricBlocked.from_dense(mat, b=b, device="cpu")
    npad = ts.shape[0]
    x = np.zeros((m, npad))
    x[:, :n] = _x(m, n, seed=3)
    y = T.symm_matmat(torch.from_numpy(x), ts).numpy()
    y_xla = np.asarray(J.symm_matmat(jnp.asarray(x), js))
    y_k1 = np.asarray(J.symm_matmat_pallas(jnp.asarray(x), js, interpret=True))
    scale = np.abs(y_xla).max()
    np.testing.assert_allclose(y, y_xla, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(y, y_k1, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(y[:, :n], x[:, :n] @ mat, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("n,b", [(96, 32), (128, 64)])
def test_bf16_tiles_f32_x_match_interpreted_k1(n, b):
    mat = _random_symmetric(n, seed=10)
    js = J.SymmetricBlocked.from_dense(mat, b=b, dtype=jnp.bfloat16)
    ts = T.SymmetricBlocked.from_dense(mat, b=b, dtype=torch.bfloat16, device="cpu")
    x = _x(3, n, seed=11, dtype=np.float32)
    y = T.symm_matmat(torch.from_numpy(x), ts)
    assert y.dtype == torch.float32
    y_k1 = np.asarray(J.symm_matmat_pallas(jnp.asarray(x), js, interpret=True))
    np.testing.assert_allclose(y.numpy(), y_k1, rtol=0, atol=1e-6 * np.abs(y_k1).max())
    # x is rounded to bf16 before the product, as in the kernel: the exact
    # bf16 x bf16 products in f64 land on the same values
    xr = torch.from_numpy(x).bfloat16().double().numpy()
    dense = np.zeros((n, n))
    for t in range(ts.n_pairs):
        i, j = int(ts.ii[t]), int(ts.jj[t])
        tile = ts.values[t].double().numpy()
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = tile
        dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = tile.T
    np.testing.assert_allclose(y.numpy(), xr @ dense, rtol=0, atol=1e-6 * np.abs(y_k1).max())


def test_bf16_tiles_f64_x_not_rounded():
    """With f64 x (the CPU test tier) the plain version widens the tiles and
    does not round x, as the JAX portable path does."""
    n, b = 64, 32
    mat = _random_symmetric(n, seed=12)
    js = J.SymmetricBlocked.from_dense(mat, b=b, dtype=jnp.bfloat16)
    ts = T.SymmetricBlocked.from_dense(mat, b=b, dtype=torch.bfloat16, device="cpu")
    x = _x(2, n, seed=13)
    y = T.symm_matmat(torch.from_numpy(x), ts)
    assert y.dtype == torch.float64
    y_xla = np.asarray(J.symm_matmat(jnp.asarray(x), js))
    np.testing.assert_allclose(y.numpy(), y_xla, rtol=0, atol=1e-12 * np.abs(y_xla).max())


@pytest.mark.parametrize("n,b,xdtype", [(96, 32, np.float32), (128, 64, np.float32),
                                        (128, 64, np.float64)])
def test_split_matches_jax(n, b, xdtype):
    mat = _random_symmetric(n, seed=8)
    js = J.SymmetricBlockedSplit.from_dense(mat, b=b)
    ts = T.SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu")
    x = _x(4, n, seed=9, dtype=xdtype)
    y = T.symm_matmat_split(torch.from_numpy(x), ts)
    assert y.dtype == torch.from_numpy(x).dtype
    y_xla = np.asarray(J.symm_matmat_split(jnp.asarray(x), js))
    x32 = jnp.asarray(x.astype(np.float32))
    y_k3 = np.asarray(J.symm_matmat_split_pallas(x32, js, interpret=True))
    scale = np.abs(y_xla).max()
    np.testing.assert_allclose(y.numpy(), y_xla, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(y.numpy(), y_k3, rtol=0, atol=1e-6 * scale)
    # double-bf16: ~2^-16 relative accuracy against the f64 product
    assert np.abs(y.numpy() - x @ mat).max() < 1e-4 * scale


def test_padding_to_block_multiple():
    n, b = 80, 32
    mat = _random_symmetric(n, seed=4)
    ts = T.SymmetricBlocked.from_dense(mat, b=b, device="cpu")
    assert ts.shape == (96, 96)
    x = np.zeros((2, 96))
    x[:, :n] = _x(2, n, seed=5)
    y = T.symm_matmat(torch.from_numpy(x), ts).numpy()
    np.testing.assert_allclose(y[:, :n], x[:, :n] @ mat, atol=1e-12)
    np.testing.assert_allclose(y[:, n:], 0.0, atol=0.0)
    split = T.SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu")
    assert split.shape == (96, 96)
    ys = T.symm_matmat_split(torch.from_numpy(x), split).numpy()
    np.testing.assert_allclose(ys[:, n:], 0.0, atol=0.0)


def test_rejects_asymmetric():
    mat = np.arange(16.0).reshape(4, 4)
    with pytest.raises(ValueError):
        T.SymmetricBlocked.from_dense(mat, b=4, device="cpu")
    with pytest.raises(ValueError):
        T.SymmetricBlockedSplit.from_dense(mat, b=4, device="cpu")


def test_wrappers_take_plain_version_on_cpu():
    """On a CPU tensor the kernel wrappers run the plain version and count
    no launch."""
    mat = _random_symmetric(64, seed=14)
    x = torch.from_numpy(_x(3, 64, seed=15, dtype=np.float32))
    before = dict(T.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        ts = T.SymmetricBlocked.from_dense(mat, b=32, dtype=dtype, device="cpu")
        assert torch.equal(T.symm_matmat_kernel(x, ts), T.symm_matmat(x, ts))
    split = T.SymmetricBlockedSplit.from_dense(mat, b=32, device="cpu")
    assert torch.equal(T.symm_matmat_split_kernel(x, split), T.symm_matmat_split(x, split))
    assert T.LAUNCHES == before


def _storage(kind, mat, b):
    from iterative_solver_torch.ops.kernels import symm_int8 as T8

    return {"f32": lambda: T.SymmetricBlocked.from_dense(mat, b=b, dtype=torch.float32,
                                                         device="cpu"),
            "bf16": lambda: T.SymmetricBlocked.from_dense(mat, b=b, dtype=torch.bfloat16,
                                                          device="cpu"),
            "split": lambda: T.SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu"),
            "int8": lambda: T8.SymmetricBlockedInt8.from_dense(mat, b=b, device="cpu"),
            "int8_split": lambda: T8.SymmetricBlockedInt8Split.from_dense(mat, b=b,
                                                                          device="cpu")}[kind]()


@pytest.mark.parametrize("kind", ["f32", "bf16", "split", "int8", "int8_split"])
def test_packed_matvec_runs_the_storage_kernel_with_its_operand(kind):
    """``packed_matvec``: the operand is the storage's OPERAND tensors; the
    matvec runs the storage's kernel wrapper (here its plain version, on
    the CPU) with the operand's tensors in place of the storage's own."""
    mat = _random_symmetric(128, seed=16)
    sym = _storage(kind, mat, 32)
    x = torch.from_numpy(_x(3, 128, seed=17, dtype=np.float32))
    matvec, op = T.packed_matvec(sym)
    assert len(op) == len(type(sym).OPERAND)
    assert all(a is getattr(sym, f) for a, f in zip(op, type(sym).OPERAND))
    y = matvec(x, op)
    assert y.dtype == x.dtype
    assert torch.equal(y, sym.plain(x)) and torch.equal(sym.kernel(x), sym.plain(x))
    # a zero operand in place of every tile plane gives the diagonal's action alone
    planes = ("values", "hi", "lo", "q", "q1", "q2")
    zeroed = tuple(torch.zeros_like(a) if f in planes else a
                   for a, f in zip(op, type(sym).OPERAND))
    diag = getattr(sym, "diagonal", None) if kind.startswith("int8") else None
    expect = torch.zeros_like(x) if diag is None else x * diag[None, :]
    assert torch.equal(matvec(x, zeroed), expect)


# the kernels' square walk (``square_work_list`` / ``square_walk``): b below,
# at and above the 256-wide square, ragged b, tiles dropped by ``tol``
WALK_SHAPES = [(192, 96, None), (400, 200, None), (1024, 512, None), (2048, 1024, None),
               (1536, 512, 0.0)]


def _walk_matrix(n, b, tol, seed):
    mat = _random_symmetric(n, seed=seed)
    if tol is not None:  # zero the off-diagonal tile pairs (1, 0) and (2, 0)
        mat[b:3 * b, :b] = 0.0
        mat[:b, b:3 * b] = 0.0
    return mat


@pytest.mark.parametrize("m", [1, 9, 17])
@pytest.mark.parametrize("n,b,tol", WALK_SHAPES)
def test_square_walk_equals_plain(n, b, tol, m):
    mat = _walk_matrix(n, b, tol, seed=20)
    ts = T.SymmetricBlocked.from_dense(mat, b=b, tol=tol, device="cpu")
    if tol is not None:
        assert ts.n_pairs == 6 - 2
    x = torch.from_numpy(_x(m, n, seed=21))
    y = T.square_walk([x], [ts.values], ts)
    ref = T.symm_matmat(x, ts)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 1e-12 * scale
    np.testing.assert_allclose(y.numpy(), x.numpy() @ mat, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("m", [1, 9, 17])
@pytest.mark.parametrize("n,b", [(192, 96), (400, 200), (1024, 512), (2048, 1024)])
def test_square_walk_split_equals_plain(n, b, m):
    """The split walk (xh hi + xh lo + xl hi per square) in f64 equals the
    plain three-product form in f64 to 1e-12, and the f32 plain version
    ``symm_matmat_split`` to its f32 order-of-sum level."""
    mat = _random_symmetric(n, seed=22)
    ts = T.SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu")
    x32 = torch.from_numpy(_x(m, n, seed=23, dtype=np.float32))
    xh, xl = (p.double() for p in T.bf16_split(x32))
    hi, lo = ts.hi.double(), ts.lo.double()
    y = T.square_walk([xh, xh, xl], [hi, lo, hi], ts)
    nb = n // b
    ref = sum(T._symm_matmat_plain(xp, plane, ts.ii, ts.jj, b, nb)
              for xp, plane in ((xh, hi), (xh, lo), (xl, hi)))
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 1e-12 * scale
    y32 = T.symm_matmat_split(x32, ts).double()
    assert float((y - y32).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("n,b,tol", WALK_SHAPES + [(300, 100, None), (96, 32, None)])
def test_work_list_covers_every_tile_element_once(n, b, tol):
    ts = T.SymmetricBlocked.from_dense(_walk_matrix(n, b, tol, seed=24), b=b, tol=tol,
                                       device="cpu")
    work = T.square_work(ts)
    assert work.dtype == torch.int32 and work.shape[1] == 4
    cover = np.zeros((ts.n_pairs, b, b), dtype=np.int64)
    ii, jj = ts.ii.numpy(), ts.jj.numpy()
    for t, r0, c0, diag in work.tolist():
        assert r0 % T.SQUARE == 0 and c0 % T.SQUARE == 0
        assert diag == int(ii[t] == jj[t])
        cover[t, r0:r0 + T.SQUARE, c0:c0 + T.SQUARE] += 1
    assert np.all(cover == 1)
    # off-diagonal squares first, then the diagonal tiles' (one contribution)
    assert np.all(np.diff(work[:, 3].numpy()) >= 0)
    # the list follows the tiles it was built from, and is cached on the object
    assert T.square_work(ts) is work
    lazy = T.SymmetricBlocked(ts.values, ts.ii, ts.jj, ts.shape, ts.b)
    assert torch.equal(T.square_work(lazy), work)


@pytest.mark.parametrize("n,b,tol", WALK_SHAPES + [(300, 100, None), (96, 32, None)])
def test_sum_list_orders_every_slot_once(n, b, tol):
    """The kernels' sums: each square stores y_i into slot 2 w and, off the
    diagonal, y_j into slot 2 w + 1; every such slot is listed once, under
    the segment of y its rows or columns fall in, in increasing order, and
    the list is cached on the object beside the work list."""
    ts = T.SymmetricBlocked.from_dense(_walk_matrix(n, b, tol, seed=25), b=b, tol=tol,
                                       device="cpu")
    work, sums = T.square_work(ts), T.square_sums(ts)
    assert sums.dtype == torch.int32 and sums.ndim == 1
    nsq = -(-b // T.SQUARE)
    n_seg = (n // b) * nsq
    ptr, slots = sums[:n_seg + 1].tolist(), sums[n_seg + 1:].tolist()
    assert ptr[0] == 0 and ptr[-1] == len(slots)
    ii, jj = ts.ii.tolist(), ts.jj.tolist()
    expected = {seg: [] for seg in range(n_seg)}
    for w, (t, r0, c0, _) in enumerate(work.tolist()):
        expected[ii[t] * nsq + r0 // T.SQUARE].append(2 * w)
        if ii[t] != jj[t]:
            expected[jj[t] * nsq + c0 // T.SQUARE].append(2 * w + 1)
    for seg in range(n_seg):
        assert slots[ptr[seg]:ptr[seg + 1]] == sorted(expected[seg])
    assert T.square_sums(ts) is sums
    lazy = T.SymmetricBlocked(ts.values, ts.ii, ts.jj, ts.shape, ts.b)
    assert torch.equal(T.square_sums(lazy), sums)
