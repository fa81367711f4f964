"""The port's block-sparse operator (iterative_solver_torch/ops/kernels/spmv.py)
against the JAX package's (iterative_solver_tpu/ops/kernels/spmv_pallas.py),
on the CPU with the same inputs made by seeded numpy.

- Storage (values, col_idx, row_idx, row_ptr, shape, bm, bn, diagonal; the
  int8 tier's q, rq, cq and diagonal) must be byte-identical.
- The plain ``bsr_matmat`` against JAX's ``bsr_matmat`` (XLA): atol
  1e-12 * max|y| in float64; and, with K6's wrapper, against it and
  ``bsr_matmat_pallas(interpret=True)`` (K6's Pallas body, which sums in
  float32 whatever its input) in float32: 1e-5 of max|y| (the order of the
  sums differs).
- ``bsr_matmat_int8``: equal bit for bit to JAX's (the integer accumulator
  is exact, and the float32 epilogue rounds in the same order).
- ``FusedDavidson`` with a BSR action (the JAX test's configuration,
  tests/test_spmv.py:84-105, and a larger synthetic FCI operator):
  eigenvalues within 1e-10 of the JAX package's, the same iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_torch import config, convert
from iterative_solver_torch.models import synthetic_fci as TS
from iterative_solver_torch.ops.kernels import spmv as T
from iterative_solver_torch.solvers.fused_davidson import FusedDavidson as TDavidson
from iterative_solver_tpu.models import synthetic_fci as JS
from iterative_solver_tpu.ops.kernels import spmv_pallas as J
from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson as JDavidson
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

FIELDS = ("values", "col_idx", "row_idx", "row_ptr", "diagonal")
INT8_FIELDS = ("q", "rq", "cq", "col_idx", "row_idx", "row_ptr")


def _block_sparse(n, bm, density=0.3, seed=0):
    """tests/test_spmv.py::make_block_sparse: symmetric, block-sparse lower
    blocks mirrored, diagonal linspace(1, 10)."""
    rng = np.random.default_rng(seed)
    n_b = n // bm
    matrix = np.zeros((n, n))
    for rb in range(n_b):
        for cb in range(rb + 1):
            if rb == cb or rng.random() < density:
                matrix[rb * bm:(rb + 1) * bm, cb * bm:(cb + 1) * bm] = \
                    rng.standard_normal((bm, bm)) * 0.05
    return matrix + matrix.T + np.diag(np.linspace(1.0, 10.0, n))


def _same_bytes(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_bsr(jb, tb, fields=FIELDS):
    for f in fields:
        _same_bytes(getattr(jb, f), getattr(tb, f))
    assert tuple(jb.shape) == tb.shape and (jb.bm, jb.bn) == (tb.bm, tb.bn)


def _ragged():
    """A 45 x 52 matrix: ragged in both directions for any block edge
    above 4, with a whole zero band to prune."""
    m = np.random.default_rng(1).standard_normal((45, 52))
    m[:16, 16:40] = 0.0
    m[20:30, :] *= 1e-3
    return m


@pytest.mark.parametrize("bm,bn,tol", [(16, 16, 0.0), (16, 8, 0.0), (12, 20, 0.0),
                                       (8, 8, 0.01), (16, 16, 1e-3)])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_from_dense_storage_equals_jax(bm, bn, tol, dtype):
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    mat = _ragged()
    jb = J.BSRMatrix.from_dense(mat, bm=bm, bn=bn, tol=tol, dtype=jd)
    tb = T.BSRMatrix.from_dense(mat, bm=bm, bn=bn, tol=tol, dtype=td, device="cpu")
    _same_bsr(jb, tb)
    assert tb.n_blocks == jb.n_blocks and tb.nnz == jb.nnz


def test_from_dense_prunes_and_pads():
    tb = T.BSRMatrix.from_dense(_ragged(), bm=16, device="cpu")
    assert tb.shape == (48, 64)
    # the zero band [:16, 16:40] drops block (0, 1) of the 16-wide grid
    assert tb.n_blocks == 3 * 4 - 1
    assert tb.row_ptr.tolist() == [0, 3, 7, 11]


def test_from_dense_empty_operator():
    jb = J.BSRMatrix.from_dense(np.zeros((40, 40)), bm=16)
    tb = T.BSRMatrix.from_dense(np.zeros((40, 40)), bm=16, device="cpu")
    _same_bsr(jb, tb)
    assert tb.n_blocks == 0 and tb.values.shape == (0, 16, 16)
    y = T.bsr_matmat_kernel(torch.ones((2, 48), dtype=torch.float64), tb)
    assert torch.equal(y, torch.zeros((2, 48), dtype=torch.float64))


def test_block_default_is_the_bsr_block_option():
    mat = np.eye(300)
    assert T.BSRMatrix.from_dense(mat, device="cpu").bm == 128
    config.set_option("bsr_block", 64)
    try:
        jb = J.BSRMatrix.from_dense(mat, bm=64)
        tb = T.BSRMatrix.from_dense(mat, device="cpu")
        assert (tb.bm, tb.bn) == (64, 64)
        _same_bsr(jb, tb)
    finally:
        config.clear_options()


def test_from_dense_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.BSRMatrix.from_dense(np.eye(8), bm=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.BSRMatrixInt8.from_dense(np.eye(8), bm=4)


@pytest.mark.parametrize("n,block,density,seed", [(512, 32, 0.3, 3), (256, 64, 0.15, 0)])
def test_synthetic_fci_bsr_equals_jax(n, block, density, seed):
    jb, jdense = JS.synthetic_fci_bsr(n, block=block, density=density, seed=seed)
    tb, tdense = TS.synthetic_fci_bsr(n, block=block, density=density, seed=seed, device="cpu")
    assert np.array_equal(jdense, tdense)
    _same_bsr(jb, tb)


def _x(m, n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


@pytest.mark.parametrize("m", [1, 3, 16])
@pytest.mark.parametrize("bm,bn", [(16, 16), (16, 8), (12, 20)])
def test_plain_action_matches_jax_f64(m, bm, bn):
    mat = _ragged()
    jb = J.BSRMatrix.from_dense(mat, bm=bm, bn=bn)
    tb = T.BSRMatrix.from_dense(mat, bm=bm, bn=bn, device="cpu")
    x = _x(m, tb.shape[1], 2)
    y = T.bsr_matmat(torch.as_tensor(x), tb).numpy()
    y_xla = np.asarray(J.bsr_matmat(jnp.asarray(x), jb))
    assert y.shape == y_xla.shape == (m, tb.shape[0])
    scale = np.abs(y_xla).max()
    np.testing.assert_allclose(y, y_xla, rtol=0, atol=1e-12 * scale)
    # and the dense product the operator stands for
    padded = np.zeros(tb.shape)
    padded[:45, :52] = mat
    np.testing.assert_allclose(y, x @ padded.T, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("m", [4, 16])
def test_plain_action_matches_jax_f32(m):
    jb, _ = JS.synthetic_fci_bsr(512, block=32, density=0.3, seed=4, dtype=jnp.float32)
    tb, _ = TS.synthetic_fci_bsr(512, block=32, density=0.3, seed=4, dtype=torch.float32,
                                 device="cpu")
    x = _x(m, 512, 5, np.float32)
    y = T.bsr_matmat_kernel(torch.as_tensor(x), tb)
    assert y.dtype == torch.float32
    y = y.numpy()
    y_pallas = np.asarray(J.bsr_matmat_pallas(jnp.asarray(x), jb, interpret=True))
    y_xla = np.asarray(J.bsr_matmat(jnp.asarray(x), jb))
    for ref in (y_pallas, y_xla):
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    tb = T.BSRMatrix.from_dense(_ragged(), bm=16, device="cpu")
    x = torch.as_tensor(_x(3, 64, 6))
    before = T.LAUNCHES["bsr"]
    assert torch.equal(T.bsr_matmat_kernel(x, tb), T.bsr_matmat(x, tb))
    assert T.LAUNCHES["bsr"] == before  # no kernel launched on the CPU


def test_convert_bsr_round_trip():
    jb, _ = JS.synthetic_fci_bsr(256, block=32, density=0.3, seed=7)
    tb = convert.bsr(jb.values, jb.col_idx, jb.row_idx, jb.row_ptr, jb.shape, jb.bm, jb.bn,
                     jb.diagonal, device="cpu")
    _same_bsr(jb, tb)
    q = J.BSRMatrixInt8.from_bsr(jb)
    tq = convert.bsr_int8(q.q, q.rq, q.cq, q.col_idx, q.row_idx, q.row_ptr, q.shape, q.bm,
                          q.bn, q.diagonal, device="cpu")
    _same_bsr(q, tq, INT8_FIELDS + ("diagonal",))


# -- the int8 tier -----------------------------------------------------------

@pytest.mark.parametrize("case", ["square", "nonsquare_blocks", "dropped_diag_block",
                                  "rectangular"])
def test_int8_storage_equals_jax(case):
    mat = _block_sparse(96, 16, seed=25)
    bm, bn, tol = 16, 16, 0.0
    if case == "nonsquare_blocks":
        bm, bn = 32, 16
    elif case == "dropped_diag_block":
        mat[16:32, 16:32] = 1e-4 * np.eye(16)   # under tol: the block is dropped
        tol = 1e-3
    elif case == "rectangular":
        mat = mat[:80, :]
    jq = J.BSRMatrixInt8.from_dense(mat, bm=bm, bn=bn, tol=tol)
    tq = T.BSRMatrixInt8.from_dense(mat, bm=bm, bn=bn, tol=tol, device="cpu")
    _same_bsr(jq, tq, INT8_FIELDS)
    if jq.diagonal is None:
        assert tq.diagonal is None
    else:
        _same_bytes(jq.diagonal, tq.diagonal)
    if case == "dropped_diag_block":
        assert not np.any(tq.diagonal.numpy()[16:32])


def test_int8_from_bsr_keeps_topology():
    jb, _ = JS.synthetic_fci_bsr(256, block=32, density=0.3, seed=27)
    tb, _ = TS.synthetic_fci_bsr(256, block=32, density=0.3, seed=27, device="cpu")
    jq, tq = J.BSRMatrixInt8.from_bsr(jb), T.BSRMatrixInt8.from_bsr(tb)
    _same_bsr(jq, tq, INT8_FIELDS + ("diagonal",))
    assert tq.col_idx is tb.col_idx and tq.nnz == tb.nnz


@pytest.mark.parametrize("m", [1, 4])
def test_int8_action_equals_jax(m):
    jb, dense = JS.synthetic_fci_bsr(256, block=32, density=0.3, seed=28)
    tb, _ = TS.synthetic_fci_bsr(256, block=32, density=0.3, seed=28, device="cpu")
    jq, tq = J.BSRMatrixInt8.from_bsr(jb), T.BSRMatrixInt8.from_bsr(tb)
    x = _x(m, 256, 29, np.float32)
    y = T.bsr_matmat_int8(torch.as_tensor(x), tq)
    y_jax = np.asarray(J.bsr_matmat_int8(jnp.asarray(x), jq))
    assert y.dtype == torch.float32
    assert np.array_equal(y.numpy(), y_jax)
    # the bf16 coupling-accuracy class of the tier
    ref = x.astype(np.float64) @ dense.T
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 1e-2


def test_headroom_guard_raises_as_jax():
    bn = 1024
    rows = np.zeros(140, dtype=np.int32)   # 140 blocks in one row: 140*127^2*1024 > 2^31
    with pytest.raises(ValueError) as jerr:
        J.check_int8_accum_headroom(rows, bn)
    with pytest.raises(ValueError) as terr:
        T.check_int8_accum_headroom(torch.as_tensor(rows), bn)
    assert str(terr.value) == str(jerr.value)
    T.check_int8_accum_headroom(rows[:120], bn)   # inside the headroom


# -- FusedDavidson with a BSR action --------------------------------------------

def _one_hot(diag, nroots):
    v0 = np.zeros((nroots, diag.shape[0]))
    for r, i in enumerate(np.argsort(diag)[:nroots]):
        v0[r, i] = 1.0
    return v0


def test_fused_davidson_with_bsr_matches_jax():
    """tests/test_spmv.py:84-105: n=128, 2 roots, m_max 16, ``run``."""
    matrix = _block_sparse(128, 16, density=0.2, seed=5)
    jb = J.BSRMatrix.from_dense(matrix, bm=16, bn=16)
    n_rb = jb.shape[0] // jb.bm

    def jmatvec(x, op):
        values, col_idx, row_idx = op
        return J._bsr_matmat_xla(x, values, col_idx, row_idx, jb.bm, jb.bn, n_rb)

    js = JDavidson(jmatvec, np.diag(matrix), 128, 2, m_max=16,
                   operand=(jb.values, jb.col_idx, jb.row_idx))
    tb = T.BSRMatrix.from_dense(matrix, bm=16, bn=16, device="cpu")
    tmatvec, op = T.bsr_matvec(tb)
    ts = TDavidson(tmatvec, np.diag(matrix), 128, 2, m_max=16, operand=op, device="cpu")
    v0 = _one_hot(np.diag(matrix), 2)
    je, _, _, jit = js.run(v0)
    te, _, terr, tit = ts.run(v0)
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-10)
    assert tit == int(jit)
    np.testing.assert_allclose(te, np.linalg.eigvalsh(matrix)[:2], rtol=0, atol=1e-8)


def test_fused_davidson_with_bsr_run_on_device_matches_jax():
    """The chip_smoke configuration cut to n=1024 (block 64): 8 roots,
    m_max 32, rr 'full', tol 1e-8, ``run_on_device``."""
    jb, dense = JS.synthetic_fci_bsr(1024, block=64, density=0.3, seed=1)
    tb, _ = TS.synthetic_fci_bsr(1024, block=64, density=0.3, seed=1, device="cpu")
    n_rb = jb.shape[0] // jb.bm

    def jmatvec(x, op):
        values, col_idx, row_idx = op
        return J._bsr_matmat_xla(x, values, col_idx, row_idx, jb.bm, jb.bn, n_rb)

    diag = np.diagonal(dense)
    kw = dict(m_max=32, rr="full", convergence_threshold=1e-8, max_iter=60)
    js = JDavidson(jmatvec, diag, 1024, 8, operand=(jb.values, jb.col_idx, jb.row_idx), **kw)
    tmatvec, op = T.bsr_matvec(tb)
    ts = TDavidson(tmatvec, diag, 1024, 8, operand=op, device="cpu", **kw)
    v0 = _one_hot(diag, 8)
    je, _, _, jit = js.run_on_device(v0)
    te, tx, terr, tit = ts.run_on_device(v0)
    assert np.max(terr) <= 1e-8
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-10)
    assert tit == int(jit)
    np.testing.assert_allclose(te, np.linalg.eigvalsh(dense)[:8], rtol=0, atol=1e-9)


def test_bsr_matvec_uses_its_operand():
    tb = T.BSRMatrix.from_dense(_block_sparse(64, 16, seed=8), bm=16, device="cpu")
    matvec, (values, row_ptr, col_idx) = T.bsr_matvec(tb)
    x = torch.as_tensor(_x(2, 64, 9))
    y = matvec(x, (2.0 * values, row_ptr, col_idx))
    assert torch.allclose(y, 2.0 * T.bsr_matmat(x, tb), rtol=0, atol=1e-13)


# -- K6's work split, emulated on the CPU ----------------------------------------

def _walk(x, bsr, items):
    """K6's CTAs in order, each summing its blocks' products in the row's
    block order into its own output columns, in float64."""
    x = x.to(torch.float64)
    vals = bsr.values.to(torch.float64)
    cols = bsr.col_idx.tolist()
    y = torch.full((x.shape[0], bsr.shape[0]), float("nan"), dtype=torch.float64)
    for rb, i0, ncols, k0, k1 in items.tolist():
        acc = torch.zeros((x.shape[0], ncols), dtype=torch.float64)
        for k in range(k0, k1):
            xt = x[:, cols[k] * bsr.bn:(cols[k] + 1) * bsr.bn]
            acc += xt @ vals[k, i0:i0 + ncols].T
        y[:, rb * bsr.bm + i0:rb * bsr.bm + i0 + ncols] = acc
    return y


def _split_cases():
    """(name, BSRMatrix on the CPU): bm != bn, empty block rows, a row of 24
    blocks, ragged output chunks, 128 columns per CTA, and the phenol-scale
    topology at 2^14."""
    from chip_smoke import phenol_int8_bsr

    mat = _block_sparse(480, 48, density=0.3, seed=40)
    mat[48:96, :] = 0.0                       # block row 1 empty
    mat[96:144, :] = np.random.default_rng(41).standard_normal((48, 480))
    yield "ragged", T.BSRMatrix.from_dense(mat, bm=48, bn=20, device="cpu")
    dense_row = _block_sparse(24 * 40, 40, density=0.2, seed=42)
    dense_row[:80, :] = np.random.default_rng(43).standard_normal((80, 24 * 40))
    yield "row_of_24", T.BSRMatrix.from_dense(dense_row, bm=80, bn=40, device="cpu")
    # 300 block rows of 128 x 4 blocks, 0 to 3 per row: 128 columns per CTA
    # at m <= 16
    rng = np.random.default_rng(45)
    counts = rng.integers(0, 4, size=300)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = np.repeat(np.arange(300), counts).astype(np.int32)
    cols = rng.integers(0, 50, size=rows.size).astype(np.int32)
    t = torch.as_tensor
    yield "wide_128", T.BSRMatrix(values=t(rng.standard_normal((rows.size, 128, 4))),
                                  col_idx=t(cols), row_idx=t(rows), row_ptr=t(row_ptr),
                                  shape=(300 * 128, 200), bm=128, bn=4)
    q, rows, cols, row_ptr, _, s = phenol_int8_bsr(1 << 14)
    values = torch.as_tensor(q, dtype=torch.float64) * (s / 127.0)
    yield "phenol_2^14", T.BSRMatrix(values=values, col_idx=t(cols), row_idx=t(rows),
                                     row_ptr=t(row_ptr), shape=(1 << 14, 1 << 14),
                                     bm=128, bn=128)


SPLIT_CASES = dict(_split_cases())


@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 33, 64])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_bsr_work_items_cover_each_output_once(case, m):
    bsr = SPLIT_CASES[case]
    items = T.bsr_work_items(bsr, m)
    n_rb = bsr.shape[0] // bsr.bm
    ic = T.bsr_columns_per_cta(n_rb, bsr.bm, m)
    assert ic in (T.NARROW_COLUMNS, T.WIDE_COLUMNS) and (ic == T.NARROW_COLUMNS or m <= 16)
    covered = np.zeros(bsr.shape[0], dtype=np.int64)
    row_ptr = bsr.row_ptr.numpy()
    for rb, i0, ncols, k0, k1 in items.tolist():
        assert 0 < ncols <= ic and (k0, k1) == (row_ptr[rb], row_ptr[rb + 1])
        covered[rb * bsr.bm + i0:rb * bsr.bm + i0 + ncols] += 1
    assert np.all(covered == 1)
    # the column chunks of one block row are neighbours in launch order
    assert np.all(np.diff(items[:, 0]) >= 0)
    if case == "row_of_24":
        assert int(np.max(items[:, 4] - items[:, 3])) >= 24


@pytest.mark.parametrize("m", [1, 16, 17, 64])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_bsr_work_items_walk_equals_plain(case, m):
    bsr = SPLIT_CASES[case]
    x = torch.as_tensor(_x(m, bsr.shape[1], 44))
    got = _walk(x, bsr, T.bsr_work_items(bsr, m))
    ref = T.bsr_matmat(x, bsr)
    assert not torch.isnan(got).any()
    assert torch.allclose(got, ref, rtol=0, atol=1e-12 * float(ref.abs().max()))


def test_bsr_columns_per_cta_fills_the_card():
    """The bench operator (64 block rows of 128) keeps 32 columns, 256 CTAs;
    the phenol scale (8192 block rows) takes all 128 at 16 rows, 32 above;
    32 where 128 would leave too few CTAs or bm is 64."""
    assert T.bsr_columns_per_cta(64, 128, 16) == 32
    assert T.bsr_columns_per_cta(64, 128, 4) == 32
    assert T.bsr_columns_per_cta(8192, 128, 16) == 128
    assert T.bsr_columns_per_cta(8192, 128, 17) == 32
    assert T.bsr_columns_per_cta(200, 128, 16) == 32
    assert T.bsr_columns_per_cta(8192, 64, 8) == 32
    assert T.bsr_columns_per_cta(8192, 100, 8) == 128
