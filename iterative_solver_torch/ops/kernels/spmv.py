"""Block-sparse (BSR) operator action (port of
iterative_solver_tpu/ops/kernels/spmv_pallas.py).

A sparse CI Hamiltonian is stored as (bm, bn) dense blocks, only the
nonzero ones: ``values`` (nb, bm, bn), the block column of each block
(``col_idx``), its block row (``row_idx``, sorted) and the row pointer
(``row_ptr``, n_rb + 1). The action on a row block is

    y[:, rb*bm + i] = sum_{k in row rb} sum_j x[:, col_idx[k]*bn + j] V[k, i, j]

that is y = x Aᵀ. Storage is byte-identical to the JAX package's (padding,
``tol`` pruning, non-square blocks), so one host packing feeds both
packages (``convert.bsr``).

- ``bsr_matmat`` is the plain PyTorch version, the counterpart of
  ``_bsr_matmat_xla``: gather the x tiles, one batched block product, then
  ``index_add_`` over block rows.
- ``bsr_matmat_kernel`` is K6, CUDA C++ for sm_90a (``csrc/spmv.cu``),
  replacing ``bsr_matmat_pallas`` / ``_bsr_matmat_pallas_impl``. A CUDA
  tensor launches it (or the wrapper raises) and counts the launch in
  ``LAUNCHES``; a CPU tensor takes the plain version.

The quantized tier ``BSRMatrixInt8`` (two-sided equilibration, exact
diagonal) has no Pallas kernel in the JAX package: its action
``bsr_matmat_int8`` is an exact integer contraction in XLA there and in
PyTorch here (in float64, exact because every partial sum is an integer
below 2^31; ``check_int8_accum_headroom``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ... import config
from . import _build
from .symm import _tiles_to_tensor
from .symm_int8 import quantize_rows

Tensor = torch.Tensor

# launches of K6, counted by the wrapper
LAUNCHES = {"bsr": 0}

# rows of x the kernel takes in one launch
MAX_ROWS = 64
# K6's work split: output columns per CTA, the wide one for at most 16
# rows of x; and the CTAs it keeps for the H100's 132 SMs before it takes
# the wide one
NARROW_COLUMNS, WIDE_COLUMNS = 32, 128
_MIN_CTAS = 2 * 132


@dataclasses.dataclass
class BSRMatrix:
    """Block-sparse row matrix: values (nb, bm, bn), block col indices (nb,),
    block row ids (nb,) sorted by row, and row pointer (n_rb + 1,)."""

    values: Tensor        # (n_blocks, bm, bn)
    col_idx: Tensor       # (n_blocks,) int32 block column of each block
    row_idx: Tensor       # (n_blocks,) int32 block row of each block
    row_ptr: Tensor       # (n_row_blocks + 1,) int32
    shape: Tuple[int, int]
    bm: int
    bn: int
    diagonal: Optional[Tensor] = None

    @property
    def n_blocks(self) -> int:
        return self.values.shape[0]

    @property
    def nnz(self) -> int:
        return self.n_blocks * self.bm * self.bn

    @classmethod
    def from_dense(cls, matrix: np.ndarray, bm: Optional[int] = None,
                   bn: Optional[int] = None, tol: float = 0.0, dtype=None,
                   device=None) -> "BSRMatrix":
        """spmv_pallas.py:57-95: pad to the block multiple and keep each
        block whose largest magnitude exceeds ``tol``, in row-major block
        order (one reshape/swap view, no per-block loop). ``bm`` defaults
        to the ``BSR_BLOCK`` option, ``bn`` to ``bm``; ``device=None`` is
        the CUDA device and ``dtype=None`` the device's working dtype."""
        device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(device)
        if bm is None:
            bm = int(config.get_option("BSR_BLOCK"))
        if bn is None:
            bn = bm
        matrix = np.asarray(matrix, dtype=np.float64)
        n, m = matrix.shape
        n_pad = ((n + bm - 1) // bm) * bm
        m_pad = ((m + bn - 1) // bn) * bn
        padded = np.zeros((n_pad, m_pad))
        padded[:n, :m] = matrix
        n_rb, n_cb = n_pad // bm, m_pad // bn
        grid = padded.reshape(n_rb, bm, n_cb, bn).swapaxes(1, 2)
        rows, cols = np.nonzero(np.abs(grid).max(axis=(2, 3)) > tol)
        row_ptr = np.zeros(n_rb + 1, dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=n_rb), out=row_ptr[1:])
        return cls(
            values=_tiles_to_tensor(grid[rows, cols], dtype, device),
            col_idx=torch.as_tensor(cols.astype(np.int32), device=device),
            row_idx=torch.as_tensor(rows.astype(np.int32), device=device),
            row_ptr=torch.as_tensor(row_ptr, device=device),
            shape=(n_pad, m_pad),
            bm=bm,
            bn=bn,
            diagonal=_tiles_to_tensor(np.diagonal(padded).copy(), dtype, device),
        )


def bsr_matmat(x: Tensor, bsr: BSRMatrix) -> Tensor:
    """Plain PyTorch version of K6 (spmv_pallas.py:98-115): y (m, N) = x Aᵀ
    by a gather of x tiles, a batched block product and ``index_add_`` over
    block rows, in the promoted dtype of x and the values."""
    n_rb = bsr.shape[0] // bsr.bm
    dtype = torch.promote_types(x.dtype, bsr.values.dtype)
    m = x.shape[0]
    xt = x.to(dtype).reshape(m, -1, bsr.bn).transpose(0, 1)      # (n_cb, m, bn)
    contrib = torch.einsum("kmn,kin->kmi", xt[bsr.col_idx.long()],
                           bsr.values.to(dtype))                  # (nb, m, bm)
    y = torch.zeros((n_rb, m, bsr.bm), dtype=dtype, device=x.device)
    y.index_add_(0, bsr.row_idx.long(), contrib)
    return y.transpose(0, 1).reshape(m, n_rb * bsr.bm)


@functools.lru_cache(maxsize=256)
def bsr_columns_per_cta(n_rb: int, bm: int, m: int) -> int:
    """K6's output columns per CTA: WIDE_COLUMNS where m <= 16, bm needs
    more than half of them and that still gives two CTAs per SM (one CTA
    stages each x tile for the whole block row), else NARROW_COLUMNS."""
    if (m <= 16 and 2 * bm > WIDE_COLUMNS
            and n_rb * -(-bm // WIDE_COLUMNS) >= _MIN_CTAS):
        return WIDE_COLUMNS
    return NARROW_COLUMNS


def bsr_work_items(bsr: BSRMatrix, m: int) -> np.ndarray:
    """K6's CTAs in launch order, as rows ``(block row, first output column
    of the row block, output columns, first block, end block)``: CTA b takes
    block row b // ceil(bm / ic) and column chunk b % ceil(bm / ic), and sums
    the blocks [row_ptr[rb], row_ptr[rb + 1]) in order. The kernel derives
    the same from its block index and ``row_ptr``."""
    n_rb = bsr.shape[0] // bsr.bm
    ic = bsr_columns_per_cta(n_rb, bsr.bm, m)
    nci = -(-bsr.bm // ic)
    b = np.arange(n_rb * nci)
    rb, i0 = b // nci, (b % nci) * ic
    row_ptr = bsr.row_ptr.cpu().numpy().astype(np.int64)
    return np.stack([rb, i0, np.minimum(ic, bsr.bm - i0), row_ptr[rb], row_ptr[rb + 1]], 1)


def _check_operands(x: Tensor, bsr: BSRMatrix) -> None:
    """What K6 takes: float32 x of 1 to MAX_ROWS rows and the operator's
    column width; float32 or bf16 values of shape (nb, bm, bn); int32
    row_ptr (n_rb + 1,) and col_idx (nb,); all contiguous, on x's device."""
    if x.dim() != 2:
        raise ValueError(f"x must be a (rows, N) block, got shape {tuple(x.shape)}")
    m, n = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA BSR kernel takes float32 x, got {x.dtype}")
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"the CUDA BSR kernel takes 1 to {MAX_ROWS} rows of x, got {m}")
    if n != bsr.shape[1]:
        raise ValueError(f"x width {n} does not match the operator's {bsr.shape[1]} columns")
    values = bsr.values
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA BSR kernel takes float32 or bfloat16 values, "
                        f"got {values.dtype}")
    if values.dim() != 3 or values.shape[1:] != (bsr.bm, bsr.bn):
        raise ValueError(f"values must be (n_blocks, {bsr.bm}, {bsr.bn}), "
                         f"got {tuple(values.shape)}")
    n_rb = bsr.shape[0] // bsr.bm
    for name, arr, shape in (("row_ptr", bsr.row_ptr, (n_rb + 1,)),
                             ("col_idx", bsr.col_idx, (values.shape[0],))):
        if arr.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {arr.dtype}")
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(arr.shape)}")
    for name, arr in (("values", values), ("row_ptr", bsr.row_ptr),
                      ("col_idx", bsr.col_idx)):
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}, x on {x.device}")
        if not arr.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _spmv_lib():
    lib = _build.load("spmv")
    for fn in (lib.bsr_matmat_f32, lib.bsr_matmat_bf16):
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        fn.restype = _I
    return lib


def bsr_matmat_kernel(x: Tensor, bsr: BSRMatrix) -> Tensor:
    """K6: the BSR action y = x Aᵀ, one CTA per block row and 32 or 128
    output columns (``bsr_work_items``), replacing ``bsr_matmat_pallas``.
    A CUDA tensor launches
    ``bsr_matmat_f32`` / ``bsr_matmat_bf16`` and returns float32; a CPU
    tensor takes the plain version ``bsr_matmat``."""
    if x.device.type == "cpu":
        return bsr_matmat(x, bsr)
    x = x.contiguous()
    _check_operands(x, bsr)
    m, n = x.shape
    n_rb = bsr.shape[0] // bsr.bm
    # the kernel writes every entry: empty block rows get zeros
    y = x.new_empty((m, n_rb * bsr.bm))
    lib = _spmv_lib()
    bf16 = bsr.values.dtype == torch.bfloat16
    fn = lib.bsr_matmat_bf16 if bf16 else lib.bsr_matmat_f32
    err = fn(x.data_ptr(), bsr.values.data_ptr(), bsr.row_ptr.data_ptr(),
             bsr.col_idx.data_ptr(), y.data_ptr(), m, n, bsr.bm, bsr.bn, n_rb,
             bsr_columns_per_cta(n_rb, bsr.bm, m), _build.stream_handle(x.device))
    _build.check(lib, err, "bsr_matmat_bf16" if bf16 else "bsr_matmat_f32")
    LAUNCHES["bsr"] += 1
    return y


def bsr_matvec(bsr: BSRMatrix):
    """``(matvec, operand)`` for ``FusedDavidson``'s generic constructor:
    ``matvec(x, operand)`` runs K6 on CUDA tensors (the plain version on the
    CPU) with the values and topology passed as the operand, in the
    working dtype of x."""
    def matvec(x, op):
        values, row_ptr, col_idx = op
        b = dataclasses.replace(bsr, values=values, row_ptr=row_ptr, col_idx=col_idx)
        return bsr_matmat_kernel(x, b).to(x.dtype)

    return matvec, (bsr.values, bsr.row_ptr, bsr.col_idx)


# ---------------------------------------------------------------------------
# Int8 quantized BSR (spmv_pallas.py:224-373): two-sided equilibration,
#     E[P,Q] ~= rq[P] * cq[Q] * Q8[P,Q],   rq = r/sqrt(127), cq = c/sqrt(127)
# with r = sqrt(rowmax|E|), c = sqrt(colmax|E|), and the exact diagonal
# split out of square operators.


def check_int8_accum_headroom(row_idx, bn: int, context: str = "BSRMatrixInt8") -> None:
    """Exact-int32 accumulation guard (spmv_pallas.py:243-260): each output
    entry receives one int8 dot per block in its row, each bounded by
    127*127*bn; refuse loudly where int32 could wrap."""
    rows = row_idx.cpu().numpy() if isinstance(row_idx, torch.Tensor) else np.asarray(row_idx)
    max_bpr = int(np.bincount(rows).max()) if rows.size else 0
    if max_bpr * 127 * 127 * bn >= 2 ** 31:
        limit = 2 ** 31 // (127 * 127)
        raise ValueError(
            f"{context}: densest block row has {max_bpr} blocks x "
            f"bn={bn} (effective {max_bpr * bn} columns) — exceeds the "
            f"exact-int32 accumulation headroom (~{limit} effective "
            "columns); split the operator over a mesh or use a float "
            "tier")


@dataclasses.dataclass
class BSRMatrixInt8:
    """Quantized BSR: one int8 plane, row/column equilibration and the exact
    diagonal."""

    q: Tensor             # (n_blocks, bm, bn) int8
    rq: Tensor            # (n_pad_rows,) float32 row equilibration (incl. 1/sqrt127)
    cq: Tensor            # (n_pad_cols,) float32 column equilibration
    col_idx: Tensor       # (n_blocks,) int32
    row_idx: Tensor       # (n_blocks,) int32
    row_ptr: Tensor       # (n_row_blocks + 1,) int32
    shape: Tuple[int, int]
    bm: int
    bn: int
    diagonal: Optional[Tensor] = None   # (n_pad,) float32 exact diagonal (square)

    @property
    def n_blocks(self) -> int:
        return self.q.shape[0]

    @property
    def nnz(self) -> int:
        return self.n_blocks * self.bm * self.bn

    @classmethod
    def from_bsr(cls, bsr: BSRMatrix) -> "BSRMatrixInt8":
        """Quantize an existing BSR operator, keeping its block topology
        (spmv_pallas.py:286-342). The new tensors lie on the values'
        device."""
        device = bsr.values.device
        sqrt127 = float(np.sqrt(127.0))
        vals = bsr.values.to(torch.float64).cpu().numpy()
        rows = bsr.row_idx.cpu().numpy()
        cols = bsr.col_idx.cpu().numpy()
        bm, bn = bsr.bm, bsr.bn
        n_pad, m_pad = bsr.shape
        check_int8_accum_headroom(rows, bn)
        # the diagonal split needs the matrix diagonal to align with the
        # diagonal BLOCKS: square matrix and square blocks only; a
        # tol-dropped diagonal block contributes nothing in the float path,
        # so its rows get no split either
        square = n_pad == m_pad and bm == bn and bsr.diagonal is not None
        diag = np.zeros(n_pad)
        if square:
            has_diag_block = np.zeros(n_pad // bm, dtype=bool)
            has_diag_block[rows[rows == cols]] = True
            diag = bsr.diagonal.to(torch.float64).cpu().numpy()
            diag = np.where(np.repeat(has_diag_block, bm), diag, 0.0)
        E = vals.copy()
        ar_m = np.arange(bm)
        row_gidx = rows[:, None] * bm + ar_m[None, :]              # (nb, bm)
        col_gidx = cols[:, None] * bn + np.arange(bn)[None, :]     # (nb, bn)
        if square and E.shape[0]:
            dmask = np.where(rows == cols)[0]
            E[dmask[:, None], ar_m[None, :], ar_m[None, :]] -= diag[row_gidx[dmask]]
        rowmax = np.zeros(n_pad)
        colmax = np.zeros(m_pad)
        absE = np.abs(E)
        np.maximum.at(rowmax, row_gidx, absE.max(axis=2))
        np.maximum.at(colmax, col_gidx, absE.max(axis=1))
        r = np.sqrt(np.where(rowmax > 0.0, rowmax, 1.0))
        c = np.sqrt(np.where(colmax > 0.0, colmax, 1.0))
        scaled = E / (r[row_gidx][:, :, None] * c[col_gidx][:, None, :])
        q = np.clip(np.rint(127.0 * scaled), -127, 127).astype(np.int8)
        return cls(
            q=torch.from_numpy(q).to(device),
            rq=torch.from_numpy((r / sqrt127).astype(np.float32)).to(device),
            cq=torch.from_numpy((c / sqrt127).astype(np.float32)).to(device),
            col_idx=bsr.col_idx,
            row_idx=bsr.row_idx,
            row_ptr=bsr.row_ptr,
            shape=bsr.shape,
            bm=bm,
            bn=bn,
            diagonal=(torch.as_tensor(diag, dtype=torch.float32, device=device)
                      if square else None),
        )

    @classmethod
    def from_dense(cls, matrix: np.ndarray, bm: Optional[int] = None,
                   bn: Optional[int] = None, tol: float = 0.0,
                   device=None) -> "BSRMatrixInt8":
        """Quantize from the float64 blocks of ``matrix`` (as the JAX
        package does with float64 enabled), whatever the device."""
        device = config.resolve_device(device)
        host = BSRMatrix.from_dense(matrix, bm=bm, bn=bn, tol=tol,
                                    dtype=torch.float64, device="cpu")
        q = cls.from_bsr(host)
        moved = {f.name: getattr(q, f.name).to(device)
                 for f in dataclasses.fields(q) if isinstance(getattr(q, f.name), Tensor)}
        return dataclasses.replace(q, **moved)


def _bsr_matmat_int8_plain(qx: Tensor, q: Tensor, col_idx: Tensor, row_idx: Tensor,
                           bm: int, bn: int, n_rb: int) -> Tensor:
    """The int32 accumulator of the quantized action (spmv_pallas.py:350-358).
    PyTorch has no int32 batched product on CUDA, so the contraction runs in
    float64: every product and partial sum is an integer below 2^31 < 2^53
    (``check_int8_accum_headroom``), exact in any order."""
    m = qx.shape[0]
    f64 = torch.float64
    xt = qx.reshape(m, -1, bn).transpose(0, 1).to(f64)
    contrib = torch.einsum("kmn,kin->kmi", xt[col_idx.long()], q.to(f64))
    acc = torch.zeros((n_rb, m, bm), dtype=f64, device=qx.device)
    acc.index_add_(0, row_idx.long(), contrib)
    return acc.transpose(0, 1).reshape(m, n_rb * bm).to(torch.int32)


def bsr_matmat_int8(x: Tensor, bsr: BSRMatrixInt8) -> Tensor:
    """Quantized BSR action y = x Eᵀ * scales + x * diag
    (spmv_pallas.py:361-373): float32 whatever the dtype of x, cast back."""
    n_rb = bsr.shape[0] // bsr.bm
    xf = x.to(torch.float32)
    qx, sx = quantize_rows(xf * bsr.cq[None, :])
    acc = _bsr_matmat_int8_plain(qx, bsr.q, bsr.col_idx, bsr.row_idx, bsr.bm, bsr.bn, n_rb)
    y = acc.to(torch.float32) * sx * bsr.rq[None, :]
    if bsr.diagonal is not None:
        y = y + xf * bsr.diagonal[None, :]
    return y.to(x.dtype)
