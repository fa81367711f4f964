"""Symmetric dense operator action streaming only the packed lower triangle.

Counterpart of iterative_solver_tpu/ops/kernels/symm_pallas.py. A dense
symmetric action ``y = x A`` is bound by the bytes of A, and every
off-diagonal tile A_ij carries both contributions

    y_i += x_j A_ijᵀ        and        y_j += x_i A_ij,

so reading only the packed lower triangle, each tile once, halves the bytes.

Storage is byte-identical to the JAX package's: ``(n_pairs, b, b)`` tiles,
``ii``/``jj`` in row-major lower-pair order (``np.tril_indices``), the
diagonal, and the bf16 ``hi``/``lo`` planes of the split tier. One host
packing feeds both packages (see ``convert.py``).

Kernels (CUDA C++ for sm_90a, ``csrc/symm_packed.cu``):

- ``symm_matmat_kernel`` replaces ``symm_matmat_pallas`` /
  ``_symm_matmat_pallas_impl`` (K1), with f32 tiles ("exact") or bf16 tiles
  ("fast", x rounded to bf16 before the product);
- ``symm_matmat_split_kernel`` replaces ``symm_matmat_split_pallas`` /
  ``_symm_matmat_split_impl`` (K3), the split double-bf16 "precise" tier.

Each wrapper launches its kernel for a CUDA tensor (or raises) and counts
the launch in ``LAUNCHES``; for a CPU tensor it runs the plain PyTorch
version beside it (``symm_matmat``, ``symm_matmat_split``), which the CPU
tests hold against JAX and ``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ... import config as _config  # noqa: F401  (precision pins)
from . import _build

Tensor = torch.Tensor

# launches of each kernel variant, counted by the wrappers
LAUNCHES = {"symm_f32": 0, "symm_bf16": 0, "symm_split": 0}


@dataclasses.dataclass
class SymmetricBlocked:
    """Packed lower triangle of a symmetric matrix in (b, b) tiles.

    ``values[t]`` is the tile A[ii[t]*b:(ii[t]+1)*b, jj[t]*b:(jj[t]+1)*b]
    for the row-major lower-pair enumeration (i, j <= i)."""

    values: Tensor       # (n_pairs, b, b)
    ii: Tensor           # (n_pairs,) int32 block row
    jj: Tensor           # (n_pairs,) int32 block col (jj <= ii)
    shape: Tuple[int, int]
    b: int
    diagonal: Optional[Tensor] = None

    @property
    def n_pairs(self) -> int:
        return self.values.shape[0]

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512, dtype=torch.float64,
                   tol: Optional[float] = None,
                   device="cpu") -> "SymmetricBlocked":
        """Pack the lower triangle in (b, b) tiles (symm_pallas.py:67-104).
        With ``tol`` set, tiles whose largest magnitude is <= tol are
        dropped (the packed layout then doubles as a sparse-symmetric
        format)."""
        iis, jjs, tiles, diagonal, n_pad, b = _pack_lower(matrix, b, tol)
        return cls(
            values=_tiles_to_tensor(tiles, dtype, device),
            ii=torch.as_tensor(iis.astype(np.int32), device=device),
            jj=torch.as_tensor(jjs.astype(np.int32), device=device),
            shape=(n_pad, n_pad),
            b=b,
            diagonal=torch.as_tensor(diagonal, dtype=dtype, device=device),
        )


def _pack_lower(matrix, b, tol=None):
    """Host packing shared by both storage classes: pad to the tile
    multiple, gather the lower tile pairs (one reshape/swap view + fancy
    index, no per-tile loop). Returns (ii, jj, tiles f64, diagonal, n_pad, b)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    n = matrix.shape[0]
    if matrix.shape != (n, n):
        raise ValueError(f"operator must be square, got {matrix.shape}")
    if not np.array_equal(matrix, matrix.T):
        raise ValueError("SymmetricBlocked requires an exactly symmetric matrix")
    b = min(b, n)
    n_pad = ((n + b - 1) // b) * b
    padded = np.zeros((n_pad, n_pad))
    padded[:n, :n] = matrix
    nb = n_pad // b
    iis, jjs = np.tril_indices(nb)
    grid = padded.reshape(nb, b, nb, b).swapaxes(1, 2)
    if tol is not None:
        keep = (np.abs(grid).max(axis=(2, 3)) > tol)[iis, jjs]
        iis, jjs = iis[keep], jjs[keep]
    if iis.size == 0:  # all-zero operator: keep one zero tile
        iis = np.zeros(1, dtype=np.int64)
        jjs = np.zeros(1, dtype=np.int64)
    return iis, jjs, grid[iis, jjs], np.diagonal(padded).copy(), n_pad, b


def _tiles_to_tensor(tiles: np.ndarray, dtype, device) -> Tensor:
    # bf16 has no numpy type: round from f32 (as ml_dtypes does from f64)
    if dtype == torch.bfloat16:
        return torch.from_numpy(tiles.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.as_tensor(tiles, dtype=dtype, device=device)


@dataclasses.dataclass
class SymmetricBlockedSplit:
    """Packed lower triangle in double-bfloat16 tiles: hi + lo sums to the
    f32-grade matrix while every product is a bf16 one."""

    hi: Tensor           # (n_pairs, b, b) bfloat16
    lo: Tensor           # (n_pairs, b, b) bfloat16 residual (A - hi)
    ii: Tensor
    jj: Tensor
    shape: Tuple[int, int]
    b: int
    diagonal: Optional[Tensor] = None

    @property
    def n_pairs(self) -> int:
        return self.hi.shape[0]

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512,
                   device="cpu") -> "SymmetricBlockedSplit":
        """symm_pallas.py:257-272: f32 tiles, hi = bf16(tile), lo =
        bf16(tile - hi), the difference taken in f64 (exact)."""
        iis, jjs, tiles, diagonal, n_pad, b = _pack_lower(matrix, b)
        vals32 = torch.from_numpy(tiles.astype(np.float32))
        hi = vals32.to(torch.bfloat16)
        lo = (vals32.double() - hi.double()).to(torch.bfloat16)
        return cls(
            hi=hi.to(device),
            lo=lo.to(device),
            ii=torch.as_tensor(iis.astype(np.int32), device=device),
            jj=torch.as_tensor(jjs.astype(np.int32), device=device),
            shape=(n_pad, n_pad),
            b=b,
            diagonal=torch.as_tensor(diagonal, dtype=torch.float32, device=device),
        )


def bf16_split(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Double-bf16 split x ~= hi + lo (symm_pallas.py:306-322).

    For f32, hi keeps the top 16 bits of x by integer mask — truncation,
    not rounding — and lo = bf16(x - hi), where x - hi is exact. This is
    NOT ``x.bfloat16()``: rounding would drift the "precise" tier from the
    reference. Other dtypes round hi to bf16."""
    if x.dtype == torch.float32:
        xh_f32 = (x.view(torch.int32) & -65536).view(torch.float32)  # 0xFFFF0000
        return xh_f32.to(torch.bfloat16), (x - xh_f32).to(torch.bfloat16)
    xh = x.to(torch.bfloat16)
    return xh, (x - xh.to(x.dtype)).to(torch.bfloat16)


def _symm_matmat_plain(x: Tensor, values: Tensor, ii: Tensor, jj: Tensor,
                       b: int, nb: int) -> Tensor:
    """Gather/einsum/index_add_ form of the packed action
    (symm_pallas.py:107-121): reads every tile twice, once per
    contribution. ``x`` and ``values`` share a dtype."""
    m = x.shape[0]
    ii, jj = ii.long(), jj.long()
    xt = x.reshape(m, nb, b).transpose(0, 1)               # (nb, m, b)
    # y_i += x_j A_ij^T for all pairs
    contrib_i = torch.einsum("kmn,kin->kmi", xt[jj], values)
    y = torch.zeros((nb, m, b), dtype=x.dtype, device=x.device)
    y.index_add_(0, ii, contrib_i)
    # y_j += x_i A_ij for strict-lower pairs
    strict = (ii != jj).to(values.dtype)
    contrib_j = torch.einsum("kmn,kni->kmi", xt[ii], values)
    yj = torch.zeros_like(y).index_add_(0, jj, contrib_j * strict[:, None, None])
    return (y + yj).transpose(0, 1).reshape(m, nb * b)


def symm_matmat(x: Tensor, sym: SymmetricBlocked) -> Tensor:
    """Plain PyTorch version of K1, with the kernel's arithmetic: bf16
    tiles with f32 x round x to bf16 first (symm_pallas.py:159, :176-178);
    with f64 x (the CPU test tier) nothing is rounded and the tiles are
    widened, as in the JAX portable path (:107-121)."""
    nb = sym.shape[0] // sym.b
    values = sym.values
    if values.dtype == torch.bfloat16 and x.dtype == torch.float32:
        x = x.to(torch.bfloat16).to(torch.float32)
    return _symm_matmat_plain(x, values.to(x.dtype), sym.ii, sym.jj, sym.b, nb)


def symm_matmat_split(x: Tensor, sym: SymmetricBlockedSplit) -> Tensor:
    """Plain PyTorch version of K3 (symm_pallas.py:275-285): three
    single-bf16-product contractions x_h A_h + x_h A_l + x_l A_h in f32,
    whatever the dtype of x, cast back to it."""
    nb = sym.shape[0] // sym.b
    xh, xl = bf16_split(x.to(torch.float32))
    f32 = torch.float32
    hi, lo = sym.hi.to(f32), sym.lo.to(f32)
    xh, xl = xh.to(f32), xl.to(f32)
    y = _symm_matmat_plain(xh, hi, sym.ii, sym.jj, sym.b, nb)
    y = y + _symm_matmat_plain(xh, lo, sym.ii, sym.jj, sym.b, nb)
    y = y + _symm_matmat_plain(xl, hi, sym.ii, sym.jj, sym.b, nb)
    return y.to(x.dtype)


def _check_operands(x: Tensor, tiles, ii: Tensor, jj: Tensor, shape, b: int,
                    tile_dtypes) -> None:
    m, n = x.shape
    if n != shape[0]:
        raise ValueError(f"x width {n} does not match the operator dimension {shape[0]}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA packed kernels take float32 x, got {x.dtype}")
    for name, arr in (("x", x), ("ii", ii), ("jj", jj)) + tuple(
            (f"tiles[{k}]", a) for k, a in enumerate(tiles)):
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}, x on {x.device}")
        if not arr.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for a in tiles:
        if a.dtype not in tile_dtypes:
            raise TypeError(f"the CUDA packed kernels take tiles in {tile_dtypes}, "
                            f"got {a.dtype}")
        if a.shape != tiles[0].shape or a.shape[1:] != (b, b):
            raise ValueError(f"tiles must be (n_pairs, {b}, {b}), got {tuple(a.shape)}")
        if a.data_ptr() % 16:
            raise ValueError("tiles must be 16-byte aligned")
    if ii.dtype != torch.int32 or jj.dtype != torch.int32:
        raise TypeError("ii and jj must be int32")
    if ii.shape != (tiles[0].shape[0],) or jj.shape != ii.shape:
        raise ValueError("ii and jj must list one block pair per tile")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _symm_lib():
    lib = _build.load("symm_packed")
    lib.symm_packed_f32.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.symm_packed_bf16.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.symm_packed_split.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    for fn in (lib.symm_packed_f32, lib.symm_packed_bf16, lib.symm_packed_split):
        fn.restype = _I
    return lib


def symm_matmat_kernel(x: Tensor, sym: SymmetricBlocked) -> Tensor:
    """K1: half-traffic symmetric action, one pass over the packed lower
    triangle (replaces ``symm_matmat_pallas``). CUDA tensors launch
    ``symm_packed_f32`` / ``symm_packed_bf16`` and return f32; CPU tensors
    take the plain version ``symm_matmat``."""
    if x.device.type == "cpu":
        return symm_matmat(x, sym)
    x = x.contiguous()
    _check_operands(x, (sym.values,), sym.ii, sym.jj, sym.shape, sym.b,
                    (torch.float32, torch.bfloat16))
    m, n = x.shape
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    lib = _symm_lib()
    bf16 = sym.values.dtype == torch.bfloat16
    fn = lib.symm_packed_bf16 if bf16 else lib.symm_packed_f32
    err = fn(x.data_ptr(), sym.values.data_ptr(), sym.ii.data_ptr(),
             sym.jj.data_ptr(), y.data_ptr(), m, n, sym.b, sym.n_pairs,
             _build.stream_handle(x.device))
    _build.check(lib, err, "symm_packed_bf16" if bf16 else "symm_packed_f32")
    LAUNCHES["symm_bf16" if bf16 else "symm_f32"] += 1
    return y


def symm_matmat_split_kernel(x: Tensor, sym: SymmetricBlockedSplit) -> Tensor:
    """K3: the packed action from split-bf16 planes, three bf16 products per
    contribution (replaces ``symm_matmat_split_pallas``). CUDA tensors
    launch ``symm_packed_split`` (x split inside the kernel); CPU tensors
    take the plain version ``symm_matmat_split``."""
    if x.device.type == "cpu":
        return symm_matmat_split(x, sym)
    x = x.contiguous()
    _check_operands(x, (sym.hi, sym.lo), sym.ii, sym.jj, sym.shape, sym.b,
                    (torch.bfloat16,))
    m, n = x.shape
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    lib = _symm_lib()
    err = lib.symm_packed_split(
        x.data_ptr(), sym.hi.data_ptr(), sym.lo.data_ptr(), sym.ii.data_ptr(),
        sym.jj.data_ptr(), y.data_ptr(), m, n, sym.b, sym.n_pairs,
        _build.stream_handle(x.device))
    _build.check(lib, err, "symm_packed_split")
    LAUNCHES["symm_split"] += 1
    return y
