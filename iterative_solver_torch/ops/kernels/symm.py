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

Each kernel block walks one ``SQUARE`` x ``SQUARE`` piece of one tile,
forms both of its contributions and stores them in its own two slots of a
workspace; a second launch adds, for each ``SQUARE``-column segment of y,
the slots that feed it in a fixed order, so every call gives the same bits
(the source's head note gives the design). The blocks' work list and the
segments' slot lists are built here on the host from ``ii``/``jj``
(``square_work_list``, ``square_sum_list``) and cached on the storage
object; ``square_walk`` follows both in plain PyTorch, so the CPU tests
reach the walk and the order of the sums.

Each wrapper launches its kernel for a CUDA tensor (or raises) and counts
the launch in ``LAUNCHES``; for a CPU tensor it runs the plain PyTorch
version beside it (``symm_matmat``, ``symm_matmat_split``), which the CPU
tests hold against JAX and ``chip_smoke.py`` holds the kernels against.

``make_differentiable_symm_action`` (the twin of symm_pallas.py:396-444)
gives K1 an autograd rule: the operator is symmetric, so its adjoint is K1
again, run on the output's cotangent.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ... import config as _config
from . import _build

Tensor = torch.Tensor

# launches of each kernel variant, counted by the wrappers
LAUNCHES = {"symm_f32": 0, "symm_bf16": 0, "symm_split": 0}
# edge of the square a kernel block walks (csrc/symm_packed.cu SQ)
SQUARE = 256


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
    # the kernels' work list (square_work) and the segments' slot lists
    # (square_sums), cached; dataclasses.replace carries them
    work: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)
    sums: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)

    # the tensors a matvec takes as its operand (``packed_matvec``), in order
    OPERAND = ("values", "ii", "jj")

    @property
    def n_pairs(self) -> int:
        return self.values.shape[0]

    def kernel(self, x: Tensor) -> Tensor:
        """K1 on this storage (``symm_matmat_kernel``)."""
        return symm_matmat_kernel(x, self)

    def plain(self, x: Tensor) -> Tensor:
        """K1's plain version (``symm_matmat``)."""
        return symm_matmat(x, self)

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512, dtype=None,
                   tol: Optional[float] = None,
                   device=None) -> "SymmetricBlocked":
        """Pack the lower triangle in (b, b) tiles (symm_pallas.py:67-104).
        With ``tol`` set, tiles whose largest magnitude is <= tol are
        dropped (the packed layout then doubles as a sparse-symmetric
        format). ``device=None`` is the CUDA device (raises without it) and
        ``dtype=None`` the device's working dtype."""
        device = _config.resolve_device(device)
        if dtype is None:
            dtype = _config.default_dtype(device)
        iis, jjs, tiles, diagonal, n_pad, b = _pack_lower(matrix, b, tol)
        return cls(
            values=_tiles_to_tensor(tiles, dtype, device),
            ii=torch.as_tensor(iis.astype(np.int32), device=device),
            jj=torch.as_tensor(jjs.astype(np.int32), device=device),
            shape=(n_pad, n_pad),
            b=b,
            diagonal=torch.as_tensor(diagonal, dtype=dtype, device=device),
            **_walk_lists(iis, jjs, b, n_pad, device),
        )


def exactly_symmetric(matrix: np.ndarray, block: int = 256) -> bool:
    """matrix == matrix.T entry for entry (NaN never equal), compared one
    pair of ``block`` x ``block`` tiles at a time: a whole-matrix transposed
    compare walks one operand against its memory order (4x slower at n =
    8192)."""
    n = matrix.shape[0]
    return all(np.array_equal(matrix[i:i + block, j:j + block],
                              matrix[j:j + block, i:i + block].T)
               for i in range(0, n, block) for j in range(i, n, block))


def _pack_lower(matrix, b, tol=None):
    """Host packing shared by both storage classes: pad to the tile
    multiple, gather the lower tile pairs (one reshape/swap view + fancy
    index, no per-tile loop). Returns (ii, jj, tiles f64, diagonal, n_pad, b)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    n = matrix.shape[0]
    if matrix.shape != (n, n):
        raise ValueError(f"operator must be square, got {matrix.shape}")
    if not exactly_symmetric(matrix):
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


def square_work_list(ii, jj, b: int, square: int = SQUARE) -> np.ndarray:
    """The kernels' work list: one (t, r0, c0, diagonal) int32 row per
    ``square`` x ``square`` piece of each tile (ragged at the edge when b is
    not a multiple), off-diagonal tiles' squares first and diagonal tiles'
    (one contribution, so fewer products) last. ``diagonal`` is 1 where
    ii[t] == jj[t]."""
    ii = np.asarray(ii)
    diag = (ii == np.asarray(jj)).astype(np.int64)
    starts = np.arange(0, b, square)
    r0, c0 = (g.ravel() for g in np.meshgrid(starts, starts, indexing="ij"))
    per_tile = r0.size
    t = np.repeat(np.arange(ii.size), per_tile)
    work = np.stack([t, np.tile(r0, ii.size), np.tile(c0, ii.size),
                     np.repeat(diag, per_tile)], axis=1)
    return work[np.argsort(work[:, 3], kind="stable")].astype(np.int32)


def square_sum_list(work, ii, jj, b: int, n: int, square: int = SQUARE) -> np.ndarray:
    """The order of the kernels' sums, as one int32 array: the n_seg + 1
    offsets of the segments' runs, then the runs. Segment p * nsq + q (nsq =
    ceil(b / square)) is the ``square`` columns of y from p b + q square on;
    work item w stores y_i into slot 2 w (segment ii[t] nsq + r0 / square)
    and, off the diagonal, y_j into slot 2 w + 1 (segment jj[t] nsq + c0 /
    square). Each run lists its slots in increasing order; it depends only
    on ii/jj, b and n, as the work list does."""
    work = np.asarray(work, dtype=np.int64)
    ii, jj = np.asarray(ii, dtype=np.int64), np.asarray(jj, dtype=np.int64)
    nsq = -(-b // square)
    n_seg = (n // b) * nsq
    t, r0, c0 = work[:, 0], work[:, 1], work[:, 2]
    off = ii[t] != jj[t]
    items = np.arange(work.shape[0])
    seg = np.concatenate([ii[t] * nsq + r0 // square, (jj[t] * nsq + c0 // square)[off]])
    slot = np.concatenate([2 * items, 2 * items[off] + 1])
    order = np.lexsort((slot, seg))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=n_seg))])
    return np.concatenate([ptr, slot[order]]).astype(np.int32)


def _walk_lists(ii, jj, b: int, n: int, device) -> dict:
    work = square_work_list(ii, jj, b)
    return {"work": torch.as_tensor(work, device=device),
            "sums": torch.as_tensor(square_sum_list(work, ii, jj, b, n), device=device)}


def _cache_walk_lists(sym) -> None:
    ii, jj = sym.ii.cpu().numpy(), sym.jj.cpu().numpy()
    if sym.work is None:
        sym.work = torch.as_tensor(square_work_list(ii, jj, sym.b), device=sym.ii.device)
    if sym.sums is None:
        sym.sums = torch.as_tensor(
            square_sum_list(sym.work.cpu().numpy(), ii, jj, sym.b, sym.shape[0]),
            device=sym.ii.device)


def square_work(sym) -> Tensor:
    """``sym``'s work list on its device, built from ii/jj on first use and
    cached on the object (``from_dense`` builds it with the tiles)."""
    if sym.work is None:
        _cache_walk_lists(sym)
    return sym.work


def square_sums(sym) -> Tensor:
    """``sym``'s segment slot lists (``square_sum_list``) on its device,
    built on first use and cached on the object beside the work list."""
    if sym.sums is None:
        _cache_walk_lists(sym)
    return sym.sums


def square_walk(xs, planes, sym) -> Tensor:
    """Plain emulation of the kernels' walk and sums: for each work item,
    both contributions of one square, y_i = x_j Aᵀ and (off the diagonal)
    y_j = x_i A, summed over the paired x parts and tile planes (one pair
    for K1; (xh, hi), (xh, lo), (xl, hi) for K3) into the item's own slots;
    then each segment of y the sum of its slots in ``square_sums`` order.
    All in x's dtype; for the CPU tests, which hold it against the plain
    versions."""
    b = sym.b
    m, n = xs[0].shape
    ii, jj = sym.ii.tolist(), sym.jj.tolist()
    slots = {}
    for w, (t, r0, c0, diag) in enumerate(square_work(sym).tolist()):
        r1, c1 = min(r0 + SQUARE, b), min(c0 + SQUARE, b)
        rows = slice(ii[t] * b + r0, ii[t] * b + r1)
        cols = slice(jj[t] * b + c0, jj[t] * b + c1)
        yi = sum(x[:, cols] @ plane[t, r0:r1, c0:c1].T for x, plane in zip(xs, planes))
        slots[2 * w] = yi
        if ii[t] != jj[t]:
            slots[2 * w + 1] = sum(x[:, rows] @ plane[t, r0:r1, c0:c1]
                                   for x, plane in zip(xs, planes))
    sums = square_sums(sym).tolist()
    nsq = -(-b // SQUARE)
    n_seg = (n // b) * nsq
    y = torch.zeros_like(xs[0])
    for seg in range(n_seg):
        col0 = (seg // nsq) * b + (seg % nsq) * SQUARE
        width = min(SQUARE, b - (seg % nsq) * SQUARE)
        acc = torch.zeros((m, width), dtype=y.dtype)
        for k in range(sums[seg], sums[seg + 1]):
            acc = acc + slots[sums[n_seg + 1 + k]]
        y[:, col0:col0 + width] = acc
    return y


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
    work: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)
    sums: Optional[Tensor] = dataclasses.field(default=None, repr=False, compare=False)

    OPERAND = ("hi", "lo", "ii", "jj")

    @property
    def n_pairs(self) -> int:
        return self.hi.shape[0]

    def kernel(self, x: Tensor) -> Tensor:
        """K3 on this storage (``symm_matmat_split_kernel``)."""
        return symm_matmat_split_kernel(x, self)

    def plain(self, x: Tensor) -> Tensor:
        """K3's plain version (``symm_matmat_split``)."""
        return symm_matmat_split(x, self)

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512,
                   device=None) -> "SymmetricBlockedSplit":
        """symm_pallas.py:257-272: f32 tiles, hi = bf16(tile), lo =
        bf16(tile - hi), the difference taken in f64 (exact).
        ``device=None`` is the CUDA device (raises without it)."""
        device = _config.resolve_device(device)
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
            **_walk_lists(iis, jjs, b, n_pad, device),
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
    lib.symm_packed_f32.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.symm_packed_bf16.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.symm_packed_split.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    for fn in (lib.symm_packed_f32, lib.symm_packed_bf16, lib.symm_packed_split,
               lib.symm_packed_square_edge):
        fn.restype = _I
    if lib.symm_packed_square_edge() != SQUARE:
        raise RuntimeError(f"symm_packed.cu walks squares of {lib.symm_packed_square_edge()}, "
                           f"the work list {SQUARE}")
    return lib


def _walk_operands(sym, x: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """(work, sums, ws, n_seg) of a launch: the lists checked against the
    operand, and the slots' scratch (2 n_items, m, SQUARE) f32."""
    work, sums = square_work(sym), square_sums(sym)
    nsq = -(-sym.b // SQUARE)
    n_seg = (sym.shape[0] // sym.b) * nsq
    n_items = sym.n_pairs * nsq * nsq
    if (work.dtype != torch.int32 or work.device != x.device or not work.is_contiguous()
            or work.shape != (n_items, 4) or work.data_ptr() % 16):
        raise ValueError(f"work must be a contiguous, 16-byte aligned int32 "
                         f"({n_items}, 4) tensor on {x.device}")
    if (sums.dtype != torch.int32 or sums.device != x.device or not sums.is_contiguous()
            or sums.ndim != 1 or not n_seg + 1 <= sums.shape[0] <= n_seg + 1 + 2 * n_items):
        raise ValueError(f"sums must be a contiguous int32 list of {n_seg} segments "
                         f"on {x.device}")
    ws = torch.empty((2 * n_items, x.shape[0], SQUARE), dtype=torch.float32,
                     device=x.device)
    return work, sums, ws, n_seg


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
    work, sums, ws, n_seg = _walk_operands(sym, x)
    m, n = x.shape
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _symm_lib()
    bf16 = sym.values.dtype == torch.bfloat16
    fn = lib.symm_packed_bf16 if bf16 else lib.symm_packed_f32
    err = fn(x.data_ptr(), sym.values.data_ptr(), sym.ii.data_ptr(),
             sym.jj.data_ptr(), work.data_ptr(), sums.data_ptr(), ws.data_ptr(),
             y.data_ptr(), m, n, sym.b, work.shape[0], n_seg,
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
    work, sums, ws, n_seg = _walk_operands(sym, x)
    m, n = x.shape
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _symm_lib()
    err = lib.symm_packed_split(
        x.data_ptr(), sym.hi.data_ptr(), sym.lo.data_ptr(), sym.ii.data_ptr(),
        sym.jj.data_ptr(), work.data_ptr(), sums.data_ptr(), ws.data_ptr(), y.data_ptr(),
        m, n, sym.b, work.shape[0], n_seg, _build.stream_handle(x.device))
    _build.check(lib, err, "symm_packed_split")
    LAUNCHES["symm_split"] += 1
    return y


def packed_matvec(sym):
    """``(matvec, operand)`` of a packed storage (this module's or
    symm_int8.py's): ``matvec(x, operand)`` runs the storage's kernel
    wrapper (``sym.kernel``) with the operand's tensors in place of its own,
    cast to x's dtype. The operand is ``sym``'s ``OPERAND`` tensors, never a
    baked constant."""
    fields = type(sym).OPERAND

    def matvec(x, op):
        return dataclasses.replace(sym, **dict(zip(fields, op))).kernel(x).to(x.dtype)

    return matvec, tuple(getattr(sym, f) for f in fields)


def make_differentiable_symm_action(sym: SymmetricBlocked):
    """``action(x, values) -> y``, differentiable in both arguments (a
    ``torch.autograd.Function``; symm_pallas.py:396-444). The forward is
    ``symm_matmat_kernel`` on ``sym`` with ``values`` for its tiles: K1 for
    CUDA tensors, the plain ``symm_matmat`` for CPU tensors. The backward:

    - x-cotangent: the operator is symmetric, so the adjoint action is the
      same forward applied to the output cotangent ybar (one more K1 launch
      on the card, at the same half-traffic cost);
    - values-cotangent, per tile t = (i, j):
        vbar[t] = ybar_iᵀ x_j  +  [i != j] x_iᵀ ybar_j,
      two batched einsums over the pair list, plain PyTorch (JAX computes
      them in XLA, outside any Pallas kernel).

    The pair topology (ii, jj) and the cached work list are closed over.
    Where the kernel refuses an operand it raises; nothing falls back."""
    b = sym.b
    nb = sym.shape[0] // b
    ii, jj = sym.ii.long(), sym.jj.long()
    strict = sym.ii != sym.jj

    def forward(x, values):
        return symm_matmat_kernel(x, dataclasses.replace(sym, values=values))

    class SymmAction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, values):
            ctx.save_for_backward(x, values)
            return forward(x, values)

        @staticmethod
        def backward(ctx, ybar):
            x, values = ctx.saved_tensors
            # autograd may hand ybar over strided or in another dtype
            ybar = ybar.to(x.dtype).contiguous()
            xbar = vbar = None
            if ctx.needs_input_grad[0]:
                xbar = forward(ybar, values).to(x.dtype)
            if ctx.needs_input_grad[1]:
                m = x.shape[0]
                xt = x.reshape(m, nb, b).transpose(0, 1)
                yt = ybar.reshape(m, nb, b).transpose(0, 1)
                vbar = torch.einsum("kmp,kmq->kpq", yt[ii], xt[jj])
                vbar = vbar + strict.to(vbar.dtype)[:, None, None] * torch.einsum(
                    "kmp,kmq->kpq", xt[ii], yt[jj])
                vbar = vbar.to(values.dtype)
            return xbar, vbar

    return SymmAction.apply
