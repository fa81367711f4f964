"""Int8-quantized packed symmetric operator action (port of
iterative_solver_tpu/ops/kernels/symm_int8.py).

The operator is split into its exact diagonal and the off-diagonal part E,
and E is equilibrated symmetrically with one scale vector:

    g[P] = sqrt(max_Q |E[P,Q]|)  (1 on zero rows),   B = D^-1 E D^-1, D = diag(g)

so |B| <= 1 quantizes with the scalar scale 1/127:

    E[P,Q] ~= gq[P] gq[Q] Q[P,Q],   Q = round(127 B) in int8,   gq = g/sqrt(127).

x is pre-scaled by gq and row-quantized (xs = x*gq, sx = rowmax|xs|/127,
qx = round(xs/sx)), so every per-tile product is int8 x int8 summed in an
exact int32 accumulator, and the action is

    y = acc * sx * gq + x * d.

Two tiers: ``SymmetricBlockedInt8`` (one plane, the bf16 accuracy class)
and ``SymmetricBlockedInt8Split`` (Q1 + Q2/254, the split double-bf16
class). The storage (``q``, ``q1``, ``q2``, ``gq``, diagonal, ``ii``,
``jj``) is byte-identical to the JAX package's, so one host packing feeds
both packages (``convert.py``).

Kernels (CUDA C++ for sm_90a, ``csrc/symm_int8.cu``):

- ``symm_matmat_int8_kernel`` replaces ``symm_matmat_int8_pallas`` /
  ``_symm_matmat_int8_impl`` (K4), on the int8 tensor cores, in one of
  three walks that ``int8_walk`` picks from the call's shape, each bound
  by something else (csrc/symm_int8.cu's head note):
  - at one M tile (m <= 16) with enough bands to fill the card, the band
    walk: persistent blocks walk the bands of the tiles (``BAND_INT8``
    whole tile rows, streamed by TMA; ``int8_band_items``), bound by the
    tile stream and its y_j reds;
  - at four M tiles (33 <= m <= 64) with enough strips to fill the card,
    the strip walk: persistent blocks walk the strips of the tiles (all b
    rows across ``STRIP_INT8`` columns, streamed by TMA, both products as
    warpgroup products, wgmma; ``int8_strip_items``), bound by the L2,
    which takes the tile stream and the reds together;
  - otherwise the square walk: the ``SQUARE_INT8`` x ``SQUARE_INT8``
    squares (``int8_square_items``), for passes of up to 64 rows of x,
    bound by the SM's shared-memory pipe (ldmatrix of every fragment).
  ``K4_WALKS`` counts the calls of each walk;
- ``symm_matmat_int8_split_kernel`` replaces
  ``symm_matmat_int8_split_pallas`` / ``_symm_matmat_int8_split_impl`` (K5)
  with the same kernel on two planes: each tile byte pair feeds three
  products into two int32 sums, hi = p1 Q1 and lo = p1 Q2 + p2 Q1, for
  passes of 16 rows of x (``INT8_SPLIT_ROWS``).

``int8_square_walk`` follows K4's three walks and K5's in plain PyTorch
for the CPU tests, and ``int8_flush_atomics`` counts their flushes.

x is quantized in the wrapper with the same torch ops as the plain version
(the JAX package quantizes outside its Pallas kernels too). The kernels add
integer partial sums with atomics, which is exact in any order, and the
epilogue rounds in the plain version's order, so on the card y equals the
plain version bit for bit. Each wrapper launches for a CUDA tensor (or
raises) and counts one launch per action call in ``LAUNCHES``; for a CPU
tensor it runs the plain version (``symm_matmat_int8``,
``symm_matmat_int8_split``).

Int32 headroom: each accumulator entry receives at most 127*127*b per int8
product per tile column, so the one-plane tier is exact up to
2^31/127^2 ~= 133k columns and the split tier, whose lo accumulator takes
two products per tile, up to half that. ``from_dense`` refuses larger
operators (``_check_acc_headroom``): wraparound would be silent garbage.
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
from .symm import _check_operands, exactly_symmetric, packed_matvec

Tensor = torch.Tensor

# launches of each kernel, counted once per action call by the wrappers
LAUNCHES = {"symm_int8": 0, "symm_int8_split": 0}
# K4's calls by the walk they took (``int8_walk``)
K4_WALKS = {"band": 0, "square": 0, "strip": 0}

_SQRT127 = float(np.sqrt(127.0))

# K4's walk (csrc/symm_int8.cu): squares of SQUARE_INT8, streamed in chunks
# of CHUNK_INT8, for M_TILE rows of x per tensor-core M tile
SQUARE_INT8 = 256
CHUNK_INT8 = 64
M_TILE = 16
# K5's rows of x per pass: one M tile (its two planes' sums fill the
# registers that K4 gives to more rows)
INT8_SPLIT_ROWS = M_TILE
# K4's band walk: bands of BAND_INT8 tile rows across the whole width b,
# streamed in stages of BAND_STAGE_ROWS rows; one warp per 128 bytes of a
# row holds its y_j in registers, so b <= BAND_MAX_B; it engages where the
# bands give every SM at least BAND_MIN_PER_SM of them (one block an SM)
BAND_INT8 = 256
BAND_STAGE_ROWS = 32
BAND_MAX_B = 1024
BAND_MIN_PER_SM = 8
# K4's strip walk: strips of all b tile rows across STRIP_INT8 columns,
# streamed in stages of STRIP_STAGE_ROWS rows, for up to 64 rows of x; a
# warpgroup holds y_j of 256 columns in registers; it engages at four M
# tiles where the strips give every SM at least STRIP_MIN_PER_SM of them
# (one block an SM). On the H100 at 64 rows and b = 1024 it beat the square
# walk at every depth measured, in kernel ms: 0.033 against 0.071 at 0.55
# strips an SM (64 x 8192), 0.081 against 0.222 at 2 (a quarter of the
# flagship's pairs, as on a sharded rank), 0.300 against 0.861 at 8 (the
# PPCG flagship, 64 x 32768), 5.12 against 14.46 at 125 (the benchmark's
# operator)
STRIP_INT8 = 512
STRIP_STAGE_ROWS = 64
STRIP_MAX_B = 1024
STRIP_MIN_PER_SM = 0.5


def _pack_lower(matrix: np.ndarray, b: int):
    """Padded f64 working copy, edited in place by the equilibration (one
    full-size temporary; symm_int8.py:86-103)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    n = matrix.shape[0]
    if matrix.shape != (n, n):
        raise ValueError(f"operator must be square, got {matrix.shape}")
    if not exactly_symmetric(matrix):
        raise ValueError("int8 symmetric packing requires an exactly symmetric matrix")
    b = min(b, n)
    n_pad = ((n + b - 1) // b) * b
    if n_pad == n:
        work = matrix.astype(np.float64, copy=True)
    else:
        work = np.zeros((n_pad, n_pad))
        work[:n, :n] = matrix
    return work, n_pad, b


def _equilibrate_inplace(work: np.ndarray):
    """Diagonal split and off-diagonal row maxima: on return ``work`` holds
    E = A - diag(d). Returns (g, d), g[P] = sqrt(rowmax |E[P,:]|), 1 on zero
    rows."""
    d = np.diagonal(work).copy()
    np.fill_diagonal(work, 0.0)
    rowmax = np.abs(work).max(axis=1)
    g = np.sqrt(np.where(rowmax > 0.0, rowmax, 1.0))
    return g, d


def _check_acc_headroom(n_pad: int, b: int, dots_per_tile: int, what: str):
    """Refuse an operator whose worst-case int32 accumulation would wrap:
    ``dots_per_tile`` int8 products of at most 127*127*b per tile column."""
    worst = dots_per_tile * (n_pad // b) * 127 * 127 * b
    if worst >= 2 ** 31:
        limit = 2 ** 31 // (dots_per_tile * 127 * 127)
        raise ValueError(
            f"{what}: operator dimension {n_pad} exceeds the exact-int32 "
            f"accumulation headroom (max ~{limit} columns for this tier); "
            "shard the operator over a mesh (ShardedSymmetric.from_int8 "
            "bounds the per-device tile count) or use a float tier")


def _tile_pairs(B: np.ndarray, n_pad: int, b: int, tol_mask):
    """Lower tile pairs in row-major order by one reshape/swap view and one
    fancy index. Returns (tiles, ii int32, jj int32)."""
    nb = n_pad // b
    iis, jjs = np.tril_indices(nb)
    if tol_mask is not None:
        keep = tol_mask[iis, jjs]
        iis, jjs = iis[keep], jjs[keep]
    if iis.size == 0:
        iis = np.zeros(1, dtype=np.int64)
        jjs = np.zeros(1, dtype=np.int64)
    grid = B.reshape(nb, b, nb, b).swapaxes(1, 2)
    return grid[iis, jjs], iis.astype(np.int32), jjs.astype(np.int32)


def _tol_mask(E_scaled_src: np.ndarray, n_pad: int, b: int, tol: Optional[float]):
    if tol is None:
        return None
    nb = n_pad // b
    grid = E_scaled_src.reshape(nb, b, nb, b).swapaxes(1, 2)
    return np.abs(grid).max(axis=(2, 3)) > tol


def _equilibrated_tiles(matrix, b, tol, dots_per_tile, what):
    """The shared packing pipeline of both tiers: (B tiles f64, g, d, ii,
    jj, n_pad, b)."""
    work, n_pad, b = _pack_lower(matrix, b)
    _check_acc_headroom(n_pad, b, dots_per_tile, what)
    g, d = _equilibrate_inplace(work)             # work == E
    mask = _tol_mask(work, n_pad, b, tol)
    work /= g[:, None]
    work /= g[None, :]                            # work == B, in place
    tiles, ii, jj = _tile_pairs(work, n_pad, b, mask)
    return tiles, g, d, ii, jj, n_pad, b


@dataclasses.dataclass
class SymmetricBlockedInt8:
    """Packed lower triangle of the off-diagonal part in one int8 plane,
    the exact diagonal, and the equilibration vector."""

    q: Tensor            # (n_pairs, b, b) int8, round(127 B) tiles
    gq: Tensor           # (n_pad,) float32, g/sqrt(127)
    ii: Tensor           # (n_pairs,) int32 block row
    jj: Tensor           # (n_pairs,) int32 block col (jj <= ii)
    shape: Tuple[int, int]
    b: int
    diagonal: Optional[Tensor] = None   # (n_pad,) float32 exact diagonal

    # the tensors a matvec takes as its operand (``symm.packed_matvec``)
    OPERAND = ("q", "gq", "diagonal", "ii", "jj")

    @property
    def n_pairs(self) -> int:
        return self.q.shape[0]

    def kernel(self, x: Tensor) -> Tensor:
        """K4 on this storage (``symm_matmat_int8_kernel``)."""
        return symm_matmat_int8_kernel(x, self)

    def plain(self, x: Tensor) -> Tensor:
        """K4's plain version (``symm_matmat_int8``)."""
        return symm_matmat_int8(x, self)

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512, tol: Optional[float] = None,
                   device=None) -> "SymmetricBlockedInt8":
        """symm_int8.py:175-195. With ``tol`` set, tiles whose largest
        off-diagonal magnitude is <= tol are dropped. ``device=None`` is the
        CUDA device (raises without it)."""
        device = _config.resolve_device(device)
        tiles, g, d, ii, jj, n_pad, b = _equilibrated_tiles(
            matrix, b, tol, 1, "SymmetricBlockedInt8")
        q = np.clip(np.rint(127.0 * tiles), -127, 127).astype(np.int8)
        return cls(
            q=torch.as_tensor(q, device=device),
            gq=torch.as_tensor((g / _SQRT127).astype(np.float32), device=device),
            ii=torch.as_tensor(ii, device=device),
            jj=torch.as_tensor(jj, device=device),
            shape=(n_pad, n_pad),
            b=b,
            diagonal=torch.as_tensor(d, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass
class SymmetricBlockedInt8Split:
    """Two int8 planes, E ~= gq gq^T ⊙ unpack(Q1 + Q2/254), plus the exact
    diagonal."""

    q1: Tensor           # (n_pairs, b, b) int8, round(127 B)
    q2: Tensor           # (n_pairs, b, b) int8, round(254 (127 B - Q1))
    gq: Tensor           # (n_pad,) float32
    ii: Tensor
    jj: Tensor
    shape: Tuple[int, int]
    b: int
    diagonal: Optional[Tensor] = None   # (n_pad,) float32 exact diagonal

    OPERAND = ("q1", "q2", "gq", "diagonal", "ii", "jj")

    @property
    def n_pairs(self) -> int:
        return self.q1.shape[0]

    def kernel(self, x: Tensor) -> Tensor:
        """K5 on this storage (``symm_matmat_int8_split_kernel``)."""
        return symm_matmat_int8_split_kernel(x, self)

    def plain(self, x: Tensor) -> Tensor:
        """K5's plain version (``symm_matmat_int8_split``)."""
        return symm_matmat_int8_split(x, self)

    @classmethod
    def from_dense(cls, matrix: np.ndarray, b: int = 512, tol: Optional[float] = None,
                   device=None) -> "SymmetricBlockedInt8Split":
        """symm_int8.py:217-241; the split kernel's lo accumulator takes two
        products per tile, so half the one-plane headroom. ``device=None``
        is the CUDA device (raises without it)."""
        device = _config.resolve_device(device)
        tiles, g, d, ii, jj, n_pad, b = _equilibrated_tiles(
            matrix, b, tol, 2, "SymmetricBlockedInt8Split")
        b127 = 127.0 * tiles
        q1 = np.clip(np.rint(b127), -127, 127)
        q2 = np.clip(np.rint(254.0 * (b127 - q1)), -127, 127).astype(np.int8)
        return cls(
            q1=torch.as_tensor(q1.astype(np.int8), device=device),
            q2=torch.as_tensor(q2, device=device),
            gq=torch.as_tensor((g / _SQRT127).astype(np.float32), device=device),
            ii=torch.as_tensor(ii, device=device),
            jj=torch.as_tensor(jj, device=device),
            shape=(n_pad, n_pad),
            b=b,
            diagonal=torch.as_tensor(d, dtype=torch.float32, device=device),
        )


def _diag_or_zeros(sym) -> Tensor:
    """The diagonal, or float32 zeros where the operand has none."""
    if sym.diagonal is not None:
        return sym.diagonal
    return torch.zeros(sym.shape[0], dtype=torch.float32, device=sym.gq.device)


def quantize_rows(xs: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-row int8 quantization xs ~= sx * qx (symm_int8.py:252-261), in
    the JAX package's order of float32 operations. Returns (qx int8 (m, n),
    sx float32 (m, 1)); a zero row gives zeros with sx = 1/127."""
    xs = xs.to(torch.float32)
    amax = torch.amax(torch.abs(xs), dim=1, keepdim=True)
    sx = torch.where(amax > 0.0, amax, 1.0) / 127.0
    qx = torch.clamp(torch.round(xs / sx), -127, 127).to(torch.int8)
    return qx, sx


def quantize_rows_split(xs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Double-int8 row split xs ~= sx*(p1 + p2/254) (symm_int8.py:264-272)."""
    xs = xs.to(torch.float32)
    amax = torch.amax(torch.abs(xs), dim=1, keepdim=True)
    sx = torch.where(amax > 0.0, amax, 1.0) / 127.0
    scaled = xs / sx
    p1 = torch.clamp(torch.round(scaled), -127, 127)
    p2 = torch.clamp(torch.round(254.0 * (scaled - p1)), -127, 127).to(torch.int8)
    return p1.to(torch.int8), p2, sx


def _symm_matmat_int8_plain(qx: Tensor, q: Tensor, ii: Tensor, jj: Tensor,
                            b: int, nb: int, pairs_per_pass: Optional[int] = None) -> Tensor:
    """The int32 accumulator of the packed action (symm_int8.py:280-292):
    acc_i += qx_j Q^T for every pair, acc_j += qx_i Q for strict-lower
    pairs. PyTorch has no int32 batched product on CUDA, so the contraction
    runs in float64: every product and partial sum is an integer below
    2^31 < 2^53 (``_check_acc_headroom``), so it is exact in any order, and
    the cast back to int32 is exact too. ``pairs_per_pass`` takes the pairs
    that many at a time, which bounds the float64 copies of the tiles (a
    pass's int32 sums are exact too, so the result is the same)."""
    if pairs_per_pass is not None and q.shape[0] > pairs_per_pass:
        acc = None
        for start in range(0, q.shape[0], pairs_per_pass):
            sl = slice(start, start + pairs_per_pass)
            part = _symm_matmat_int8_plain(qx, q[sl], ii[sl], jj[sl], b, nb)
            acc = part if acc is None else acc.add_(part)
        return acc
    m = qx.shape[0]
    f64 = torch.float64
    ii, jj = ii.long(), jj.long()
    xt = qx.reshape(m, nb, b).transpose(0, 1).to(f64)          # (nb, m, b)
    qt = q.to(f64)
    acc = torch.zeros((nb, m, b), dtype=f64, device=qx.device)
    acc.index_add_(0, ii, torch.einsum("kmn,kin->kmi", xt[jj], qt))
    strict = (ii != jj).to(f64)
    contrib_j = torch.einsum("kmn,kni->kmi", xt[ii], qt)
    acc.index_add_(0, jj, contrib_j * strict[:, None, None])
    return acc.transpose(0, 1).reshape(m, nb * b).to(torch.int32)


def int8_m_tiles(m: int) -> int:
    """M tiles of 16 rows of x that one K4 block takes: 1 for m <= 16, 2
    for m <= 32, else 4 (m > 64 then takes passes of 64 rows)."""
    return 1 if m <= M_TILE else 2 if m <= 2 * M_TILE else 4


def int8_square_items(n_pairs: int, b: int):
    """K4's work items in block-index order: (t, r0, c0) of each
    ``SQUARE_INT8`` square of each tile, derived as the kernel derives them
    from ``blockIdx.x``."""
    nsq = -(-b // SQUARE_INT8)
    for bid in range(n_pairs * nsq * nsq):
        t, s = divmod(bid, nsq * nsq)
        yield t, (s // nsq) * SQUARE_INT8, (s % nsq) * SQUARE_INT8


def int8_walk(m: int, b: int, n_pairs: int, sms: int, aligned: bool = True,
              planes: int = 1) -> str:
    """The walk K4 takes for a call. Both TMA walks need 16-byte copies
    (``aligned``: b a multiple of 16, the int8 operands 16-byte aligned;
    TMA's strides need it) and b <= 1024: ``"band"`` at one M tile (m <=
    16), where the bands fill the card's ``sms`` SMs at least
    ``BAND_MIN_PER_SM`` deep; ``"strip"`` at four M tiles and m <= 64,
    where the strips fill them at least ``STRIP_MIN_PER_SM`` deep;
    ``"square"`` otherwise (two M tiles, more than 64 rows of x), and
    always for K5 (``planes=2``)."""
    if planes != 1 or not aligned or b % 16:
        return "square"
    tiles = int8_m_tiles(m)
    if (tiles == 1 and b <= BAND_MAX_B
            and n_pairs * -(-b // BAND_INT8) >= BAND_MIN_PER_SM * sms):
        return "band"
    if (tiles == 4 and m <= 4 * M_TILE and b <= STRIP_MAX_B
            and n_pairs * -(-b // STRIP_INT8) >= STRIP_MIN_PER_SM * sms):
        return "strip"
    return "square"


def int8_band_items(n_pairs: int, b: int):
    """The band walk's work items in block-index order: (t, r0) of each
    band of ``BAND_INT8`` rows of each tile, derived as the kernel derives
    them from ``blockIdx.x``."""
    per_tile = -(-b // BAND_INT8)
    for band in range(n_pairs * per_tile):
        t, r = divmod(band, per_tile)
        yield t, r * BAND_INT8


def int8_strip_items(n_pairs: int, b: int):
    """The strip walk's work items in block-index order: (t, c0) of each
    strip of ``STRIP_INT8`` columns of each tile, derived as the kernel
    derives them from ``blockIdx.x``."""
    per_tile = -(-b // STRIP_INT8)
    for strip in range(n_pairs * per_tile):
        t, c = divmod(strip, per_tile)
        yield t, c * STRIP_INT8


def _int8_strip_walk(qx: Tensor, q: Tensor, ii: list, jj: list, b: int) -> Tensor:
    """The strip walk of ``int8_square_walk``: per strip, stage by stage
    of ``STRIP_STAGE_ROWS`` rows, y_i of the stage's rows over the strip's
    columns, flushed after its stage, and y_j of the strip's columns over
    the stage's rows, in int32, flushed once per strip."""
    xs, tiles = qx.to(torch.int64), q.to(torch.int64)
    acc = torch.zeros(qx.shape, dtype=torch.int32, device=qx.device)
    for t, c0 in int8_strip_items(len(ii), b):
        diag = ii[t] == jj[t]
        c1 = min(c0 + STRIP_INT8, b)
        yj = torch.zeros((qx.shape[0], c1 - c0), dtype=torch.int32, device=qx.device)
        xj = xs[:, jj[t] * b + c0:jj[t] * b + c1]
        for s in range(0, b, STRIP_STAGE_ROWS):
            e = min(s + STRIP_STAGE_ROWS, b)
            rows = tiles[t, s:e, c0:c1]
            acc[:, ii[t] * b + s:ii[t] * b + e] += (xj @ rows.T).to(torch.int32)
            if not diag:
                yj += (xs[:, ii[t] * b + s:ii[t] * b + e] @ rows).to(torch.int32)
        if not diag:
            acc[:, jj[t] * b + c0:jj[t] * b + c1] += yj
    return acc


def _int8_band_walk(qx: Tensor, q: Tensor, ii: list, jj: list, b: int) -> Tensor:
    """The band walk of ``int8_square_walk``: per band, stage by stage of
    ``BAND_STAGE_ROWS`` rows, y_i of the stage's rows over all b columns
    and y_j of all b columns over the stage's rows, in int32; each
    flushed into the accumulator once per band."""
    m = qx.shape[0]
    xs, tiles = qx.to(torch.int64), q.to(torch.int64)
    acc = torch.zeros(qx.shape, dtype=torch.int32, device=qx.device)
    for t, r0 in int8_band_items(len(ii), b):
        diag = ii[t] == jj[t]
        r1 = min(r0 + BAND_INT8, b)
        yi = torch.zeros((m, r1 - r0), dtype=torch.int32, device=qx.device)
        yj = torch.zeros((m, b), dtype=torch.int32, device=qx.device)
        xj = xs[:, jj[t] * b:(jj[t] + 1) * b]
        for s in range(r0, r1, BAND_STAGE_ROWS):
            rows = tiles[t, s:min(s + BAND_STAGE_ROWS, r1)]
            yi[:, s - r0:s - r0 + rows.shape[0]] += (xj @ rows.T).to(torch.int32)
            if not diag:
                yj += (xs[:, ii[t] * b + s:ii[t] * b + s + rows.shape[0]] @ rows).to(torch.int32)
        if not diag:
            acc[:, jj[t] * b:(jj[t] + 1) * b] += yj
        acc[:, ii[t] * b + r0:ii[t] * b + r1] += yi
    return acc


def int8_square_walk(qx: Tensor, q: Tensor, ii: Tensor, jj: Tensor, b: int,
                     p2: Optional[Tensor] = None, q2: Optional[Tensor] = None,
                     walk: str = "square"):
    """Plain emulation of the K4 and K5 walks, for the CPU tests. The
    square walk (K4's for more than 16 rows of x, and K5's): for each
    pass of rows of x (``16 * int8_m_tiles(m)``, or ``INT8_SPLIT_ROWS`` on
    two planes) and each work item, the chunks column by column as the
    kernel streams them, both contributions y_i += x_j Qᵀ and (off the
    diagonal) y_j += x_i Q summed in int32; y_i added into the accumulator
    once per item, y_j once per chunk column, as the kernel flushes.
    ``walk="band"`` (one plane, m <= 16): K4's band walk instead
    (``_int8_band_walk``); ``walk="strip"`` (one plane, m <= 64): its
    strip walk (``_int8_strip_walk``).

    One plane (``qx``, ``q``): returns the accumulator. Two planes (``qx``
    = p1, ``q`` = Q1, and ``p2``, ``q2`` = Q2): returns (hi, lo), hi = p1 Q1
    and lo = p1 Q2 + p2 Q1, each product pair taken chunk by chunk."""
    m, n = qx.shape
    split = p2 is not None
    if walk == "band":
        if split or int8_m_tiles(m) != 1:
            raise ValueError("the band walk takes one plane and at most 16 rows of x")
        return _int8_band_walk(qx, q, ii.tolist(), jj.tolist(), b)
    if walk == "strip":
        if split or m > 4 * M_TILE:
            raise ValueError("the strip walk takes one plane and at most 64 rows of x")
        return _int8_strip_walk(qx, q, ii.tolist(), jj.tolist(), b)
    rows_per_pass = INT8_SPLIT_ROWS if split else M_TILE * int8_m_tiles(m)
    # (x plane, tile plane, sum) of each product
    products = ((0, 0, 0), (0, 1, 1), (1, 0, 1)) if split else ((0, 0, 0),)
    xs_all = [a.to(torch.int64) for a in ((qx, p2) if split else (qx,))]
    tiles = [a.to(torch.int64) for a in ((q, q2) if split else (q,))]
    accs = [torch.zeros((m, n), dtype=torch.int32, device=qx.device)
            for _ in range(2 if split else 1)]
    ii, jj = ii.tolist(), jj.tolist()
    for mbase in range(0, m, rows_per_pass):
        xs = [a[mbase:mbase + rows_per_pass] for a in xs_all]
        rows = xs[0].shape[0]
        for t, r0, c0 in int8_square_items(len(ii), b):
            diag = ii[t] == jj[t]
            r1, c1 = min(r0 + SQUARE_INT8, b), min(c0 + SQUARE_INT8, b)
            yi = [torch.zeros((rows, r1 - r0), dtype=torch.int32, device=qx.device)
                  for _ in accs]
            for c in range(c0, c1, CHUNK_INT8):
                width = min(CHUNK_INT8, c1 - c)
                yj = [torch.zeros((rows, width), dtype=torch.int32, device=qx.device)
                      for _ in accs]
                for a in range(r0, r1, CHUNK_INT8):
                    for xp, qp, k in products:
                        chunk = tiles[qp][t, a:a + CHUNK_INT8, c:c + width]
                        xj = xs[xp][:, jj[t] * b + c:jj[t] * b + c + width]
                        yi[k][:, a - r0:a - r0 + chunk.shape[0]] += (xj @ chunk.T).to(torch.int32)
                        if not diag:
                            xi = xs[xp][:, ii[t] * b + a:ii[t] * b + a + chunk.shape[0]]
                            yj[k] += (xi @ chunk).to(torch.int32)
                if not diag:
                    for acc, y in zip(accs, yj):
                        acc[mbase:mbase + rows, jj[t] * b + c:jj[t] * b + c + width] += y
            for acc, y in zip(accs, yi):
                acc[mbase:mbase + rows, ii[t] * b + r0:ii[t] * b + r1] += y
    return tuple(accs) if split else accs[0]


def int8_flush_atomics(ii, jj, b: int, m: int, planes: int = 1,
                       walk: str = "square") -> Tuple[int, int]:
    """(int32 sums, reds) that one K4 (``planes=1``) or K5 (``planes=2``:
    hi and lo) call flushes into its accumulators: each work item flushes
    once, one sum per accumulator, row of x and row of its square or band
    (y_i) and, off the diagonal, per row of x and column of its square or,
    for a band (``walk="band"``), of the whole tile (y_j). A strip
    (``walk="strip"``) flushes every row of the tile once (y_i, stage by
    stage) and, off the diagonal, its own columns once (y_j). The square
    walk sends two neighbouring sums as one 64-bit red where b is even,
    else each as a 32-bit one; the band and strip walks send each as a
    32-bit red, 32 neighbouring sums of one row a warp-wide red."""
    diag = np.asarray(ii) == np.asarray(jj)
    if walk == "band":
        rows = b                                   # y_i: every row once over the bands
        cols = b * -(-b // BAND_INT8)              # y_j: the tile's width once a band
    elif walk == "strip":
        rows = b * -(-b // STRIP_INT8)             # y_i: every row once a strip
        cols = b                                   # y_j: every column once over the strips
    else:
        edges = [min(SQUARE_INT8, b - s) for s in range(0, b, SQUARE_INT8)]
        rows = cols = sum(edges) * len(edges)      # over squares, their rows (or columns)
    sums = int(planes * m * (rows * diag.size + cols * np.sum(~diag)))
    return sums, sums // 2 if b % 2 == 0 and walk == "square" else sums


def symm_matmat_int8(x: Tensor, sym: SymmetricBlockedInt8,
                     pairs_per_pass: Optional[int] = None) -> Tensor:
    """Plain PyTorch version of K4 (symm_int8.py:295-302): float32 whatever
    the dtype of x, cast back to it. ``pairs_per_pass``: see
    ``_symm_matmat_int8_plain`` (the same bits, less memory)."""
    nb = sym.shape[0] // sym.b
    xf = x.to(torch.float32)
    qx, sx = quantize_rows(xf * sym.gq[None, :])
    acc = _symm_matmat_int8_plain(qx, sym.q, sym.ii, sym.jj, sym.b, nb, pairs_per_pass)
    y = acc.to(torch.float32) * sx * sym.gq[None, :] + xf * _diag_or_zeros(sym)[None, :]
    return y.to(x.dtype)


def symm_matmat_int8_split(x: Tensor, sym: SymmetricBlockedInt8Split) -> Tensor:
    """Plain PyTorch version of K5 (symm_int8.py:305-317): three int32
    contractions p1 Q1 + (p1 Q2 + p2 Q1)/254, dropping the p2 Q2 term."""
    nb = sym.shape[0] // sym.b
    xf = x.to(torch.float32)
    p1, p2, sx = quantize_rows_split(xf * sym.gq[None, :])
    a1 = _symm_matmat_int8_plain(p1, sym.q1, sym.ii, sym.jj, sym.b, nb)
    a2 = _symm_matmat_int8_plain(p1, sym.q2, sym.ii, sym.jj, sym.b, nb)
    a2 = a2 + _symm_matmat_int8_plain(p2, sym.q1, sym.ii, sym.jj, sym.b, nb)
    acc = a1.to(torch.float32) + a2.to(torch.float32) * (1.0 / 254.0)
    y = acc * sx * sym.gq[None, :] + xf * _diag_or_zeros(sym)[None, :]
    return y.to(x.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _int8_lib():
    lib = _build.load("symm_int8")
    lib.symm_int8.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    lib.symm_int8_split.argtypes = [_P] * 13 + [_I] * 4 + [_P]
    lib.symm_int8.restype = _I
    lib.symm_int8_split.restype = _I
    edges = (lib.symm_int8_square_edge(), lib.symm_int8_band_rows(), lib.symm_int8_strip_cols())
    if edges != (SQUARE_INT8, BAND_INT8, STRIP_INT8):
        raise RuntimeError(f"symm_int8.cu walks squares, bands and strips of {edges}, "
                           f"symm_int8.py {(SQUARE_INT8, BAND_INT8, STRIP_INT8)}")
    return lib


def _check_scales(x: Tensor, sym) -> Tuple[Tensor, Tensor]:
    """gq and the diagonal as the kernels take them: float32, contiguous,
    one entry per column, on x's device."""
    n = x.shape[1]
    out = []
    for name, a in (("gq", sym.gq), ("diagonal", _diag_or_zeros(sym))):
        if a.dtype != torch.float32 or a.shape != (n,) or a.device != x.device:
            raise ValueError(f"{name} must be float32 of shape ({n},) on {x.device}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        out.append(a.contiguous())
    return out[0], out[1]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the ``walk`` argument of symm_int8.cu's ``symm_int8``
_WALK_CODES = {"square": 0, "band": 1, "strip": 2}


def _record_walk(walk: str) -> None:
    """Count one K4 call of ``walk`` in ``K4_WALKS``."""
    K4_WALKS[walk] += 1


def symm_matmat_int8_kernel(x: Tensor, sym: SymmetricBlockedInt8) -> Tensor:
    """K4: the one-plane int8 action, each packed tile read once for up to
    64 rows of x (replaces ``symm_matmat_int8_pallas``), in the walk
    ``int8_walk`` picks. A CUDA tensor launches ``symm_int8`` and returns
    float32; a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return symm_matmat_int8(x, sym)
    x = x.contiguous()
    _check_operands(x, (sym.q,), sym.ii, sym.jj, sym.shape, sym.b, (torch.int8,))
    gq, dg = _check_scales(x, sym)
    m, n = x.shape
    qx, sx = quantize_rows(x * gq[None, :])
    acc = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    aligned = sym.q.data_ptr() % 16 == 0 and qx.data_ptr() % 16 == 0
    walk = int8_walk(m, sym.b, sym.n_pairs, _sm_count(x.device.index), aligned)
    lib = _int8_lib()
    err = lib.symm_int8(qx.data_ptr(), sym.q.data_ptr(), sym.ii.data_ptr(), sym.jj.data_ptr(),
                        x.data_ptr(), sx.data_ptr(), gq.data_ptr(), dg.data_ptr(),
                        acc.data_ptr(), y.data_ptr(), m, n, sym.b, sym.n_pairs,
                        _WALK_CODES[walk], _build.stream_handle(x.device))
    _build.check(lib, err, "symm_int8")
    LAUNCHES["symm_int8"] += 1
    _record_walk(walk)
    return y


def symm_matmat_int8_split_kernel(x: Tensor, sym: SymmetricBlockedInt8Split) -> Tensor:
    """K5: the two-plane int8 action on the int8 tensor cores, each packed
    tile of both planes read once per 16 rows of x (replaces
    ``symm_matmat_int8_split_pallas``). A CUDA tensor launches
    ``symm_int8_split`` and returns float32; a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return symm_matmat_int8_split(x, sym)
    x = x.contiguous()
    _check_operands(x, (sym.q1, sym.q2), sym.ii, sym.jj, sym.shape, sym.b, (torch.int8,))
    gq, dg = _check_scales(x, sym)
    m, n = x.shape
    p1, p2, sx = quantize_rows_split(x * gq[None, :])
    acc1 = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    acc2 = torch.zeros_like(acc1)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _int8_lib()
    err = lib.symm_int8_split(
        p1.data_ptr(), p2.data_ptr(), sym.q1.data_ptr(), sym.q2.data_ptr(),
        sym.ii.data_ptr(), sym.jj.data_ptr(), x.data_ptr(), sx.data_ptr(), gq.data_ptr(),
        dg.data_ptr(), acc1.data_ptr(), acc2.data_ptr(), y.data_ptr(),
        m, n, sym.b, sym.n_pairs, _build.stream_handle(x.device))
    _build.check(lib, err, "symm_int8_split")
    LAUNCHES["symm_int8_split"] += 1
    return y


def int8_matvec(sym):
    """``(matvec, operand)`` for a built int8 operator (``symm.packed_matvec``):
    ``matvec(x, operand)`` calls the kernel wrapper of ``sym``'s tier, which
    launches K4/K5 for CUDA tensors and runs the plain version for CPU
    tensors. Every tensor (planes, scales, diagonal, topology) is an
    operand, in the JAX package's order, never a baked constant."""
    return packed_matvec(sym)


def make_int8_matvec(matrix, b: int = 512, two_plane: bool = False,
                     tol: Optional[float] = None, device=None):
    """One call that makes a quantized tier (symm_int8.py:507-541): packs
    ``matrix`` and returns ``(matvec, operand, sym)`` (see ``int8_matvec``).
    ``device=None`` is the CUDA device (raises without it)."""
    cls = SymmetricBlockedInt8Split if two_plane else SymmetricBlockedInt8
    sym = cls.from_dense(matrix, b=b, tol=tol, device=device)
    matvec, operand = int8_matvec(sym)
    return matvec, operand, sym
