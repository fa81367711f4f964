"""Masked symmetrised Gram matrix (port of
iterative_solver_tpu/ops/kernels/gram_pallas.py).

    H[i, j] = ½ (h + hᵀ),   h[i, j] = mask_i mask_j Σₙ V[i, n] W[j, n]

for two (M, N) stacks, the subspace Rayleigh matrix of a Davidson step.

- ``masked_gram`` is the plain PyTorch version: one product, the mask and
  the symmetrisation.
- ``masked_gram_kernel`` is K7, CUDA C++ for sm_90a (``csrc/gram.cu``),
  replacing ``masked_gram_pallas`` / ``_masked_gram_fn``. A CUDA tensor
  launches it (or the wrapper raises) and counts the launch in
  ``LAUNCHES``; a CPU tensor takes the plain version.

Both keep the Pallas wrapper's ``tile`` argument and its check (the tile
grid must divide N, gram_pallas.py:29-31, :72-77), so the calls the JAX
package accepts succeed and those it refuses fail. The tile is a check
only: on the card the kernel cuts N into column chunks of its own
(``chunk_plan``).

No solver calls it: the JAX package does not wire it into its own
``_masked_eigh``, and neither does the port (``fused_davidson.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ... import config as _config  # noqa: F401  (precision pins)
from . import _build

Tensor = torch.Tensor

# launches of K7, counted by the wrapper
LAUNCHES = {"gram": 0}

MAX_ROWS = 64
# columns of one step of the kernel's stream; a chunk is a whole number of steps
STEP = 32
# column chunks aimed at per launch: two CTAs for each of the H100's 132 SMs
# (fewer where the card holds fewer at once)
TARGET_CHUNKS = 264


def tile_grid(n: int, tile: int) -> Tuple[int, int]:
    """``(tile_n, n_tiles)`` of the Pallas wrapper: the tile is cut to N,
    and the tile count must divide N (gram_pallas.py:29-31, :76)."""
    tile = min(tile, n)
    n_tiles = max(1, n // tile)
    if n % n_tiles:
        raise ValueError(f"vector length {n} must divide the tile grid "
                         f"({n_tiles} tiles of {tile})")
    return n // n_tiles, n_tiles


def block_pairs(m: int) -> int:
    """The 4 x 4 block pairs (I <= J) of an (m, m) Gram matrix: K7 gives
    each to one CTA for the final sum."""
    nb = -(-m // 4)
    return nb * (nb + 1) // 2


@functools.lru_cache(maxsize=256)
def chunk_plan(n: int, m: int, ctas: int = TARGET_CHUNKS) -> Tuple[int, int]:
    """``(chunk, nchunks)`` of K7 on (m, N) stacks with at most ``ctas``
    CTAs: CTA c sums columns [c*chunk, min(N, (c+1)*chunk)), chunk a whole
    number of STEP columns; there are at least ``block_pairs(m)`` CTAs, and
    chunks past N are empty."""
    steps = -(-n // STEP)
    chunk = STEP * -(-steps // ctas)
    return chunk, max(-(-n // chunk), block_pairs(m))


def masked_gram(v: Tensor, w: Tensor, mask: Tensor, tile: int = 512) -> Tensor:
    """Plain PyTorch version of K7: (v wᵀ) masked on both sides and
    symmetrised, in v's dtype."""
    tile_grid(v.shape[1], tile)
    h = torch.matmul(v, w.T) * mask[:, None] * mask[None, :]
    return 0.5 * (h + h.T)


def _check_operands(v: Tensor, w: Tensor, mask: Tensor) -> None:
    if v.dim() != 2 or w.shape != v.shape:
        raise ValueError(f"v and w must be (M, N) stacks of one shape, got "
                         f"{tuple(v.shape)} and {tuple(w.shape)}")
    m = v.shape[0]
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"the CUDA Gram kernel takes 1 to {MAX_ROWS} rows, got {m}")
    if mask.shape != (m,):
        raise ValueError(f"mask must have shape ({m},), got {tuple(mask.shape)}")
    for name, a in (("v", v), ("w", w), ("mask", mask)):
        if a.dtype != torch.float32:
            raise TypeError(f"the CUDA Gram kernel takes float32 {name}, got {a.dtype}")
        if a.device != v.device:
            raise ValueError(f"{name} is on {a.device}, v on {v.device}")


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _gram_lib():
    lib = _build.load("gram")
    lib.masked_gram_f32.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.masked_gram_f32.restype = _I
    lib.masked_gram_capacity.restype = _I
    return lib


# the partials' scratch of K7 per (device, stream), reused by every call;
# and the CTAs each card holds at once
_scratch: Dict[Tuple[int, int], Tensor] = {}
_capacity: Dict[int, int] = {}


def _ctas(device) -> int:
    ctas = _capacity.get(device.index)
    if ctas is None:
        with torch.cuda.device(device):
            ctas = _gram_lib().masked_gram_capacity()
        if ctas < block_pairs(MAX_ROWS):
            raise RuntimeError(f"the CUDA Gram kernel needs {block_pairs(MAX_ROWS)} CTAs "
                               f"resident at once; this card holds {ctas}")
        ctas = _capacity[device.index] = min(ctas, TARGET_CHUNKS)
    return ctas


def _part(device, stream: int, ctas: int) -> Tensor:
    key = (device.index, stream)
    part = _scratch.get(key)
    if part is None:
        part = _scratch[key] = torch.empty((ctas, 32 * block_pairs(MAX_ROWS)),
                                           dtype=torch.float32, device=device)
    return part


def _rows(a: Tensor) -> Tuple[Tensor, int]:
    """``(a, row stride)``: ``a`` itself where its rows are contiguous and
    apart (a column slice too), else a contiguous copy."""
    m, n = a.shape
    if a.is_contiguous():
        return a, n
    s0, s1 = a.stride()
    if s1 != 1 or (m > 1 and s0 < n):
        return a.contiguous(), n
    return a, (s0 if m > 1 else n)


def masked_gram_kernel(v: Tensor, w: Tensor, mask: Tensor, tile: int = 512) -> Tensor:
    """K7: the masked symmetrised Gram matrix in one launch (partials over
    column chunks; after a grid-wide barrier each 4 x 4 block pair summed
    over the chunks by one CTA, masked and symmetrised), replacing
    ``masked_gram_pallas``. A CUDA tensor launches ``masked_gram_f32``; a
    CPU tensor takes the plain version."""
    if v.device.type == "cpu":
        return masked_gram(v, w, mask, tile)
    _check_operands(v, w, mask)
    m, n = v.shape
    tile_grid(n, tile)
    (v, ldv), (w, ldw), mask = _rows(v), _rows(w), mask.contiguous()
    ctas = _ctas(v.device)
    chunk, nchunks = chunk_plan(n, m, ctas)
    stream = _build.stream_handle(v.device)
    part = _part(v.device, stream.value, ctas)
    h = v.new_empty((m, m))
    lib = _gram_lib()
    err = lib.masked_gram_f32(v.data_ptr(), w.data_ptr(), mask.data_ptr(), part.data_ptr(),
                              h.data_ptr(), m, n, ldv, ldw, chunk, nchunks, stream)
    _build.check(lib, err, "masked_gram_f32")
    LAUNCHES["gram"] += 1
    return h
