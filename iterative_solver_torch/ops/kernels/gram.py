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
package accepts succeed and those it refuses fail. On the card the tile is
the unit of the kernel's column chunks.

No solver calls it: the JAX package does not wire it into its own
``_masked_eigh``, and neither does the port (``fused_davidson.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ... import config as _config  # noqa: F401  (precision pins)
from . import _build

Tensor = torch.Tensor

# launches of K7, counted by the wrapper
LAUNCHES = {"gram": 0}

MAX_ROWS = 64
# column chunks aimed at per launch: two CTAs for each of the H100's 132 SMs
_TARGET_CHUNKS = 264


def tile_grid(n: int, tile: int) -> Tuple[int, int]:
    """``(tile_n, n_tiles)`` of the Pallas wrapper: the tile is cut to N,
    and the tile count must divide N (gram_pallas.py:29-31, :76)."""
    tile = min(tile, n)
    n_tiles = max(1, n // tile)
    if n % n_tiles:
        raise ValueError(f"vector length {n} must divide the tile grid "
                         f"({n_tiles} tiles of {tile})")
    return n // n_tiles, n_tiles


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
    lib.masked_gram_f32.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.masked_gram_f32.restype = _I
    return lib


def masked_gram_kernel(v: Tensor, w: Tensor, mask: Tensor, tile: int = 512) -> Tensor:
    """K7: the masked symmetrised Gram matrix in two launches (partials over
    column chunks, then their sum in chunk order with the mask and the
    symmetrisation), replacing ``masked_gram_pallas``. A CUDA tensor
    launches ``masked_gram_f32``; a CPU tensor takes the plain version."""
    if v.device.type == "cpu":
        return masked_gram(v, w, mask, tile)
    _check_operands(v, w, mask)
    m, n = v.shape
    tile_n, n_tiles = tile_grid(n, tile)
    v, w, mask = v.contiguous(), w.contiguous(), mask.contiguous()
    chunk = tile_n * max(1, n_tiles // _TARGET_CHUNKS)
    nchunks = -(-n // chunk)
    part = torch.empty((nchunks, MAX_ROWS, MAX_ROWS), dtype=torch.float32, device=v.device)
    h = torch.empty((m, m), dtype=torch.float32, device=v.device)
    lib = _gram_lib()
    err = lib.masked_gram_f32(v.data_ptr(), w.data_ptr(), mask.data_ptr(), part.data_ptr(),
                              h.data_ptr(), m, n, chunk, nchunks,
                              _build.stream_handle(v.device))
    _build.check(lib, err, "masked_gram_f32")
    LAUNCHES["gram"] += 1
    return h
