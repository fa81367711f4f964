"""Quantized DENSE operator tiers for the non-symmetric families (port of
iterative_solver_tpu/ops/kernels/dense_int8.py).

A non-symmetric operator has no triangle to pack, so the packed int8
kernels (K4, K5) do not apply; the two tricks that make int8 work carry
over directly:

1. **Exact diagonal split**: diag(A) stays in f32 and only the couplings
   E = A - diag(A) are quantized.
2. **Two-sided equilibration**: ``gr[i] = sqrt(rowmax|E[i,:]|)``,
   ``gc[j] = sqrt(colmax|E[:,j]|)``, so B = E / (gr gcᵀ) lies in [-1, 1],
   one activation scale per row of x works, and the int8 product
   accumulates into an EXACT int32 (headroom guarded).

Action (row-block form, y = x Aᵀ):

    u  = x * gc                                  column pre-scale
    qx = round(127 u / sx)                       per-row activation scale
    acc[m, i] = sum_j qx[m, j] q[i, j]           one int8 product, int32
    y = acc * sx/127 * gr  +  x * d              dequantize + exact diagonal

The JAX package has no Pallas kernel here: its int8 ``dot_general``
(``_int8_dot``) goes to XLA. Its counterpart is ``torch._int_mm`` (cuBLASLt
int8 on the card), with x's rows padded to the 32 the card's ``_int_mm``
needs (more than 16, a multiple of 8) and sliced off again; n must be a
multiple of 8 on the card. The int32 accumulator is exact in any order, so
the result does not depend on the library's order of sums. The host
packing is numpy and byte-identical to the JAX package's. Under
``torch.func.vmap`` (the batched non-hermitian solves) ``_int_mm`` has no
batching rule and runs once per batch element.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import config
from .symm_int8 import _check_acc_headroom, quantize_rows, quantize_rows_split

Tensor = torch.Tensor

_SHARD = "sharding is not ported yet (ROADMAP.md Queue 1, item 6c)"
# rows of x the card's torch._int_mm takes at least (more than 16, a
# multiple of 8)
INT_MM_ROWS = 32


def _equilibrated(matrix) -> tuple:
    """(work, gr, gc, d): the couplings E / (gr gcᵀ) * 127 in a float64
    working copy, scaled in place one axis at a time (the (n, n) outer
    product would be another full-matrix allocation)."""
    work = np.array(matrix, dtype=np.float64, copy=True)
    n = work.shape[0]
    if work.shape != (n, n):
        raise ValueError("operator must be square")
    d = np.diagonal(work).copy()
    np.fill_diagonal(work, 0.0)
    rmax = np.abs(work).max(axis=1)
    cmax = np.abs(work).max(axis=0)
    gr = np.sqrt(np.where(rmax > 0.0, rmax, 1.0))
    gc = np.sqrt(np.where(cmax > 0.0, cmax, 1.0))
    work /= gr[:, None]
    work /= gc[None, :]
    work *= 127.0
    return work, gr, gc, d


def _f32(a: np.ndarray, device) -> Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


@dataclass
class DenseInt8:
    """One-plane quantized dense operator: A ~= gr (q/127) gcᵀ + diag(d)."""

    q: Tensor      # (n, n) int8: scaled off-diagonal couplings
    gr: Tensor     # (n,) f32 row equilibration
    gc: Tensor     # (n,) f32 column equilibration
    d: Tensor      # (n,) f32 exact diagonal
    n: int

    @classmethod
    def from_dense(cls, matrix, device=None) -> "DenseInt8":
        """``device=None`` means the CUDA card."""
        device = config.resolve_device(device)
        n = np.shape(matrix)[0]
        if np.shape(matrix) != (n, n):
            raise ValueError("operator must be square")
        _check_acc_headroom(n, n, 1, "DenseInt8")
        work, gr, gc, d = _equilibrated(matrix)
        np.round(work, out=work)
        q = np.clip(work, -127, 127).astype(np.int8)
        return cls(q=torch.as_tensor(q, device=device), gr=_f32(gr, device),
                   gc=_f32(gc, device), d=_f32(d, device), n=n)

    def tree(self):
        return (self.q, self.gr, self.gc, self.d)

    def shard(self, mesh, axis: str = "data"):
        raise NotImplementedError(_SHARD)


@dataclass
class DenseInt8Split:
    """Two-plane tier: E/(gr gcᵀ) ~= (q1 + q2/254)/127, the split-bf16
    accuracy class at half its bytes."""

    q1: Tensor
    q2: Tensor
    gr: Tensor
    gc: Tensor
    d: Tensor
    n: int

    @classmethod
    def from_dense(cls, matrix, device=None) -> "DenseInt8Split":
        """``device=None`` means the CUDA card."""
        device = config.resolve_device(device)
        n = np.shape(matrix)[0]
        if np.shape(matrix) != (n, n):
            raise ValueError("operator must be square")
        # the lo accumulator receives TWO products (p1 q2 + p2 q1)
        _check_acc_headroom(n, n, 2, "DenseInt8Split")
        work, gr, gc, d = _equilibrated(matrix)
        q1 = np.clip(np.round(work), -127, 127)
        work -= q1
        work *= 254.0
        q2 = np.clip(np.round(work, out=work), -127, 127)
        return cls(q1=torch.as_tensor(q1.astype(np.int8), device=device),
                   q2=torch.as_tensor(q2.astype(np.int8), device=device),
                   gr=_f32(gr, device), gc=_f32(gc, device), d=_f32(d, device), n=n)

    def tree(self):
        return (self.q1, self.q2, self.gr, self.gc, self.d)

    def shard(self, mesh, axis: str = "data"):
        raise NotImplementedError(_SHARD)


def _int8_dot(a: Tensor, b: Tensor) -> Tensor:
    """(m, n) int8 x (k, n) int8 -> (m, k) int32, exact (contract on n):
    ``torch._int_mm`` on a copy of ``a`` padded with zero rows to at least
    INT_MM_ROWS (a multiple of 8), the padding sliced off."""
    m, n = a.shape
    if a.dtype != torch.int8 or b.dtype != torch.int8 or b.shape[1] != n:
        raise ValueError(f"_int8_dot takes (m, n) and (k, n) int8, got {tuple(a.shape)} "
                         f"{a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.is_cuda and (n % 8 or b.shape[0] % 8):
        raise ValueError(f"torch._int_mm on the card needs n and k multiples of 8, got "
                         f"n={n}, k={b.shape[0]}")
    rows = max(INT_MM_ROWS, -(-m // 8) * 8)
    if rows != m:
        a = torch.cat([a, torch.zeros((rows - m, n), dtype=a.dtype, device=a.device)])
    return torch._int_mm(a, b.T)[:m]


def dense_int8_matvec(x: Tensor, op) -> Tensor:
    """y = x Aᵀ through the one-plane quantized operator; ``op`` is the
    ``(q, gr, gc, d)`` tree (``DenseInt8.tree()``). The arithmetic is f32
    whatever x's dtype; y comes back in x's dtype."""
    q, gr, gc, d = op
    xf = x.to(torch.float32)
    qx, sx = quantize_rows(xf * gc[None, :])
    acc = _int8_dot(qx, q)
    y = acc.to(torch.float32) * (sx / 127.0) * gr[None, :]
    y = y + xf * d[None, :]
    return y.to(x.dtype)


def dense_int8_matvec_split(x: Tensor, op) -> Tensor:
    """Two-plane action: operator (q1 + q2/254)/127, activations
    sx (p1 + p2/254); hi = p1 q1, lo = p1 q2 + p2 q1 (p2 q2 / 254² ~ 2^-16
    is dropped, below the tier's floor)."""
    q1, q2, gr, gc, d = op
    xf = x.to(torch.float32)
    p1, p2, sx = quantize_rows_split(xf * gc[None, :])
    hi = _int8_dot(p1, q1)
    lo = _int8_dot(p1, q2) + _int8_dot(p2, q1)
    y = hi.to(torch.float32) + lo.to(torch.float32) / 254.0
    y = y * (sx / 127.0) * gr[None, :]
    y = y + xf * d[None, :]
    return y.to(x.dtype)
