"""Deterministic synthetic FCI-style operators (port of
iterative_solver_tpu/models/synthetic_fci.py).

A dominant diagonal spanning a wide energy range with a gapped low-lying
block (the states an eigensolver hunts), and weak couplings: the character
of a determinant-space Hamiltonian. The host side is numpy with
``np.random.default_rng(seed)``, as in the JAX package, so the same seed
gives byte-identical operators in both packages; tensors are made at the
end, on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.kernels.spmv import BSRMatrix
from ..ops.kernels.symm import _symm_matmat_plain
from ..ops.kernels.symm_int8 import SymmetricBlockedInt8, _check_acc_headroom


def synthetic_fci_dense(n: int, n_low: int = 32, coupling: float = 0.05,
                        seed: int = 0) -> np.ndarray:
    """Dense synthetic FCI matrix (symmetric, f64; synthetic_fci.py:16-33)."""
    rng = np.random.default_rng(seed)
    n_low = min(n_low, n // 2)
    diag = np.concatenate(
        [np.linspace(-2.0, 3.0, n_low), np.linspace(6.0, 50.0, n - n_low)]
    )
    a = rng.standard_normal((n, n)) * (coupling / np.sqrt(n))
    # couplings decay with diagonal separation
    sep = np.abs(diag[:, None] - diag[None, :])
    a = a * np.exp(-0.05 * sep)
    return a + a.T + np.diag(diag)


def synthetic_fci_bsr(n: int, block: int = 128, density: float = 0.15,
                      n_low: int = 32, seed: int = 0, dtype=None, device=None):
    """A block-sparse synthetic FCI operator and its dense f64 equivalent
    (synthetic_fci.py:36-72): diagonal blocks always present, off-diagonal
    blocks kept with probability ``density * exp(-0.3 * distance)``, drawn
    in the JAX package's order so the same seed gives the same matrix.
    Returns ``(BSRMatrix on device, dense)``; ``device=None`` is CUDA."""
    rng = np.random.default_rng(seed)
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    nb = n // block
    n_low = min(n_low, n // 2)
    diag = np.concatenate(
        [np.linspace(-2.0, 3.0, n_low), np.linspace(6.0, 50.0, n - n_low)]
    )
    dense = np.diag(diag)
    for rb in range(nb):
        for cb in range(rb + 1):
            if rb == cb or rng.random() < density * np.exp(-0.3 * (rb - cb)):
                blk = rng.standard_normal((block, block)) * (0.05 / np.sqrt(block))
                rows = slice(rb * block, (rb + 1) * block)
                cols = slice(cb * block, (cb + 1) * block)
                if rb == cb:
                    dense[rows, cols] += 0.5 * (blk + blk.T)
                else:
                    dense[rows, cols] += blk
                    dense[cols, rows] += blk.T
    bsr = BSRMatrix.from_dense(dense, bm=block, bn=block, tol=0.0, dtype=dtype,
                               device=device)
    return bsr, dense


def synthetic_packed_int8(n: int, b: int = 1024, seed: int = 0, diag=None,
                          coupling: float = 0.05, chunk_tiles: int = 32,
                          device=None):
    """A packed one-plane int8 symmetric operator generated directly, with
    no dense f64 intermediate (synthetic_fci.py:75-143).

    The implied operator is A = diag(d) + E with
    E[bi*b+u, bj*b+v] = gq^2 * q_pair(bi,bj)[u, v]: q drawn from a clipped
    discrete gaussian (sd 127/4.5, what ``from_dense`` gives equilibrated
    iid couplings) and gq chosen so that sd(E) = coupling/sqrt(n). Tiles on
    the block diagonal are symmetrised with a zero diagonal, so E is
    exactly symmetric. Returns ``(sym, diag)``: a SymmetricBlockedInt8 on
    ``device`` (``None``: the CUDA device, which raises without it) and the
    float64 diagonal."""
    if n % b:
        raise ValueError("n must be a multiple of b for the direct generator")
    _check_acc_headroom(n, b, 1, "synthetic_packed_int8")
    device = config.resolve_device(device)
    nb = n // b
    iis, jjs = np.tril_indices(nb)
    npairs = iis.size
    rng = np.random.default_rng(seed)
    sd_q = 127.0 / 4.5
    q = np.empty((npairs, b, b), dtype=np.int8)
    for start in range(0, npairs, chunk_tiles):
        stop = min(start + chunk_tiles, npairs)
        blk = rng.standard_normal((stop - start, b, b)).astype(np.float32)
        blk *= sd_q
        np.rint(blk, out=blk)
        np.clip(blk, -127, 127, out=blk)
        q[start:stop] = blk.astype(np.int8)
    for p in np.nonzero(iis == jjs)[0]:
        t = np.tril(q[p], -1)
        q[p] = t + t.T
    gq2 = coupling / (np.sqrt(float(n)) * sd_q)
    gq = np.full(n, np.sqrt(gq2), dtype=np.float32)
    if diag is None:
        diag = np.concatenate(
            [np.linspace(-2.0, 3.0, min(64, n)),
             np.linspace(6.0, 50.0, n - min(64, n))])
    diag = np.asarray(diag, dtype=np.float64)
    sym = SymmetricBlockedInt8(
        q=torch.from_numpy(q).to(device),
        gq=torch.from_numpy(gq).to(device),
        ii=torch.from_numpy(iis.astype(np.int32)).to(device),
        jj=torch.from_numpy(jjs.astype(np.int32)).to(device),
        shape=(n, n),
        b=b,
        diagonal=torch.as_tensor(diag, dtype=torch.float32, device=device),
    )
    return sym, diag


def implied_dense_int8(sym, diag) -> np.ndarray:
    """The dense f64 operator a packed one-plane int8 structure implies,
    A = diag(d) + E, E[bi*b+u, bj*b+v] = gq_i gq_j q_pair(bi,bj)[u, v]
    (synthetic_fci.py:146-167). For small n: it is a dense host matrix."""
    n, b = sym.shape[0], sym.b
    q = sym.q.cpu().numpy().astype(np.float64)
    gq = sym.gq.cpu().numpy().astype(np.float64)
    ii = sym.ii.cpu().numpy()
    jj = sym.jj.cpu().numpy()
    a = np.diag(np.asarray(diag, dtype=np.float64))
    for p in range(q.shape[0]):
        bi, bj = int(ii[p]), int(jj[p])
        blk = (gq[bi * b:(bi + 1) * b, None]
               * gq[None, bj * b:(bj + 1) * b] * q[p])
        if bi == bj:
            a[bi * b:(bi + 1) * b, bi * b:(bi + 1) * b] += blk
        else:
            a[bi * b:(bi + 1) * b, bj * b:(bj + 1) * b] += blk
            a[bj * b:(bj + 1) * b, bi * b:(bi + 1) * b] += blk.T
    return a


def implied_matmat_int8(x: torch.Tensor, sym, diag, chunk_tiles: int = 64) -> torch.Tensor:
    """y = x A for the operator ``implied_dense_int8`` describes, in float64
    on x's device, without the dense matrix: E x = gq ⊙ (Q (gq ⊙ x)) with
    the tiles widened to float64 ``chunk_tiles`` at a time. This is the
    yardstick for residuals at sizes where the dense matrix does not fit."""
    f64 = torch.float64
    x = x.to(f64)
    gq = sym.gq.to(f64)
    xs = x * gq[None, :]
    nb = sym.shape[0] // sym.b
    y = torch.zeros_like(x)
    for start in range(0, sym.n_pairs, chunk_tiles):
        sl = slice(start, start + chunk_tiles)
        y += _symm_matmat_plain(xs, sym.q[sl].to(f64), sym.ii[sl], sym.jj[sl], sym.b, nb)
    d = torch.as_tensor(np.asarray(diag), dtype=f64, device=x.device)
    return y * gq[None, :] + x * d[None, :]
