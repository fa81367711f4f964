"""Device block-vector operations (the ArrayHandler layer) in PyTorch.

Port of iterative_solver_tpu/array/vector_ops.py. The reference routes every
O(N) numeric through ArrayHandler objects (ArrayHandler.h:184-222) backed by
CBLAS+MPI streaming kernels (gemm.h:76-153); here the same contract is a set
of plain functions over ``(m, N)`` row-blocks of tensors:

- ``gram``        <- gemm_inner: block inner-product matrix, one matmul;
- ``reconstruct`` <- gemm_outer: coefficient matrix x basis stack;
- ``axpy_rows`` / ``scale_rows`` / ``dots_rows`` — elementwise sweeps;
- ``select_smallest`` / ``select_max_dot`` <- util/select.h top-n selection.

float32 matmuls run in full float32 (``config`` pins TF32 off), the
counterpart of the JAX package's ``Precision.HIGHEST``.

Sharded row blocks (``parallel/mesh.py``): each rank holds its slice of the
vector axis, so ``gram``, ``gram_sym``, ``dots_rows``, ``norms_rows`` and
``fused_dot`` take ``sharding=`` and all-reduce their contraction over N
(GSPMD's psum in the JAX package), and ``select_max_dot`` merges the ranks'
local top n; ``reconstruct`` needs no communication. ``to_device`` with
``sharding=`` keeps this rank's slice of a global array.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import config as _config  # noqa: F401  (precision pins)
from ..parallel.collectives import all_gather, psum
from ..utils.profiler import count

Tensor = torch.Tensor


def gram(x: Tensor, y: Tensor, sharding=None) -> Tensor:
    """<x_i, y_j> for row blocks: (m, N) x (k, N) -> (m, k)."""
    return psum(torch.matmul(x, y.T), sharding)


def gram_sym(x: Tensor, sharding=None) -> Tensor:
    """<x_i, x_j> overlap of a block with itself: (m, N) -> (m, m)."""
    return psum(torch.matmul(x, x.T), sharding)


def reconstruct(coeff: Tensor, basis: Tensor) -> Tensor:
    """Linear combinations of basis rows: (m, k) x (k, N) -> (m, N)."""
    return torch.matmul(coeff, basis)


def reconstruct_add(out: Tensor, coeff: Tensor, basis: Tensor) -> Tensor:
    """out + coeff @ basis (the gemm_outer accumulate form)."""
    return out + torch.matmul(coeff, basis)


def axpy(alpha, x: Tensor, y: Tensor) -> Tensor:
    """y + alpha * x elementwise (alpha scalar)."""
    return y + alpha * x


def axpy_rows(alphas: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """y[i] + alphas[i] * x[i] for row blocks."""
    return y + alphas[:, None] * x


def scale_rows(alphas: Tensor, x: Tensor) -> Tensor:
    return alphas[:, None] * x


def dots_rows(x: Tensor, y: Tensor, sharding=None) -> Tensor:
    """Row-wise dot products: (m, N), (m, N) -> (m,)."""
    return psum(torch.einsum("in,in->i", x, y), sharding)


def chol_jitter(dtype) -> float:
    """Gram jitter that EXCEEDS the dtype's Gram roundoff, for unit-scale
    rows. A nearly linearly dependent block's Gram reads min-eig ~ -eps by
    rounding (f64 ~ -1e-16, f32 ~ -1e-6) and an under-jittered Cholesky
    fails — and a NaN error vector reads as CONVERGED in every fused solve
    loop's condition (NaN > tol is False)."""
    return 1e-12 if dtype == torch.float64 else 1e-5


def norms_rows(x: Tensor, sharding=None) -> Tensor:
    return torch.sqrt(torch.abs(dots_rows(x, x, sharding)))


def normalize_rows(x: Tensor, thresh: float = 1.0e-14,
                   sharding=None) -> Tuple[Tensor, Tensor]:
    """Normalise each row unless its norm is below ``thresh`` (left untouched).

    Mirrors detail::normalise (IterativeSolverTemplate.h:80-93).
    """
    norms = norms_rows(x, sharding)
    safe = torch.where(norms > thresh, norms, torch.ones_like(norms))
    return x / safe[:, None], norms


def select_smallest(values: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """Indices and values of the n smallest elements (ascending), the
    handler ``select`` with smallest=true (util/select.h)."""
    neg_vals, idx = torch.topk(-values, n)
    return idx, -neg_vals


def select_max_dot(x: Tensor, y: Tensor, n: int, sharding=None) -> Tuple[Tensor, Tensor]:
    """Indices and values of the n largest |x_i * y_i| (util/select_max_dot.h).

    ``sharding``: x and y are this rank's slices of (N,) vectors; each rank
    takes its local top n, the candidates are all-gathered and merged
    (ties to the lower global index, as ``DistrArray``'s selections do),
    and every rank returns the same global indices and values."""
    prod = torch.abs(x * y)
    if sharding is None:
        vals, idx = torch.topk(prod, n)
        return idx, vals
    width = prod.shape[-1]
    k = min(n, width)
    # rows: value, local position, this rank's width (the chunk of the
    # layout is the widest rank's, so rank r's slice starts at r * chunk)
    cand = torch.full((3, n), -float("inf"), dtype=torch.float64, device=x.device)
    cand[2] = float(width)
    if k:
        top, pos = torch.topk(prod.to(torch.float64), k)
        cand[0, :k] = top
        cand[1, :k] = pos.to(torch.float64)
    cand = all_gather(cand, sharding.mesh, dim=1)
    chunk = torch.max(cand[2])
    owner = torch.arange(cand.shape[1], device=x.device) // n
    live = cand[1] > -float("inf")
    key = cand[0][live]
    gidx = (owner[live].to(torch.float64) * chunk + cand[1][live]).to(torch.long)
    # descending value, then ascending index: stable sorts, index first
    order = torch.sort(gidx, stable=True).indices
    order = order[torch.sort(key[order], descending=True, stable=True).indices][:n]
    return gidx[order], key[order].to(x.dtype)


def fused_axpy(alphas: Tensor, xs: Tensor, y: Tensor) -> Tensor:
    """y + sum_k alphas[k] * xs[k] in one pass (LazyHandle fused axpy,
    ArrayHandler.h:271-292)."""
    return y + torch.einsum("k,kn->n", alphas, xs)


def fused_dot(x: Tensor, ys: Tensor, sharding=None) -> Tensor:
    """All <x, ys[k]> in one pass (LazyHandle fused_dot); one all-reduce
    under ``sharding``."""
    return psum(torch.matmul(ys, x), sharding)



def mgs_project(r: Tensor, xblock: Tensor, inv_norms: Tensor, sharding=None) -> Tensor:
    """Sequential modified-Gram-Schmidt projection of rows of ``r`` against
    the rows of ``xblock`` in order: r -= (r . x_i) * inv_norms[i] * x_i.

    ``inv_norms[i] = 1/|<x_i,x_i>|`` for active rows and 0 for padding rows.
    Mirrors the orthogonalise sweep of propose_rspace.h:433-449."""
    for i in range(xblock.shape[0]):
        x = xblock[i]
        dots = psum(torch.matmul(r, x), sharding)
        r = r - (dots * inv_norms[i])[:, None] * x[None, :]
    return r


def jacobi_precondition_block(residual: Tensor, shifts: Tensor,
                              diagonals: Tensor, small: float = 1e-15) -> Tensor:
    """Davidson/Jacobi update r_i /= (d - shift_i + small) for a row block.

    Default preconditioner semantics of IterativeSolver.h:34-63 (the
    reference adds ``+1e-15`` with no sign guard — reproduced for parity).
    """
    return residual / (diagonals[None, :] - shifts[:, None] + small)


def adapt_sharding(sharding, ndim: int):
    """Fit a sharding's spec to an array rank: keep the trailing (vector)
    axes, so a (rows, N) block spec applies to an (N,) vector as (N,)."""
    return None if sharding is None else sharding.adapt(ndim)


def to_device(x, dtype=None, device=None, sharding=None) -> Tensor:
    """A tensor of ``x`` (numpy, list or tensor) on ``device``; with
    ``sharding``, this rank's slice of the global ``x`` on the mesh's
    device. The bytes that land on a CUDA device from host memory add to
    the counter ``h2d_bytes`` (utils/profiler.py) while a profiler
    records."""
    if sharding is not None:
        out = sharding.shard(x, dtype=dtype)
    elif isinstance(x, torch.Tensor):
        out = x.to(device=device, dtype=dtype)
    else:
        out = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    if out.is_cuda and not (isinstance(x, torch.Tensor) and x.is_cuda):
        count("h2d_bytes", out.numel() * out.element_size())
    return out


def to_host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
