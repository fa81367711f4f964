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
counterpart of the JAX package's ``Precision.HIGHEST``. Sharding helpers
(``adapt_sharding``) wait for the port of the distributed layer (ROADMAP.md
Queue 1, item 6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import config as _config  # noqa: F401  (precision pins)

Tensor = torch.Tensor


def gram(x: Tensor, y: Tensor) -> Tensor:
    """<x_i, y_j> for row blocks: (m, N) x (k, N) -> (m, k)."""
    return torch.matmul(x, y.T)


def gram_sym(x: Tensor) -> Tensor:
    """<x_i, x_j> overlap of a block with itself: (m, N) -> (m, m)."""
    return torch.matmul(x, x.T)


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


def dots_rows(x: Tensor, y: Tensor) -> Tensor:
    """Row-wise dot products: (m, N), (m, N) -> (m,)."""
    return torch.einsum("in,in->i", x, y)


def chol_jitter(dtype) -> float:
    """Gram jitter that EXCEEDS the dtype's Gram roundoff, for unit-scale
    rows. A nearly linearly dependent block's Gram reads min-eig ~ -eps by
    rounding (f64 ~ -1e-16, f32 ~ -1e-6) and an under-jittered Cholesky
    fails — and a NaN error vector reads as CONVERGED in every fused solve
    loop's condition (NaN > tol is False)."""
    return 1e-12 if dtype == torch.float64 else 1e-5


def norms_rows(x: Tensor) -> Tensor:
    return torch.sqrt(torch.abs(torch.einsum("in,in->i", x, x)))


def normalize_rows(x: Tensor, thresh: float = 1.0e-14) -> Tuple[Tensor, Tensor]:
    """Normalise each row unless its norm is below ``thresh`` (left untouched).

    Mirrors detail::normalise (IterativeSolverTemplate.h:80-93).
    """
    norms = norms_rows(x)
    safe = torch.where(norms > thresh, norms, torch.ones_like(norms))
    return x / safe[:, None], norms


def select_smallest(values: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """Indices and values of the n smallest elements (ascending), the
    handler ``select`` with smallest=true (util/select.h)."""
    neg_vals, idx = torch.topk(-values, n)
    return idx, -neg_vals


def select_max_dot(x: Tensor, y: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """Indices and values of the n largest |x_i * y_i| (util/select_max_dot.h)."""
    vals, idx = torch.topk(torch.abs(x * y), n)
    return idx, vals


def fused_axpy(alphas: Tensor, xs: Tensor, y: Tensor) -> Tensor:
    """y + sum_k alphas[k] * xs[k] in one pass (LazyHandle fused axpy,
    ArrayHandler.h:271-292)."""
    return y + torch.einsum("k,kn->n", alphas, xs)


def fused_dot(x: Tensor, ys: Tensor) -> Tensor:
    """All <x, ys[k]> in one pass (LazyHandle fused_dot)."""
    return torch.matmul(ys, x)


def mgs_project(r: Tensor, xblock: Tensor, inv_norms: Tensor) -> Tensor:
    """Sequential modified-Gram-Schmidt projection of rows of ``r`` against
    the rows of ``xblock`` in order: r -= (r . x_i) * inv_norms[i] * x_i.

    ``inv_norms[i] = 1/|<x_i,x_i>|`` for active rows and 0 for padding rows.
    Mirrors the orthogonalise sweep of propose_rspace.h:433-449."""
    for i in range(xblock.shape[0]):
        x = xblock[i]
        dots = torch.matmul(r, x)
        r = r - (dots * inv_norms[i])[:, None] * x[None, :]
    return r


def jacobi_precondition_block(residual: Tensor, shifts: Tensor,
                              diagonals: Tensor, small: float = 1e-15) -> Tensor:
    """Davidson/Jacobi update r_i /= (d - shift_i + small) for a row block.

    Default preconditioner semantics of IterativeSolver.h:34-63 (the
    reference adds ``+1e-15`` with no sign guard — reproduced for parity).
    """
    return residual / (diagonals[None, :] - shifts[:, None] + small)


def to_device(x, dtype=None, device=None) -> Tensor:
    """A tensor of ``x`` (numpy, list or tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def to_host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
