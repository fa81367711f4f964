"""High-precision matvec paths without a native f64 product (port of
iterative_solver_tpu/ops/precise.py).

A plain f32 matvec floors Davidson residuals at about
sqrt(N) eps_f32 ||A||. Two tools push past that floor:

1. ``SplitOperator`` / ``precise_matmat``: a double-float32 operator
   A = A_hi + A_lo (f64-grade entries) with split-K accumulation: the
   contraction runs as K chunk products whose f32 sums span only N/K
   terms, and the K partials combine in a compensated (Neumaier) sum.
   The JAX package runs it as an XLA ``fori_loop`` with no Pallas; here it
   is a loop of torch products over the chunks.

2. ``refine_on_host``: take the device-converged Ritz vectors and
   warm-start an f64 block Davidson on the host, which reaches the
   reference's 1e-8 bands in a few cheap iterations from a start that is
   already about 1e-5 accurate.

``SplitOperator.from_dense(sharding=)`` keeps this rank's rows of hi and
lo (``matrix_row_sharding``'s layout; one process per shard, as in
``parallel/mesh.py``): ``precise_matmat`` and ``precise_matvec_fn`` then
all-gather the rank's slice of x once and return its slice of y, the
contraction and its chunks unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from ..parallel.mesh import check_sharding, matrix_row_sharding

Tensor = torch.Tensor


@dataclasses.dataclass
class SplitOperator:
    """Double-float32 dense operator: hi + lo sum to the f64 matrix."""

    hi: Tensor          # (N, N) f32; under sharding the rank's (N_local, N) rows
    lo: Tensor          # (N, N) f32 residual (A - hi), rows as hi's
    n_chunks: int
    diagonal: np.ndarray
    sharding: Optional[object] = None   # the row sharding, or None

    @classmethod
    def from_dense(cls, matrix: np.ndarray, n_chunks: int = 64, sharding=None,
                   device=None) -> "SplitOperator":
        """``device=None`` is the CUDA device (raises without it); under
        ``sharding`` the mesh's, with this rank's rows."""
        sharding = check_sharding(sharding)
        device = (sharding.mesh.device if sharding is not None
                  else config.resolve_device(device))
        matrix = np.asarray(matrix, dtype=np.float64)
        n = matrix.shape[1]
        if n % n_chunks != 0:
            # snap to the largest divisor of N not exceeding the request
            n_chunks = max(k for k in range(1, min(n_chunks, n) + 1) if n % k == 0)
        hi = matrix.astype(np.float32)
        lo = (matrix - hi.astype(np.float64)).astype(np.float32)
        if sharding is None:
            return cls(torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device),
                       n_chunks, np.diagonal(matrix).copy())
        rows = matrix_row_sharding(sharding.mesh)
        return cls(rows.shard(hi), rows.shard(lo), n_chunks, np.diagonal(matrix).copy(),
                   rows)

    def operand(self) -> Tuple[Tensor, Tensor]:
        return (self.hi, self.lo)


def _precise_matmat(x: Tensor, hi: Tensor, lo: Tensor, n_chunks: int) -> Tensor:
    """y = x @ (hi + lo)^T with split-K f32 accumulation and a compensated
    combine (precise.py:63-89). The result is in x's dtype but carries the
    accuracy of the chunked accumulation."""
    m, n = x.shape
    nc = n // n_chunks
    s = torch.zeros((m, hi.shape[0]), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for k in range(n_chunks):
        cols = slice(k * nc, (k + 1) * nc)
        xk = x[:, cols]
        # chunk partial: its accumulator spans only nc terms (a float64 x
        # promotes the planes, as the JAX einsum does)
        t = (torch.matmul(xk, hi[:, cols].T.to(x.dtype))
             + torch.matmul(xk, lo[:, cols].T.to(x.dtype)))
        new_s = s + t
        # Neumaier compensation: the low-order bits the addition lost
        c = c + torch.where(torch.abs(s) >= torch.abs(t), (s - new_s) + t, (t - new_s) + s)
        s = new_s
    return s + c


def _gathered(x: Tensor, sharding, n: int) -> Tensor:
    """The whole (m, n) rows of x, from this rank's slice under
    ``sharding``."""
    if sharding is None:
        return x
    from ..parallel.collectives import all_gather

    return all_gather(x, sharding.mesh, dim=1, n=n)


def precise_matmat(x: Tensor, op: SplitOperator) -> Tensor:
    """x @ (hi + lo)^T; under the operator's sharding x is this rank's
    slice, gathered once, and y the rank's slice."""
    return _precise_matmat(_gathered(x, op.sharding, op.hi.shape[1]), op.hi, op.lo,
                           op.n_chunks)


def precise_matvec_fn(op: SplitOperator):
    """matvec(x, operand) for FusedDavidson with operand=(hi, lo); under
    the operator's sharding it maps the rank's slice of x to its slice of
    y."""
    n_chunks, sharding = op.n_chunks, op.sharding

    def matvec(x, operand):
        hi, lo = operand
        return _precise_matmat(_gathered(x, sharding, hi.shape[1]), hi, lo, n_chunks)

    return matvec


# ---------------------------------------------------------------------------
class _RefineStats:
    def __init__(self):
        self.iterations = 0


def refine_on_host(
    matrix: np.ndarray,
    x0,
    nroots: int,
    convergence_threshold: float = 1e-8,
    max_iter: int = 30,
    hermitian: bool = True,
):
    """Warm-start an f64 block-Davidson refinement from device-converged
    vectors (precise.py:100-173). Pure numpy, so it runs in true double
    precision whatever device produced ``x0`` (a tensor is copied to the
    host).

    Returns ``(eigenvalues, vectors, info)`` with ``info.iterations`` and
    ``info.errors``."""
    a = np.asarray(matrix, dtype=np.float64)
    diag = np.diagonal(a)
    if isinstance(x0, torch.Tensor):
        x0 = x0.detach().cpu().numpy()
    x0 = np.asarray(x0, dtype=np.float64)[:nroots]
    # orthonormalize the start
    v = x0 / np.linalg.norm(x0, axis=1, keepdims=True)
    v, _ = np.linalg.qr(v.T)
    v = v.T
    m_max = max(4 * nroots, nroots + 8)
    info = _RefineStats()
    errors = np.full(nroots, np.inf)
    evals = np.zeros(nroots)
    x = v[:nroots].copy()
    for it in range(max_iter):
        w = v @ a.T
        h = v @ w.T
        h = 0.5 * (h + h.T)
        theta, c = np.linalg.eigh(h)
        coeff = c[:, :nroots].T
        x = coeff @ v
        ax = coeff @ w
        evals = theta[:nroots]
        r = ax - evals[:, None] * x
        errors = np.linalg.norm(r, axis=1)
        info.iterations = it + 1
        if np.all(errors <= convergence_threshold):
            break
        t = r / (diag[None, :] - evals[:, None] + 1e-15)
        # orthogonalise against V twice, then among themselves
        for _ in range(2):
            t = t - (t @ v.T) @ v
        keep = np.linalg.norm(t, axis=1) > 1e-12
        t = t[keep]
        if t.shape[0] == 0:
            break
        q, _ = np.linalg.qr(t.T)
        t = q.T
        if v.shape[0] + t.shape[0] > m_max:
            v = x / np.linalg.norm(x, axis=1, keepdims=True)
            q, _ = np.linalg.qr(v.T)
            v = q.T
        v = np.vstack([v, t])
    info.errors = list(errors)
    return evals.copy(), x, info
