"""Mixed-precision eigenpair refinement to an f64 residual bar (port of
iterative_solver_tpu/solvers/refine.py).

The reference's acceptance tests converge every solve to
``convergence_threshold = 1.0e-8`` (test_LinearEigensystem.cpp:196,303-341)
in f64 arithmetic. A float32 device carrier floors residuals earlier (a
few 1e-6 even with the split double-bf16 operator). An outer iterative
refinement breaks that floor:

1. hold the eigenvector block X in **host f64** and Rayleigh-Ritz it
   against the exact f64 action (a small (r, r) eigh on the host);
2. form the f64 residuals R = A X - Lambda X; stop at the bar;
3. solve the deflated correction equations on the device tier,
       M_i d_i = -r_i,   M_i = P (A - lambda_i I) P + c (I - P),
   with P = I - X^T X the projector off the current block. On the
   complement M_i is the shifted operator (positive definite while
   lambda_i < lambda_{r+1}); on the block it is c I, so M is SPD on all of
   R^N and ``FusedBlockCG`` runs unmodified (per-RHS shifts are its
   response-equation form);
4. X <- orthonormalize(X + Delta) in f64; repeat.

Each pass multiplies the residual by about max(inner_tol, |E|/gap), E the
device operator's representation error. The correction equation follows
Jacobi-Davidson (Sleijpen & van der Vorst 1996); the deflation weight c
keeps the wrapped operator SPD instead of restricting CG to the
complement.

``sharding=`` (parallel/mesh.py, e.g. ``block_sharding(mesh)``) runs the
correction solves one process per shard of the vector axis: the device
matvec maps the rank's slice of x to its slice of y (``ShardedSymmetric``,
whose precise tier runs K3 on the rank's pairs), the CG's diagonal and the
deflated block are the rank's slices, and both projections onto the
locked block are all-reduced. The f64 Rayleigh-Ritz stays global: every
rank runs it on the host on the same whole X, as the JAX package runs it
on ``np.asarray`` of the global array, so every rank returns the same
bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..parallel.collectives import psum
from ..parallel.mesh import check_sharding

Tensor = torch.Tensor


class RefineResult(NamedTuple):
    eigenvalues: np.ndarray     # (r,) f64 Rayleigh-Ritz values
    x: np.ndarray               # (r, N) f64 orthonormal eigenvector block
    residual_norms: np.ndarray  # (r,) f64 ||A x_i - lambda_i x_i||
    passes: int                 # refinement passes executed
    converged: bool
    history: list               # max residual after each Rayleigh-Ritz


def _orthonormalize_rows(x: np.ndarray) -> np.ndarray:
    q, _ = np.linalg.qr(x.T)
    return np.ascontiguousarray(q.T)


def make_deflated_matvec(matvec: Callable[..., Tensor], cw: float, sharding=None):
    """Wrap a device matvec into the SPD correction operator.

    operand = (inner_operand, x_defl (r, N) orthonormal, lam (r,)). Row i
    of the output applies P(A - lam_i)P + cw (I - P) to row i of v.
    ``sharding``: v and x_defl are this rank's slices and both projections
    are all-reduced."""

    def wrapped(v, packed):
        op, xd, lam = packed
        coef = psum(torch.matmul(v, xd.T), sharding)
        pv = v - torch.matmul(coef, xd)
        av = matvec(pv, op)
        acoef = psum(torch.matmul(av, xd.T), sharding)
        apv = av - torch.matmul(acoef, xd)
        return apv - lam[:, None] * pv + cw * torch.matmul(coef, xd)

    return wrapped


class EigenpairRefiner:
    """Refine approximate lowest eigenpairs to an f64 residual bar.

    Parameters
    ----------
    action_f64:
        ``X (r, N) f64 -> A X (r, N) f64``, the exact operator in f64 on
        the host (numpy, scipy.sparse, or a CPU torch callable). Called once
        per pass on the whole block; the accuracy anchor.
    matvec, operand:
        the device-tier action of the correction solves: any fused matvec
        (packed split or bf16 tiers, BSR, dense).
    diagonals:
        (N,) operator diagonal for the Jacobi preconditioner.
    nroots, n:
        block size and vector length.
    inner_tol, cg_max_iter:
        relative tolerance and iteration cap of each FusedBlockCG
        correction solve.
    deflation_weight:
        the c in M = P(A-lam)P + c(I-P); default max(1, max|diag|).
    device:
        where the correction solves run (``None``: the CUDA device; the
        mesh's under ``sharding``).
    sharding:
        the correction solves' vector axis over a mesh (the module note);
        ``matvec`` then maps a rank's slice to its slice.

    ``cg_iterations`` lists the iteration count of each correction solve,
    across every ``refine`` call, in order.
    """

    def __init__(
        self,
        action_f64: Callable[[np.ndarray], np.ndarray],
        matvec: Callable[..., Tensor],
        operand,
        diagonals,
        n: int,
        nroots: int,
        dtype=None,
        sharding=None,
        inner_tol: float = 1e-3,
        cg_max_iter: int = 400,
        deflation_weight: Optional[float] = None,
        device=None,
    ):
        from .fused_cg import FusedBlockCG

        self.sharding = check_sharding(sharding)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.action_f64 = action_f64
        self.n = n
        self.nroots = nroots
        self.dtype = dtype
        self.inner_tol = inner_tol
        self.diag = np.asarray(diagonals, dtype=np.float64)
        cw0 = deflation_weight if deflation_weight is not None else max(
            1.0, float(np.max(np.abs(self.diag))))
        self._wrapped = make_deflated_matvec(matvec, cw0, self.sharding)
        # one CG for every pass: its operand and diagonal are replaced per
        # pass
        self._cg = FusedBlockCG(
            self._wrapped,
            np.ones((nroots, n)),  # placeholder; replaced per pass
            n,
            nrhs=nroots,
            dtype=dtype,
            sharding=self.sharding,
            convergence_threshold=inner_tol,
            max_iter=cg_max_iter,
            operand=None,
            check_symmetric=False,  # symmetric by construction
            device=self.device,
        )
        self._operand = operand
        self.cg_iterations = []

    def _rayleigh_ritz(self, x: np.ndarray):
        """f64 RR of span(x): returns rotated (x, ax, lam, residual norms, r)."""
        ax = self.action_f64(x)
        if isinstance(ax, torch.Tensor):
            ax = ax.detach().cpu().numpy()
        ax = np.asarray(ax, dtype=np.float64)
        b = x @ ax.T
        b = 0.5 * (b + b.T)
        lam, u = np.linalg.eigh(b)
        x = u.T @ x
        ax = u.T @ ax
        r = ax - lam[:, None] * x
        return x, ax, lam, np.linalg.norm(r, axis=1), r

    def _tensor(self, a: np.ndarray) -> Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def refine(self, x0, tol: float = 1e-8, max_passes: int = 6) -> RefineResult:
        if isinstance(x0, torch.Tensor):
            x0 = x0.detach().cpu().numpy()
        x = _orthonormalize_rows(np.asarray(x0, dtype=np.float64))
        history = []
        passes = 0
        lam = resn = None
        for _ in range(max_passes + 1):
            x, ax, lam, resn, r = self._rayleigh_ritz(x)
            history.append(float(resn.max()))
            if resn.max() <= tol:
                return RefineResult(lam, x, resn, passes, True, history)
            if passes >= max_passes:
                break
            if len(history) >= 2 and history[-1] > 0.5 * history[-2]:
                # refinement stalled (inner operator error, or a deflation
                # gap violation: lambda_i >= lambda_{r+1} makes M singular)
                break
            passes += 1
            # project the residual off the block (already block-orthogonal
            # up to f64 roundoff) and solve the corrections
            rp = r - (r @ x.T) @ x
            # per-RHS Jacobi diagonal |d - lambda_i|, clamped positive: the
            # CG preconditioner must stay SPD where d crosses lambda
            scale = float(np.max(np.abs(self.diag))) + 1e-300
            dshift = np.maximum(np.abs(self.diag[None, :] - lam[:, None]), 1e-3 * scale)
            self._cg.diag = self._cg._tensor(dshift)
            self._cg.operand = (self._operand, self._cg._tensor(x), self._tensor(lam))
            delta, _, cg_iters = self._cg.solve(-rp)
            self.cg_iterations.append(cg_iters)
            x = _orthonormalize_rows(x + delta.detach().cpu().numpy().astype(np.float64))
        return RefineResult(lam, x, resn, passes, bool(resn.max() <= tol), history)
