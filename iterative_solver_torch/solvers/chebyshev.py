"""Chebyshev polynomial filtering for the fused Davidson expansion step
(port of iterative_solver_tpu/solvers/chebyshev.py).

The reference expands its Krylov space with the Jacobi-preconditioned
residual (IterativeSolver.h:34-44). Where the matvec runs near the memory
roof while everything between matvecs (eigh, Gram-Schmidt, host dispatch)
is latency-bound, trading "more matvecs per subspace vector" for "fewer
subspace iterations" pays whenever the spectrum is not strongly diagonally
dominant. Chebyshev-filtered subspace expansion (Zhou & Saad
Chebyshev-Davidson; ChASE) does exactly that: the new direction is

    t = p_d(A) x,   p_d = scaled Chebyshev polynomial of degree ``d``

damping every spectral component in the unwanted interval [a, b] while
amplifying the wanted low end below ``a``. Each filter application is ``d``
more matvecs inside the same step, batched over the whole ``(nroots, N)``
block.

The reference has no polynomial filtering. This plugs into
``FusedDavidson(expand=...)`` through the generic expansion hook; after the
hook the fused chain (K2) runs in raw mode.

``dtype=None`` is float32 on CUDA and float64 on the CPU (the JAX package
reads ``jax_enable_x64``); ``device=None`` is the CUDA device.

Under ``sharding=`` (passed through to ``FusedDavidson``, one process per
shard of the vector axis) the filter is elementwise around the matvec,
which maps a rank's slice to its slice, and needs nothing more; the Lanczos
bounds build the same seeded global start vector on every rank, keep its
slice and all-reduce their dots.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..parallel.mesh import check_sharding
from .fused_davidson import FusedDavidson, _dots

Tensor = torch.Tensor


def estimate_spectral_bounds(
    matvec: Callable[..., Tensor],
    n: int,
    operand=None,
    iters: int = 12,
    dtype=None,
    seed: int = 0,
    safety: float = 1.05,
    device=None,
    sharding=None,
) -> Tuple[float, float]:
    """Estimate (lambda_min, lambda_max) of the operator with a short Lanczos
    run, padded by the final Lanczos residual norm so that the returned
    interval CONTAINS the spectrum (an upper bound that clips the true
    spectrum makes the Chebyshev filter amplify, not damp, the clipped
    components), then widened by ``safety`` about its centre.

    The JAX package runs one jitted ``fori_loop``; here a host loop of
    ``iters`` steps issues the same operations with no host read until the
    tridiagonal eigvalsh. The matvec is called on a ``(1, n)`` row block,
    the solver's convention. The start vector comes from
    ``np.random.default_rng(seed)``, as in the JAX package. ``sharding``:
    the matvec maps a rank's slice to its slice; every rank keeps its
    slice of the same start vector and the dots are all-reduced."""
    sh = check_sharding(sharding)
    device = sh.mesh.device if sh is not None else config.resolve_device(device)
    if dtype is None:
        dtype = config.default_dtype(device)
    k = int(iters)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((1, n))
    v = (sh.shard(v, dtype) if sh is not None
         else torch.as_tensor(v, dtype=dtype, device=device))
    v = v / torch.sqrt(_dots(v, v, sh))[:, None]
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas = torch.zeros((k,), dtype=dtype, device=device)
    betas = torch.zeros((k,), dtype=dtype, device=device)
    for i in range(k):
        w = matvec(v, operand) - beta * v_prev
        alpha = _dots(w, v, sh)[0]
        w = w - alpha * v
        beta_new = torch.sqrt(torch.abs(_dots(w, w, sh)))[0]
        v_next = w / torch.where(beta_new > 0, beta_new, torch.ones_like(beta_new))
        alphas[i] = alpha
        betas[i] = beta_new
        v_prev, v, beta = v, v_next, beta_new
    # tridiagonal Ritz values + final residual pad
    tmat = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    ritz = torch.linalg.eigvalsh(tmat)
    pad = torch.abs(betas[-1])
    lo, hi = float(ritz[0] - pad), float(ritz[-1] + pad)
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo) * float(safety)
    return center - half, center + half


def make_chebyshev_expand(
    matvec: Callable[..., Tensor],
    degree: int,
    lambda_max: float,
    lambda_min: Optional[float] = None,
):
    """Build an ``expand`` hook for :class:`FusedDavidson`: the degree-``d``
    scaled Chebyshev filter applied to the RITZ block (Zhou-Saad
    Chebyshev-Davidson). Filtering the Ritz vectors, not the residuals, is
    what converges: the residual's correction components live inside the
    damping window by construction, while ``p_d(A) x`` enriches the wanted
    eigendirections relative to the contamination at every application.

    The damping interval is ``[a, lambda_max]``, ``a`` chosen each
    iteration from the CURRENT subspace: the largest active Ritz value (the
    top edge of what the basis already resolves, the CheFSI convention).
    ``lambda_max`` must bound the whole spectrum from above
    (:func:`estimate_spectral_bounds`). ``lambda_min``, when given, floors
    the scaling point so that the amplification factor stays bounded.

    The sigma-scaled three-term recurrence (ChASE / Zhou-Saad) keeps the
    intermediate norms O(1) in float32:

        e = (b - a)/2, c = (b + a)/2, sigma_1 = e / (c - lambda_0)
        y_1 = (sigma_1/e) (A - c) y_0
        sigma_{k+1} = 1 / (2/sigma_1 - sigma_k)
        y_{k+1} = 2 (sigma_{k+1}/e) (A - c) y_k - sigma_k sigma_{k+1} y_{k-1}

    Cost: ``degree`` matvecs per iteration on the ``(nroots, N)`` block.
    Pass ``matvecs_per_direction=degree`` to keep FusedDavidson's
    statistics honest. Use with ``rr="full"`` only: ``a`` is read from
    ``evals_all`` as the top resolved Ritz value of the whole subspace,
    which the window RR modes do not provide."""
    if degree < 1:
        raise ValueError("Chebyshev degree must be >= 1")
    b = float(lambda_max)
    edge = 1e-6 * (abs(b) + 1.0)

    def expand(x, r, evals, evals_all, mask, diag, operand):
        del r, diag
        # lower filter edge: the top of what the subspace resolves. Masked
        # max over ACTIVE slots only: _masked_eigh pads the inactive
        # diagonals above the active spectrum, and they must not leak in.
        neg_inf = torch.full_like(evals_all, -float("inf"))
        a = torch.max(torch.where(mask > 0, evals_all, neg_inf))
        # keep a strictly inside (lambda_0, b) so e > 0 and sigma_1 is finite
        lam0 = evals[0]
        a = torch.clamp(torch.maximum(a, lam0 + edge), max=b - edge)
        e = 0.5 * (b - a)
        c = 0.5 * (b + a)
        if lambda_min is not None:
            lam0 = torch.clamp(lam0, min=float(lambda_min))
        sigma1 = e / (c - lam0)

        y_prev = x
        y = (sigma1 / e) * (matvec(x, operand) - c * x)
        sigma = sigma1
        for _ in range(degree - 1):
            sigma_next = 1.0 / (2.0 / sigma1 - sigma)
            ay = matvec(y, operand) - c * y
            y_next = (2.0 * sigma_next / e) * ay - (sigma * sigma_next) * y_prev
            y_prev, y, sigma = y, y_next, sigma_next
        return y

    return expand


def make_chebyshev_davidson(
    matvec: Callable[..., Tensor],
    diagonals,
    n: int,
    nroots: int = 1,
    degree: int = 4,
    lambda_max: Optional[float] = None,
    lambda_min: Optional[float] = None,
    operand=None,
    **kwargs,
):
    """A :class:`FusedDavidson` whose expansion step is the
    degree-``degree`` Chebyshev filter. The spectral bounds are estimated by
    Lanczos (on ``kwargs``' device and dtype) when ``lambda_max`` is not
    given; under ``sharding`` in kwargs, sharded as the solver is."""
    if kwargs.get("rr", "full") != "full":
        # the filter's lower edge is the top resolved Ritz value of the FULL
        # subspace; the window RR exposes only its 2r/3r window values
        raise ValueError("Chebyshev-Davidson requires rr='full'")
    if lambda_max is None:
        lo, hi = estimate_spectral_bounds(matvec, n, operand=operand,
                                          dtype=kwargs.get("dtype"),
                                          device=kwargs.get("device"),
                                          sharding=kwargs.get("sharding"))
        lambda_max = hi
        if lambda_min is None:
            lambda_min = lo
    expand = make_chebyshev_expand(matvec, degree, lambda_max, lambda_min)
    return FusedDavidson(
        matvec,
        diagonals,
        n,
        nroots=nroots,
        operand=operand,
        expand=expand,
        matvecs_per_direction=degree,
        **kwargs,
    )
