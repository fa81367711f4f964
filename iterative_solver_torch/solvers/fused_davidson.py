"""Fused Davidson eigensolver in PyTorch (port of
iterative_solver_tpu/solvers/fused_davidson.py).

One step runs the whole Davidson iteration on the device —

  matvec -> masked subspace Rayleigh matrix -> small eigh -> Ritz
  reconstruction -> residuals -> Jacobi preconditioning -> Gram-Schmidt
  against the basis -> whitening -> basis append

and the host checks convergence between steps (one scalar sync per step).
The basis lives in a fixed-capacity ``(m_max, N)`` stack; slot validity is
tracked with a mask whose inactive diagonal entries are pushed above the
spectrum before the eigh. Restarts collapse the basis onto the current Ritz
vectors (the DSpaceResetter analogue, DSpaceResetter.h:69-146).

Differences from the JAX package, each kept to the same semantics:

- ``lax.while_loop`` + ``lax.cond`` restarts become a host loop: the
  condition is checked before every iteration (the first included, on the
  init residuals), a restart happens when ``k + nroots > m_max``, and
  ``tol``/``max_iter`` stay runtime arguments. ``k`` is a host int.
- A step appends into the state's basis and action stacks IN PLACE (the
  JAX step donates its input state for the same reason: no second copy of
  the stacks); do not reuse a state after stepping it.
- ``jnp.linalg.cholesky`` returns NaN on a non-positive-definite input and
  the solver relies on that (``check_finite``); here ``cholesky_ex`` with
  its failures NaN-filled gives the same contract without a host sync.
- An append past the stack's capacity raises instead of clamping
  (``dynamic_update_slice`` clamps; ``_validate_rr`` guards both).

P-space, sharding, checkpointing, the batched solve and the int8 tiers are
not ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops.kernels.chain import (
    _cholesky_nan,
    chain_auto,
    fused_expand_chain,
    whiten_after_chain,
)
from ._finite import check_finite

Tensor = torch.Tensor

_PSPACE = "P-space is not ported yet (ROADMAP.md Queue 1, item 5)"
_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 15)"
_CHECKPOINT = "checkpointing is not ported yet (ROADMAP.md Queue 1, item 5)"
_BATCHED = "the batched solve is not ported yet (ROADMAP.md Queue 1, item 5)"
_INT8 = "the int8 tiers are not ported yet (ROADMAP.md Queue 1, item 7)"


class DavidsonState(NamedTuple):
    v: Tensor        # (m_max, N) basis stack (rows orthonormal where mask)
    w: Tensor        # (m_max, N) action stack  A v
    mask: Tensor     # (m_max,) 1.0 for active slots
    k: int           # count of appended slots (host int)
    evals: Tensor    # (nroots,) current Ritz values
    x: Tensor        # (nroots, N) current Ritz vectors
    r: Tensor        # (nroots, N) current residuals
    errors: Tensor   # (nroots,) residual norms
    c: Optional[Tensor] = None   # (m_max, nroots) carried Ritz coefficients
    cm: Optional[Tensor] = None  # (m_max, nroots) momentum block (rr="window3")


def _dots(a: Tensor, b: Tensor) -> Tensor:
    return torch.einsum("in,in->i", a, b)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _masked_eigh(v, w, mask):
    """Rayleigh matrix over active slots; inactive diagonals pushed just
    above the active spectrum so their eigenpairs sort last. The pad value
    tracks the matrix scale (a huge constant would wreck a float32 eigh).
    The JAX package promotes this eigh to f64 wherever f64 is native (every
    backend but the TPU); the port does so on the CPU and on CUDA."""
    h = torch.matmul(v, w.T)
    h = 0.5 * (h + h.T)
    h = h * (mask[:, None] * mask[None, :])
    big = 4.0 * torch.max(torch.abs(h)) + 1.0
    dead = 1.0 - mask
    h = h + dead[:, None] * dead[None, :] * _eye(h.shape[0], h) * big
    if h.dtype != torch.float64:
        evals, c = torch.linalg.eigh(h.to(torch.float64))
        return evals.to(h.dtype), c.to(h.dtype)
    return torch.linalg.eigh(h)


def _eigh_whiten_cols(p, thresh: float = 1e-8):
    """Orthonormalise the columns of a coefficient block via its Gram
    eigendecomposition, dropping null directions. Returns ``(p_white, keep)``."""
    g = torch.matmul(p.T, p)
    g = 0.5 * (g + g.T)
    gw, gu = torch.linalg.eigh(g)
    keep = gw > thresh
    scale = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, gw, torch.ones_like(gw))),
                        torch.zeros_like(gw))
    return torch.matmul(p, gu * scale[None, :]), keep


def _window_rr(v, w, mask, k: int, c_prev, nroots: int, m_max: int, c_mom=None):
    """Locally-optimal window Rayleigh-Ritz (fused_davidson.py:149-244):
    diagonalise H over span[c_prev | newest appended block] (2r) — plus an
    eigh-whitened momentum group (3r) when ``c_mom`` is given — instead of
    the full m-dim basis. The newest block's slots are orthonormal to
    everything older, so the window basis is orthonormal by construction.
    Returns ``(evals[:nroots], c_new, evals_all padded to (m_max,))``."""
    dtype, dev = v.dtype, v.device
    h = torch.matmul(v, w.T)
    h = 0.5 * (h + h.T)
    h = h * (mask[:, None] * mask[None, :])

    cp, keep_c = c_prev, torch.ones((nroots,), dtype=torch.bool, device=dev)
    # one-hot columns for the newest block's slots [k-r, k), masked by slot
    # validity (appends dropped as null keep mask 0 and must not enter W)
    slot = torch.arange(m_max, device=dev)
    col = torch.arange(nroots, device=dev)
    e = (slot[:, None] == (k - nroots) + col[None, :]).to(dtype) * mask[:, None]
    # project out the carried block (exactly zero overlap except the first
    # step after init/restart, where the newest block IS the carried block)
    e = e - torch.matmul(cp, torch.matmul(cp.T, e))
    n2 = torch.sum(e * e, dim=0)
    keep = n2 > 0.5  # columns are one-hots: either ~1 or projected to ~0
    e = e * torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, n2, torch.ones_like(n2))),
                        torch.zeros_like(n2))[None, :]
    groups, keeps = [cp, e], [keep_c, keep]

    if c_mom is not None:
        # momentum group: previous-step Ritz block, projected against the
        # earlier groups then eigh-whitened
        p = c_mom - torch.matmul(cp, torch.matmul(cp.T, c_mom))
        p = p - torch.matmul(e, torch.matmul(e.T, p))
        p, keep_p = _eigh_whiten_cols(p)
        groups.append(p)
        keeps.append(keep_p)

    wmat = torch.cat(groups, dim=1)  # (m_max, 2r|3r), orthonormal
    nw = wmat.shape[1]
    hw = torch.matmul(wmat.T, torch.matmul(h, wmat))
    hw = 0.5 * (hw + hw.T)
    colmask = torch.cat([kk.to(dtype) for kk in keeps])
    hw = hw * (colmask[:, None] * colmask[None, :])
    big = 4.0 * torch.max(torch.abs(hw)) + 1.0
    dead = 1.0 - colmask
    hw = hw + dead[:, None] * dead[None, :] * _eye(nw, hw) * big
    # the window's own eigh stays in the working dtype, as in the JAX package
    evals_all, u = torch.linalg.eigh(hw)
    cw = u[:, :nroots] * colmask[:, None]
    c_new = torch.matmul(wmat, cw)  # (m_max, r) orthonormal cols
    # eigenvalues of dropped (big-padded) columns sort last; blank them and
    # pad to (m_max,) so expand hooks see the full path's shape
    n_active = torch.sum(colmask.to(torch.int64))
    idx = torch.arange(nw, device=dev)
    clean = torch.where(idx < n_active, evals_all, torch.full_like(evals_all, -float("inf")))
    padded = torch.full((m_max,), -float("inf"), dtype=dtype, device=dev)
    padded[:nw] = clean
    return evals_all[:nroots], c_new, padded


def _validate_rr(rr: str, nroots: int, m_max: int, n_p: int = 0) -> None:
    width = {"full": 1, "window": 2, "window3": 3, "anchored": 2}.get(rr)
    if width is None:
        raise ValueError(f"unknown rr mode {rr!r}: use 'full', 'window', "
                         "'window3' or 'anchored'")
    # every mode needs room for the carried block PLUS one full append
    if max(2, width) * nroots + n_p > m_max:
        raise ValueError(
            f"rr={rr!r} needs m_max >= {max(2, width)}*nroots + n_p "
            f"({max(2, width) * nroots + n_p}), got {m_max}")


def _no_p_space(n_p: int) -> None:
    if n_p:
        raise NotImplementedError(_PSPACE)


def _step_body(
    matvec: Callable[..., Tensor],
    nroots: int,
    m_max: int,
    null_thresh: float = 1e-10,
    expand: Optional[Callable] = None,
    rr: str = "full",
    fuse_chain: bool = False,
    n_p: int = 0,
    anchor_every: int = 4,
):
    """Single-iteration body shared by step, sweep and solve
    (fused_davidson.py:263-393).

    ``expand(x, r, evals, evals_all, mask, diag, operand) -> t`` produces
    the new direction block; the default is the Jacobi/Davidson
    preconditioner applied to the residuals (IterativeSolver.h:34-44).

    ``rr``: "full" diagonalises the whole masked (m_max, m_max) subspace
    matrix every step; "window" solves a (2r, 2r) locally-optimal window;
    "window3" adds the LOBPCG momentum block (3r, 3r); "anchored" runs the
    window but a FULL RR every ``anchor_every``-th iteration (the step's
    fourth argument ``it``; a bare call with it=0 anchors).

    ``fuse_chain`` runs precondition + Gram-Schmidt + norms + Gram as one
    kernel call (ops/kernels/chain.py)."""
    _validate_rr(rr, nroots, m_max, n_p)
    _no_p_space(n_p)

    def step(state: DavidsonState, operand, diag: Tensor, it: int = 0) -> DavidsonState:
        v, w, mask, k = state.v, state.w, state.mask, state.k
        if rr in ("window", "window3", "anchored"):
            if rr == "anchored" and it % anchor_every == 0:
                ea, c = _masked_eigh(v, w, mask)
                evals, c_new, evals_all = ea[:nroots], c[:, :nroots] * mask[:, None], ea
            else:
                evals, c_new, evals_all = _window_rr(
                    v, w, mask, k, state.c, nroots, m_max,
                    c_mom=state.cm if rr == "window3" else None)
            coeff = c_new.T
        else:
            evals_all, c = _masked_eigh(v, w, mask)
            coeff = (c[:, :nroots] * mask[:, None]).T  # (nroots, m_max)
            evals = evals_all[:nroots]
            c_new = coeff.T
        x = torch.matmul(coeff, v)
        ax = torch.matmul(coeff, w)
        # Rayleigh-quotient refinement: full-length dots are ~eps*||A||
        # accurate, recovering eigenvalue accuracy the small eigh may lack
        xx = _dots(x, x)
        xax = _dots(x, ax)
        evals = torch.where(xx > 0, xax / torch.where(xx > 0, xx, torch.ones_like(xx)), evals)
        r = ax - evals[:, None] * x
        errors = torch.sqrt(torch.abs(_dots(r, r)))

        if fuse_chain:
            if expand is None:
                # Jacobi preconditioning runs inside the kernel
                t, n0_2, n2, g = fused_expand_chain(r, v, mask, diag, evals)
            else:
                t = expand(x, r, evals, evals_all, mask, diag, operand)
                t, n0_2, n2, g = fused_expand_chain(t.to(v.dtype), v, mask)
            t, keep = whiten_after_chain(t, n0_2, n2, nroots, null_thresh, g=g)
        else:
            if expand is None:
                # Jacobi/Davidson preconditioner with the regulariser made
                # RELATIVE to the spectrum scale
                scale_est = torch.max(torch.abs(diag)) + torch.max(torch.abs(evals))
                t = r / (diag[None, :] - evals[:, None] + 1e-15 * scale_est + 1e-300)
            else:
                t = expand(x, r, evals, evals_all, mask, diag, operand)
            # null detection compares post-GS norms to the PRE-GS norms
            n0_2 = _dots(t, t)
            # two classical GS passes against the basis
            for _ in range(2):
                proj = torch.matmul(t, v.T) * mask[None, :]
                t = t - torch.matmul(proj, v)
            n2 = _dots(t, t)
            t, keep = whiten_after_chain(t, n0_2, n2, nroots, null_thresh)

        # append at slot k, in place
        if k + nroots > m_max:
            raise ValueError(f"append at slot {k} overflows m_max={m_max}")
        v[k:k + nroots] = t.to(v.dtype)
        w[k:k + nroots] = matvec(t, operand).to(w.dtype)
        mask_new = mask.clone()
        mask_new[k:k + nroots] = torch.where(keep, torch.ones_like(mask[:nroots]),
                                             mask[k:k + nroots])
        c_out = c_new if state.c is not None or rr != "full" else None
        # the outgoing Ritz block becomes next step's momentum (window3)
        cm_out = state.c if state.cm is not None else None
        return DavidsonState(v, w, mask_new, k + nroots, evals, x, r, errors,
                             c_out, cm_out)

    return step


def make_davidson_step(matvec, nroots: int, m_max: int, null_thresh: float = 1e-10,
                       expand: Optional[Callable] = None, rr: str = "full",
                       fuse_chain: bool = False, n_p: int = 0,
                       anchor_every: int = 4):
    """Single iteration: ``step(state, operand, diag, it=0) -> state``."""
    return _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every)


def make_davidson_sweep(matvec, nroots: int, m_max: int, steps: int,
                        null_thresh: float = 1e-10,
                        expand: Optional[Callable] = None, rr: str = "full",
                        fuse_chain: bool = False, n_p: int = 0,
                        anchor_every: int = 4):
    """``steps`` Davidson iterations with no convergence check between them:
    ``sweep(state, operand, diag, it0=0)``; ``it0`` is the global iteration
    offset, so the anchored cadence does not reset at sweep boundaries."""
    body = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every)

    def sweep(state: DavidsonState, operand, diag: Tensor, it0: int = 0) -> DavidsonState:
        for i in range(steps):
            state = body(state, operand, diag, it0 + i)
        return state

    return sweep


def _restart_body(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                  n_p: int = 0):
    """Collapse the basis onto the current Ritz vectors (DSpaceResetter
    analogue, fused_davidson.py:433-491)."""
    _no_p_space(n_p)

    def restart(state: DavidsonState, operand) -> DavidsonState:
        x = state.x
        g = torch.matmul(x, x.T)
        l = _cholesky_nan(g + 1e-30 * _eye(nroots, g))
        xo = torch.linalg.solve_triangular(l, x, upper=False)
        v = torch.zeros_like(state.v)
        v[:nroots] = xo
        w = torch.zeros_like(state.w)
        w[:nroots] = matvec(xo, operand).to(w.dtype)
        mask = torch.zeros_like(state.mask)
        mask[:nroots] = 1.0
        c0 = None
        if state.c is not None:
            # the carried Ritz block collapses onto the fresh basis slots
            c0 = torch.zeros_like(state.c)
            c0[:nroots, :nroots] = _eye(nroots, c0)
        cm0 = None if state.cm is None else torch.zeros_like(state.cm)
        return DavidsonState(v, w, mask, nroots, state.evals, state.x, state.r,
                             state.errors, c0, cm0)

    return restart


def make_restart(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                 n_p: int = 0):
    return _restart_body(matvec, nroots, m_max, n_p)


def _init_body(matvec: Callable[..., Tensor], nroots: int, m_max: int,
               n_p: int = 0, p_actions: bool = False):
    """Whole state initialisation (fused_davidson.py:570-593): orthonormalise
    the guess block, run its action, and lay out the fixed-capacity stacks."""
    _no_p_space(n_p)

    def init(v0: Tensor, operand) -> DavidsonState:
        _, n = v0.shape
        g = torch.matmul(v0, v0.T)
        l = _cholesky_nan(g + 1e-30 * _eye(nroots, g))
        v0o = torch.linalg.solve_triangular(l, v0, upper=False)
        w0 = matvec(v0o, operand)
        v = torch.zeros((m_max, n), dtype=v0.dtype, device=v0.device)
        v[:nroots] = v0o
        w = torch.zeros_like(v)
        w[:nroots] = w0.to(w.dtype)
        mask = torch.zeros((m_max,), dtype=v0.dtype, device=v0.device)
        mask[:nroots] = 1.0
        # seed evals/x/r/errors with the guess block's honest Rayleigh data
        xx = _dots(v0o, v0o)
        rho = _dots(v0o, w0) / torch.where(xx > 0, xx, torch.ones_like(xx))
        r0 = w0 - rho[:, None] * v0o
        errors = torch.sqrt(torch.abs(_dots(r0, r0)))
        c0 = torch.zeros((m_max, nroots), dtype=v0.dtype, device=v0.device)
        c0[:nroots, :nroots] = _eye(nroots, c0)
        # momentum starts at zero: the whitening drops null columns until a
        # real previous Ritz block exists
        cm0 = torch.zeros_like(c0)
        return DavidsonState(v, w, mask, nroots, rho, v0o, r0, errors, c0, cm0)

    return init


def make_davidson_init(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                       n_p: int = 0, p_actions: bool = False):
    return _init_body(matvec, nroots, m_max, n_p, p_actions)


def _not_converged(s: DavidsonState, tol: float) -> bool:
    # one scalar sync; NaN > tol is False, so a NaN error ends the loop as
    # in the JAX package (check_finite then raises)
    return bool(torch.max(s.errors) > tol)


def make_davidson_solve(
    matvec,
    nroots: int,
    m_max: int,
    tol: Optional[float] = None,
    max_iter: Optional[int] = None,
    null_thresh: float = 1e-10,
    expand: Optional[Callable] = None,
    rr: str = "full",
    history: int = 0,
    fuse_chain: bool = False,
    n_p: int = 0,
    anchor_every: int = 4,
):
    """The whole solve: step until convergence or ``max_iter``, restarting
    whenever the basis fills (fused_davidson.py:603-679).

    Returns ``solve(state, operand, diag, tol, max_iter) -> (final, iters)``;
    passing ``tol`` and ``max_iter`` here binds them instead. ``history > 0``
    also records the max residual norm of each iteration into a
    ``(history,)`` device buffer (NaN beyond the iteration count; the last
    slot keeps the latest value if the solve runs longer) and returns
    ``(final, iters, errors_history)``."""
    step = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every)
    restart = _restart_body(matvec, nroots, m_max, n_p)

    def solve(state: DavidsonState, operand, diag: Tensor, tol_, max_iter_):
        hist = (torch.full((history,), float("nan"), dtype=state.errors.dtype,
                           device=state.errors.device) if history else None)
        s, it = state, 0
        while it < max_iter_ and _not_converged(s, tol_):
            if s.k + nroots > m_max:
                s = restart(s, operand)
            s = step(s, operand, diag, it)
            if history:
                hist[min(it, history - 1)] = torch.max(s.errors)
            it += 1
        if history:
            return s, it, hist
        return s, it

    if tol is None and max_iter is None:
        return solve

    def bound(state, operand, diag):
        return solve(state, operand, diag, tol, max_iter)

    return bound


def make_davidson_solve_chunked(
    matvec,
    nroots: int,
    m_max: int,
    null_thresh: float = 1e-10,
    expand: Optional[Callable] = None,
    rr: str = "full",
    fuse_chain: bool = False,
    n_p: int = 0,
    anchor_every: int = 4,
):
    """Whole solve with the convergence check hoisted to restart boundaries
    (fused_davidson.py:682-734): each trip runs one basis-fill sweep of
    ``(m_max - nroots) // nroots`` steps with no sync between them, after
    collapsing the basis whenever a full sweep would not fit. Iteration
    counts are quantised up to the sweep length."""
    step = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every)
    restart = _restart_body(matvec, nroots, m_max, n_p)
    fill_steps = max(1, (m_max - n_p - nroots) // nroots)

    def solve(state: DavidsonState, operand, diag: Tensor, tol_, max_iter_):
        s, it = state, 0
        while it < max_iter_ and _not_converged(s, tol_):
            if s.k + fill_steps * nroots > m_max:
                s = restart(s, operand)
            # global iteration counter for the anchored cadence
            for i in range(fill_steps):
                s = step(s, operand, diag, it + i)
            it += fill_steps
        return s, it

    return solve


def make_batched_davidson_solve(*args, **kwargs):
    """Many independent eigenproblems in one solve — not ported yet."""
    raise NotImplementedError(_BATCHED)


class FusedDavidson:
    """Driver around the step: the host only checks errors between steps.

    ``device=None`` means CUDA and raises where CUDA is absent; pass
    ``device="cpu"`` for the host (the tests do). ``dtype=None`` is float32
    on CUDA and float64 on the CPU. ``fuse_chain=None`` turns the chain
    kernel on for float32 on CUDA."""

    def __init__(
        self,
        matvec: Callable[..., Tensor],
        diagonals,
        n: int,
        nroots: int = 1,
        m_max: Optional[int] = None,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 200,
        operand=None,
        expand: Optional[Callable] = None,
        matvecs_per_direction: int = 1,
        rr: str = "full",
        fuse_chain: Optional[bool] = None,
        check_symmetric: bool = True,
        p_space=None,
        p_actions=None,
        anchor_every: int = 4,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        if p_space is not None or p_actions is not None:
            raise NotImplementedError(_PSPACE)
        self.device = config.resolve_device(device)
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.n_p = 0
        eff_m_max = m_max if m_max is not None else max(4 * nroots, min(n, 24))
        _validate_rr(rr, nroots, eff_m_max)
        self.matvec = matvec
        self.n = n
        self.nroots = nroots
        self.m_max = eff_m_max
        self.dtype = dtype
        self.sharding = None
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.diag = torch.as_tensor(np.asarray(diagonals), dtype=dtype, device=self.device)
        self.operand = operand
        self.expand = expand
        # matvec count per appended direction
        self.matvecs_per_direction = matvecs_per_direction
        self.rr = rr
        if fuse_chain is None:
            fuse_chain = chain_auto(self.device, dtype)
        self.fuse_chain = fuse_chain
        self.anchor_every = max(1, int(anchor_every))
        self.step = make_davidson_step(matvec, nroots, self.m_max, expand=expand, rr=rr,
                                       fuse_chain=fuse_chain,
                                       anchor_every=self.anchor_every)
        self.restart = make_restart(matvec, nroots, self.m_max)
        self._init = make_davidson_init(matvec, nroots, self.m_max)
        self.iterations = 0
        self.check_symmetric = check_symmetric
        self._symmetry_checked = False
        self.matvecs = 0
        self.n_orig = n   # from_dense_symmetric pads n to the tile multiple

    @classmethod
    def from_dense_symmetric(cls, matrix, nroots: int = 1, tier: Optional[str] = None,
                             b: Optional[int] = None, device=None,
                             **kwargs) -> "FusedDavidson":
        """Build the solver around the packed-triangle symmetric action
        (fused_davidson.py:857-962).

        ``tier`` selects the operator storage (ops/kernels/symm.py):

        - ``"fast"``    bf16 tiles, x rounded to bf16, f32 sums (K1) — a
                        quarter of the dense f32 bytes, ~2^-8 operator
                        accuracy;
        - ``"precise"`` split double-bf16 planes (K3) — f32 bytes, ~2^-16;
        - ``"exact"``   tiles in the working dtype (K1 with f32 tiles on
                        CUDA, the plain f64 action on the CPU).

        Default: "precise" on CUDA, "exact" on the CPU. On the CPU every tier
        runs the plain PyTorch action ("fast" still stores bf16 tiles). The
        matrix is padded to the tile multiple; returned Ritz vectors carry
        the padded width — slice with ``solver.unpad(x)``.
        """
        from ..ops.kernels.symm import (
            SymmetricBlocked,
            SymmetricBlockedSplit,
            symm_matmat_kernel,
            symm_matmat_split_kernel,
        )

        device = config.resolve_device(device)
        matrix = np.asarray(matrix, dtype=np.float64)
        n = matrix.shape[0]
        on_cuda = device.type == "cuda"
        if tier is None:
            tier = "precise" if on_cuda else "exact"
        if tier not in ("fast", "precise", "exact", "int8", "int8_precise"):
            raise ValueError(
                f"unknown tier {tier!r}: use 'fast', 'precise', 'exact', "
                "'int8' or 'int8_precise'")
        if tier in ("int8", "int8_precise"):
            raise NotImplementedError(_INT8)
        dtype = kwargs.get("dtype") or config.default_dtype(device)
        if on_cuda and dtype != torch.float32:
            raise ValueError(f"the CUDA packed kernels run in float32, got dtype={dtype}")
        if b is None:
            # the JAX package's tile rule: b=1024 for the fast tier only
            # when it adds no zero padding over b=512
            b = 512
            if tier == "fast" and -(-n // 1024) * 1024 == -(-n // 512) * 512:
                b = 1024

        if tier == "precise":
            sym = SymmetricBlockedSplit.from_dense(matrix, b=b, device=device)
            operand = (sym.hi, sym.lo, sym.ii, sym.jj)

            def matvec(x, op):
                s = dataclasses.replace(sym, hi=op[0], lo=op[1], ii=op[2], jj=op[3])
                return symm_matmat_split_kernel(x, s)
        else:
            # "fast" stores bf16 tiles on every device so CPU tests see the
            # same operator accuracy the card has
            tile_dtype = torch.bfloat16 if tier == "fast" else config.default_dtype(device)
            sym = SymmetricBlocked.from_dense(matrix, b=b, dtype=tile_dtype, device=device)
            operand = (sym.values, sym.ii, sym.jj)

            def matvec(x, op):
                s = dataclasses.replace(sym, values=op[0], ii=op[1], jj=op[2])
                return symm_matmat_kernel(x, s)

        n_pad = sym.shape[0]
        # padded diagonal entries sit far above the spectrum so
        # diagonal-based guesses never pick the dead coordinates
        diag = np.full(n_pad, np.abs(matrix).sum(axis=1).max() + 1.0)
        diag[:n] = np.diagonal(matrix)
        solver = cls(matvec, diag, n_pad, nroots, operand=operand, device=device, **kwargs)
        solver.n_orig = n
        return solver

    def unpad(self, x) -> np.ndarray:
        """Strip the tile padding from a returned (rows, n_pad) block."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x)[..., : self.n_orig]

    def init_state(self, v0) -> DavidsonState:
        v0 = v0 if isinstance(v0, torch.Tensor) else torch.as_tensor(np.asarray(v0))
        if self.n_orig != self.n and v0.shape[-1] == self.n_orig:
            # pad caller guesses of the unpadded width with zeros
            pad = torch.zeros(v0.shape[:-1] + (self.n - v0.shape[-1],),
                              dtype=v0.dtype, device=v0.device)
            v0 = torch.cat([v0, pad], dim=-1)
        v0 = v0.to(device=self.device, dtype=self.dtype).contiguous()
        if self.check_symmetric and not self._symmetry_checked:
            from ._symmetry import check_symmetric_operator

            check_symmetric_operator(
                self.matvec, self.operand, tuple(v0.shape), self.dtype,
                "FusedDavidson",
                "solvers.linear_eigensystem.LinearEigensystemDavidson"
                "(hermitian=False)",
                device=self.device,
            )
            self._symmetry_checked = True
        state = self._init(v0, self.operand)
        self.matvecs += self.nroots
        return state

    def _finish(self, state: DavidsonState):
        evals, errors = state.evals.cpu().numpy(), state.errors.cpu().numpy()
        check_finite(errors, "FusedDavidson")
        return evals, state.x, errors, self.iterations

    def run(self, v0):
        """Host-driven loop: one step per call, errors fetched each step."""
        state = self.init_state(v0)
        for it in range(self.max_iter):
            if state.k + self.nroots > self.m_max:
                state = self.restart(state, self.operand)
            state = self.step(state, self.operand, self.diag, it)
            self.iterations += 1
            self.matvecs += self.nroots * self.matvecs_per_direction
            if np.all(state.errors.cpu().numpy() <= self.tol):
                break
        return self._finish(state)

    def run_on_device(self, v0, chunked: bool = False):
        """The whole solve (make_davidson_solve). ``chunked=True`` checks
        convergence only at restart boundaries; the iteration count is then
        quantised up to the basis-fill length."""
        kw = dict(expand=self.expand, rr=self.rr, fuse_chain=self.fuse_chain,
                  anchor_every=self.anchor_every)
        if chunked:
            solve = make_davidson_solve_chunked(self.matvec, self.nroots, self.m_max, **kw)
        else:
            solve = make_davidson_solve(self.matvec, self.nroots, self.m_max, **kw)
        state = self.init_state(v0)
        final, iters = solve(state, self.operand, self.diag, self.tol, self.max_iter)
        self.iterations += iters
        self.matvecs += iters * self.nroots * self.matvecs_per_direction
        evals, x, errors, _ = self._finish(final)
        return evals, x, errors, iters

    def run_fast(self, v0, checkpoint_path=None, checkpoint_every: int = 1):
        """Sweep-based driver: fills the basis to capacity per sweep and
        checks convergence only at restart boundaries."""
        if checkpoint_path is not None:
            raise NotImplementedError(_CHECKPOINT)
        state = self.init_state(v0)
        steps = max(1, (self.m_max - self.nroots) // self.nroots)
        sweep = make_davidson_sweep(self.matvec, self.nroots, self.m_max, steps,
                                    expand=self.expand, rr=self.rr,
                                    fuse_chain=self.fuse_chain,
                                    anchor_every=self.anchor_every)
        max_sweeps = max(1, self.max_iter // steps + 1)
        for sweeps_done in range(max_sweeps):
            state = sweep(state, self.operand, self.diag, sweeps_done * steps)
            self.iterations += steps
            self.matvecs += steps * self.nroots * self.matvecs_per_direction
            errors = state.errors.cpu().numpy()
            if np.all(errors <= self.tol) or self.iterations >= self.max_iter:
                break
            state = self.restart(state, self.operand)
        return self._finish(state)

    def resume_fast(self, checkpoint_path: str, keep_checkpointing=True,
                    checkpoint_every: int = 1):
        raise NotImplementedError(_CHECKPOINT)
