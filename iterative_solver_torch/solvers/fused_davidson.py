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
- The batched solve runs the same step under ``torch.func.vmap``, so the
  stacks are built without writing a batched block into an unbatched one.

Sharding (``sharding=``, parallel/mesh.py) runs one process per shard of
the vector axis N (SPMD): every (rows, N) tensor of the state is this
rank's slice, the matvec maps a rank's slice of x to its slice of y, and
every contraction over N (the Rayleigh matrix, the dots, the Gram-Schmidt
projections, the restart and whitening Grams) and the max of the diagonal
is all-reduced, where GSPMD inserts a psum in the JAX package. The host's
decisions (convergence, restart, keep masks) read only all-reduced values,
so every rank takes the same branch. The chain kernel stays off under
sharding, as the JAX package fuses the chain only when ``sharding is None``
(fused_davidson.py:839-844). A solve takes the same global guess on every
rank and returns replicated eigenvalues and errors and the gathered Ritz
vectors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops.kernels.chain import (
    _cholesky_nan,
    chain_auto,
    fused_expand_chain,
    lower_solve,
    whiten_after_chain,
)
from ..array.vector_ops import to_device
from ..parallel.collectives import barrier, pmax, psum
from ..parallel.mesh import check_sharding
from ._finite import check_finite

Tensor = torch.Tensor


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


def densify_p_space(p_space, n: int) -> np.ndarray:
    """(n_p, n) f64 dense rows from sparse P vectors (fused_davidson.py:51-85).

    Accepts the parity tier's representation (a sequence of ``{index:
    value}`` dicts, reference Pvector = std::map<size_t, double>,
    IterativeSolver.h:131-151), ``(indices, values)`` pairs, or an
    already-dense (n_p, <=n) array (right-padded with zeros — the
    from_dense_symmetric tile padding case)."""
    if hasattr(p_space, "shape") or (
            len(p_space) and hasattr(p_space[0], "shape")
            and np.asarray(p_space[0]).ndim >= 1
            and not isinstance(p_space[0], (tuple, list))):
        arr = np.atleast_2d(np.asarray(p_space, dtype=np.float64))
        if arr.ndim != 2 or arr.shape[1] > n:
            raise ValueError(
                f"dense p_space must be (n_p, <=n), got {arr.shape}")
        rows = np.zeros((arr.shape[0], n))
        rows[:, : arr.shape[1]] = arr
    else:
        rows = np.zeros((len(p_space), n))
        for i, p in enumerate(p_space):
            if isinstance(p, dict):
                for j, val in p.items():
                    rows[i, int(j)] = float(val)
            else:
                idx, vals = p
                rows[i, np.asarray(idx, dtype=np.int64)] = np.asarray(
                    vals, dtype=np.float64)
    # an all-zero P row would Cholesky-whiten the singular P Gram into a
    # garbage basis row that stays live forever: refuse it in both forms
    if not rows.size or not np.all(np.any(rows != 0.0, axis=1)):
        raise ValueError("every P vector must be nonzero")
    return rows


def validate_p_inputs(p_space, p_actions, n: int):
    """Constructor-side P-space handling shared by FusedDavidson and
    FusedLinearEquations (fused_davidson.py:88-108): densify, validate the
    action rows (shape and rank), right-pad. Returns ``(p_dense, n_p,
    p_action_rows)``."""
    if p_space is None:
        if p_actions is not None:
            raise ValueError("p_actions requires p_space")
        return None, 0, None
    p_dense = densify_p_space(p_space, n)
    n_p = p_dense.shape[0]
    p_action_rows = None
    if p_actions is not None:
        pa = np.atleast_2d(np.asarray(p_actions, dtype=np.float64))
        if pa.ndim != 2 or pa.shape[0] != n_p or pa.shape[1] > n:
            raise ValueError(
                f"p_actions must be (n_p, <=n) action rows, got "
                f"{np.asarray(p_actions).shape} for n_p={n_p}, n={n}")
        p_action_rows = np.zeros((n_p, n))
        p_action_rows[:, :pa.shape[1]] = pa
    return p_dense, n_p, p_action_rows


def _dots(a: Tensor, b: Tensor, sharding=None) -> Tensor:
    return psum(torch.einsum("in,in->i", a, b), sharding)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _stack_rows(blocks, rows: int) -> Tensor:
    """``blocks`` one under the other, zero rows below up to ``rows``: the
    fixed-capacity layout of a stack, built without writing a block into a
    zero tensor (which ``torch.func.vmap`` refuses for a batched block)."""
    head = torch.cat(blocks, dim=0)
    pad = head.new_zeros((rows - head.shape[0],) + tuple(head.shape[1:]))
    return torch.cat([head, pad], dim=0)


def _zero_rows(c: Tensor, n_p: int) -> Tensor:
    """``c`` with its first ``n_p`` rows zeroed (the projection against the
    P slots, which are unit coordinates)."""
    return torch.cat([c.new_zeros((n_p,) + tuple(c.shape[1:])), c[n_p:]], dim=0)


def _p_project(x: Tensor, pv: Tensor, sharding=None) -> Tensor:
    """Two classical Gram-Schmidt passes of the rows of ``x`` against the
    orthonormal rows ``pv``."""
    for _ in range(2):
        x = x - torch.matmul(psum(torch.matmul(x, pv.T), sharding), pv)
    return x


def _masked_eigh(v, w, mask, sharding=None):
    """Rayleigh matrix over active slots; inactive diagonals pushed just
    above the active spectrum so their eigenpairs sort last. The pad value
    tracks the matrix scale (a huge constant would wreck a float32 eigh).
    The JAX package promotes this eigh to f64 wherever f64 is native (every
    backend but the TPU); the port does so on the CPU and on CUDA."""
    h = psum(torch.matmul(v, w.T), sharding)
    h = 0.5 * (h + h.T)
    h = h * (mask[:, None] * mask[None, :])
    big = 4.0 * torch.max(torch.abs(h)) + 1.0
    dead = 1.0 - mask
    h = h + dead[:, None] * dead[None, :] * _eye(h.shape[0], h) * big
    if h.dtype != torch.float64:
        evals, c = torch.linalg.eigh(h.to(torch.float64))
        return evals.to(h.dtype), c.to(h.dtype)
    return torch.linalg.eigh(h)


def _eigh_whiten_cols(p, thresh: float = 1e-8, sharding=None):
    """Orthonormalise the columns of a coefficient block via its Gram
    eigendecomposition, dropping null directions. Returns ``(p_white, keep)``.
    ``sharding``: the rows of ``p`` are this rank's slice of N."""
    g = psum(torch.matmul(p.T, p), sharding)
    g = 0.5 * (g + g.T)
    gw, gu = torch.linalg.eigh(g)
    keep = gw > thresh
    scale = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, gw, torch.ones_like(gw))),
                        torch.zeros_like(gw))
    return torch.matmul(p, gu * scale[None, :]), keep


def _window_rr(v, w, mask, k: int, c_prev, nroots: int, m_max: int, c_mom=None,
               n_p: int = 0, sharding=None):
    """Locally-optimal window Rayleigh-Ritz (fused_davidson.py:149-244):
    diagonalise H over span[c_prev | newest appended block] (2r) — plus an
    eigh-whitened momentum group (3r) when ``c_mom`` is given — instead of
    the full m-dim basis. The newest block's slots are orthonormal to
    everything older, so the window basis is orthonormal by construction.

    ``n_p > 0`` prepends the frozen P slots [0, n_p) as an exact one-hot
    group, so every window spans the whole P space (an (n_p + 2r) eigh);
    the carried block is projected against P (its first n_p rows zeroed)
    and eigh-whitened, since Ritz vectors can grow dominant P components.
    Returns ``(evals[:nroots], c_new, evals_all padded to (m_max,))``."""
    dtype, dev = v.dtype, v.device
    h = psum(torch.matmul(v, w.T), sharding)
    h = 0.5 * (h + h.T)
    h = h * (mask[:, None] * mask[None, :])

    groups, keeps = [], []
    if n_p:
        groups.append(_stack_rows([_eye(n_p, h)], m_max))
        keeps.append(torch.ones((n_p,), dtype=torch.bool, device=dev))
        cp, keep_c = _eigh_whiten_cols(_zero_rows(c_prev, n_p))
    else:
        cp, keep_c = c_prev, torch.ones((nroots,), dtype=torch.bool, device=dev)
    # one-hot columns for the newest block's slots [k-r, k), masked by slot
    # validity (appends dropped as null keep mask 0 and must not enter W);
    # with n_p > 0 these slots lie at or above n_p, orthogonal to the P group
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
    groups += [cp, e]
    keeps += [keep_c, keep]

    if c_mom is not None:
        # momentum group: previous-step Ritz block, projected against the
        # earlier groups then eigh-whitened
        p = _zero_rows(c_mom, n_p) if n_p else c_mom
        p = p - torch.matmul(cp, torch.matmul(cp.T, p))
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
    padded = torch.cat([clean, clean.new_full((m_max - nw,), -float("inf"))])
    return evals_all[:nroots], c_new, padded


def _validate_rr(rr: str, nroots: int, m_max: int, n_p: int = 0) -> None:
    width = {"full": 1, "window": 2, "window3": 3, "anchored": 2}.get(rr)
    if width is None:
        raise ValueError(f"unknown rr mode {rr!r}: use 'full', 'window', "
                         "'window3' or 'anchored'")
    # every mode needs room for the carried block PLUS one full append PLUS
    # the frozen P slots
    if max(2, width) * nroots + n_p > m_max:
        raise ValueError(
            f"rr={rr!r} needs m_max >= {max(2, width)}*nroots + n_p "
            f"({max(2, width) * nroots + n_p}), got {m_max}")


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
    sharding=None,
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
    kernel call (ops/kernels/chain.py).

    ``n_p > 0`` marks the leading n_p stack slots as a frozen, densified P
    space (IterativeSolver.h:131-151): appends (at k >= n_p + nroots) and
    restarts never touch them, the RR sees them through the mask, and the
    window RR carries them as an exact group.

    ``sharding``: the stacks, blocks and diagonal are this rank's slices of
    N and every contraction over N is all-reduced (no chain kernel)."""
    _validate_rr(rr, nroots, m_max, n_p)
    if fuse_chain and sharding is not None:
        raise ValueError("the chain kernel is single-device: fuse_chain=True "
                         "cannot run under sharding")
    sh = sharding

    def step(state: DavidsonState, operand, diag: Tensor, it: int = 0) -> DavidsonState:
        v, w, mask, k = state.v, state.w, state.mask, state.k
        if rr in ("window", "window3", "anchored"):
            if rr == "anchored" and it % anchor_every == 0:
                ea, c = _masked_eigh(v, w, mask, sh)
                evals, c_new, evals_all = ea[:nroots], c[:, :nroots] * mask[:, None], ea
            else:
                evals, c_new, evals_all = _window_rr(
                    v, w, mask, k, state.c, nroots, m_max,
                    c_mom=state.cm if rr == "window3" else None, n_p=n_p, sharding=sh)
            coeff = c_new.T
        else:
            evals_all, c = _masked_eigh(v, w, mask, sh)
            coeff = (c[:, :nroots] * mask[:, None]).T  # (nroots, m_max)
            evals = evals_all[:nroots]
            c_new = coeff.T
        x = torch.matmul(coeff, v)
        ax = torch.matmul(coeff, w)
        # Rayleigh-quotient refinement: full-length dots are ~eps*||A||
        # accurate, recovering eigenvalue accuracy the small eigh may lack
        xx = _dots(x, x, sh)
        xax = _dots(x, ax, sh)
        evals = torch.where(xx > 0, xax / torch.where(xx > 0, xx, torch.ones_like(xx)), evals)
        r = ax - evals[:, None] * x
        errors = torch.sqrt(torch.abs(_dots(r, r, sh)))

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
                scale_est = pmax(torch.max(torch.abs(diag)), sh) + torch.max(torch.abs(evals))
                t = r / (diag[None, :] - evals[:, None] + 1e-15 * scale_est + 1e-300)
            else:
                t = expand(x, r, evals, evals_all, mask, diag, operand)
            # null detection compares post-GS norms to the PRE-GS norms
            n0_2 = _dots(t, t, sh)
            # two classical GS passes against the basis
            for _ in range(2):
                proj = psum(torch.matmul(t, v.T), sh) * mask[None, :]
                t = t - torch.matmul(proj, v)
            n2 = _dots(t, t, sh)
            t, keep = whiten_after_chain(t, n0_2, n2, nroots, null_thresh, sharding=sh)

        # append at slot k, in place; never over the frozen P slots
        if k + nroots > m_max or k < n_p:
            raise ValueError(f"append at slot {k} outside [{n_p}, {m_max}]")
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
                       anchor_every: int = 4, sharding=None):
    """Single iteration: ``step(state, operand, diag, it=0) -> state``."""
    return _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every, sharding)


def make_davidson_sweep(matvec, nroots: int, m_max: int, steps: int,
                        null_thresh: float = 1e-10,
                        expand: Optional[Callable] = None, rr: str = "full",
                        fuse_chain: bool = False, n_p: int = 0,
                        anchor_every: int = 4, sharding=None):
    """``steps`` Davidson iterations with no convergence check between them:
    ``sweep(state, operand, diag, it0=0)``; ``it0`` is the global iteration
    offset, so the anchored cadence does not reset at sweep boundaries."""
    body = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every, sharding)

    def sweep(state: DavidsonState, operand, diag: Tensor, it0: int = 0) -> DavidsonState:
        for i in range(steps):
            state = body(state, operand, diag, it0 + i)
        return state

    return sweep


def _restart_body(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                  n_p: int = 0, sharding=None):
    """Collapse the basis onto the current Ritz vectors (DSpaceResetter
    analogue, fused_davidson.py:433-491). With ``n_p > 0`` the frozen P
    slots survive untouched (basis and action rows: no operator
    application) and the Ritz block is orthogonalised against them; a Ritz
    vector that has converged into the P span projects to (near) zero and
    its slot restarts dead (eigh-whitening with null-drop)."""
    sh = sharding

    def restart_p(state: DavidsonState, operand) -> DavidsonState:
        pv, pw = state.v[:n_p], state.w[:n_p]
        pc = psum(torch.matmul(state.x, pv.T), sh)  # (r, n_p) P coordinates
        x = _p_project(state.x, pv, sh)
        xo_t, keep = _eigh_whiten_cols(x.T, thresh=1e-10, sharding=sh)
        xo = xo_t.T
        live = keep.to(state.mask.dtype)
        v = _stack_rows([pv, xo.to(pv.dtype)], m_max)
        w = _stack_rows([pw, (matvec(xo, operand) * live[:, None]).to(pw.dtype)], m_max)
        mask = _stack_rows([live.new_ones((n_p,)), live], m_max)
        c0 = None
        if state.c is not None:
            # exact coordinates of the outgoing Ritz block in the fresh
            # basis: P components, then whitened-complement components
            c0 = _stack_rows([pc.T, psum(torch.matmul(xo, x.T), sh)], m_max)
        cm0 = None if state.cm is None else torch.zeros_like(state.cm)
        return DavidsonState(v, w, mask, n_p + nroots, state.evals, state.x, state.r,
                             state.errors, c0, cm0)

    if n_p:
        return restart_p

    def restart(state: DavidsonState, operand) -> DavidsonState:
        x = state.x
        g = psum(torch.matmul(x, x.T), sh)
        l = _cholesky_nan(g + 1e-30 * _eye(nroots, g))
        xo = lower_solve(l, x)
        v = _stack_rows([xo.to(state.v.dtype)], m_max)
        w = _stack_rows([matvec(xo, operand).to(state.w.dtype)], m_max)
        mask = _stack_rows([torch.ones_like(state.mask[:nroots])], m_max)
        c0 = None
        if state.c is not None:
            # the carried Ritz block collapses onto the fresh basis slots
            c0 = _stack_rows([_eye(nroots, state.c)], m_max)
        cm0 = None if state.cm is None else torch.zeros_like(state.cm)
        return DavidsonState(v, w, mask, nroots, state.evals, state.x, state.r,
                             state.errors, c0, cm0)

    return restart


def make_restart(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                 n_p: int = 0, sharding=None):
    return _restart_body(matvec, nroots, m_max, n_p, sharding)


def _init_body(matvec: Callable[..., Tensor], nroots: int, m_max: int,
               n_p: int = 0, p_actions: bool = False, sharding=None):
    """Whole state initialisation (fused_davidson.py:502-593): orthonormalise
    the guess block, run its action, and lay out the fixed-capacity stacks.

    ``n_p > 0``: the init takes two more arguments, ``p`` (n_p, N)
    densified P rows and ``wp`` their action rows. The P block is
    Cholesky-whitened and frozen into slots [0, n_p); the guess block is
    Gram-Schmidted against it. With ``p_actions=True`` ``wp`` holds the
    caller's exact action rows, mapped through the same whitening
    (``lower_solve``: L⁻¹ as one matmul); otherwise the operator computes
    them and ``wp`` is ignored."""
    sh = sharding

    def init_p(v0: Tensor, operand, p: Tensor, wp: Tensor) -> DavidsonState:
        gp = psum(torch.matmul(p, p.T), sh)
        lp = _cholesky_nan(gp + 1e-30 * _eye(n_p, gp))
        pw = lower_solve(lp, p)
        wpw = lower_solve(lp, wp) if p_actions else matvec(pw, operand)
        v0 = _p_project(v0, pw, sh)
        # guesses fully inside the P span project to zero: eigh-whitening
        # drops them as dead slots instead of NaN-ing a Cholesky
        v0o_t, keep = _eigh_whiten_cols(v0.T, thresh=1e-10, sharding=sh)
        v0o = v0o_t.T
        live = keep.to(v0.dtype)
        w0 = matvec(v0o, operand) * live[:, None]
        v = _stack_rows([pw.to(v0.dtype), v0o], m_max)
        w = _stack_rows([wpw.to(v0.dtype), w0.to(v0.dtype)], m_max)
        mask = _stack_rows([live.new_ones((n_p,)), live], m_max)
        xx = _dots(v0o, v0o, sh)
        rho = _dots(v0o, w0, sh) / torch.where(xx > 0, xx, torch.ones_like(xx))
        r0 = w0 - rho[:, None] * v0o
        errors = torch.sqrt(torch.abs(_dots(r0, r0, sh)))
        # a guess swallowed by the P span has a ZERO seed residual: that is
        # "untested", not "converged" (the solve would exit before its first
        # RR). Dead slots seed at inf; the first step replaces them.
        errors = torch.where(live > 0, errors, torch.full_like(errors, float("inf")))
        c0 = _stack_rows([torch.zeros((n_p, nroots), dtype=v0.dtype, device=v0.device),
                          _eye(nroots, v0) * live[:, None]], m_max)
        cm0 = torch.zeros_like(c0)
        return DavidsonState(v, w, mask, n_p + nroots, rho, v0o, r0, errors, c0, cm0)

    if n_p:
        return init_p

    def init(v0: Tensor, operand) -> DavidsonState:
        g = psum(torch.matmul(v0, v0.T), sh)
        l = _cholesky_nan(g + 1e-30 * _eye(nroots, g))
        v0o = lower_solve(l, v0)
        w0 = matvec(v0o, operand)
        v = _stack_rows([v0o], m_max)
        w = _stack_rows([w0.to(v0.dtype)], m_max)
        mask = _stack_rows([torch.ones_like(v0o[:, 0])], m_max)
        # seed evals/x/r/errors with the guess block's honest Rayleigh data
        xx = _dots(v0o, v0o, sh)
        rho = _dots(v0o, w0, sh) / torch.where(xx > 0, xx, torch.ones_like(xx))
        r0 = w0 - rho[:, None] * v0o
        errors = torch.sqrt(torch.abs(_dots(r0, r0, sh)))
        c0 = _stack_rows([_eye(nroots, v0)], m_max)
        # momentum starts at zero: the whitening drops null columns until a
        # real previous Ritz block exists
        cm0 = torch.zeros_like(c0)
        return DavidsonState(v, w, mask, nroots, rho, v0o, r0, errors, c0, cm0)

    return init


def make_davidson_init(matvec: Callable[..., Tensor], nroots: int, m_max: int,
                       n_p: int = 0, p_actions: bool = False, sharding=None):
    return _init_body(matvec, nroots, m_max, n_p, p_actions, sharding)


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
    sharding=None,
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
                      fuse_chain, n_p, anchor_every, sharding)
    restart = _restart_body(matvec, nroots, m_max, n_p, sharding)

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
    sharding=None,
):
    """Whole solve with the convergence check hoisted to restart boundaries
    (fused_davidson.py:682-734): each trip runs one basis-fill sweep of
    ``(m_max - nroots) // nroots`` steps with no sync between them, after
    collapsing the basis whenever a full sweep would not fit. Iteration
    counts are quantised up to the sweep length."""
    step = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      fuse_chain, n_p, anchor_every, sharding)
    restart = _restart_body(matvec, nroots, m_max, n_p, sharding)
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


_TENSOR_FIELDS = ("v", "w", "mask", "evals", "x", "r", "errors", "c", "cm")


def _batched(fn, k: int):
    """``fn(state, *args) -> state`` over a leading batch axis of every
    tensor field and argument, through ``torch.func.vmap``; every element
    shares the host slot count ``k``. Returns the batched tensor fields."""
    def inner(fields, *args):
        out = fn(DavidsonState(k=k, **dict(zip(_TENSOR_FIELDS, fields))), *args)
        return tuple(getattr(out, f) for f in _TENSOR_FIELDS)

    return torch.func.vmap(inner)


def make_batched_davidson_solve(
    matvec,
    nroots: int,
    m_max: int,
    null_thresh: float = 1e-10,
    expand: Optional[Callable] = None,
    rr: str = "full",
    anchor_every: int = 4,
):
    """Many independent eigenproblems over a leading batch axis
    (fused_davidson.py:737-777): a parameter scan of B small systems runs
    each operation once for the batch instead of B times. Returns
    ``(batched_init, batched_solve)``:

        states = batched_init(v0_batch, operand_batch)   # (B, r, N), (B, ...)
        final, iters = batched_solve(states, operand_batch, diag_batch, tol, max_iter)

    The step, restart and init are the single solve's, run under
    ``torch.func.vmap``: every tensor is batched (batched matmuls and
    eighs), never a Python loop over the B systems. Like the chunked solve
    each trip runs one basis-fill sweep, so each element's iteration count
    is quantised to the sweep length; the trip runs on the elements still
    active (not converged, under ``max_iter``), which share their slot
    count and iteration counter, and converged elements hold their state.
    ``final`` carries the batch axis on every tensor field and ``k`` as a
    tuple of host ints; ``iters`` is a (B,) int64 tensor.

    The matvec must be vmap-compatible: a dense product such as
    ``torch.matmul(x, op.T)`` on a (B, N, N) operand. The packed kernel
    wrappers are not (as the Pallas kernels are not under ``jax.vmap``)."""
    _validate_rr(rr, nroots, m_max)
    step = _step_body(matvec, nroots, m_max, null_thresh, expand, rr,
                      anchor_every=anchor_every)
    restart = _restart_body(matvec, nroots, m_max)
    init = _init_body(matvec, nroots, m_max)
    fill_steps = max(1, (m_max - nroots) // nroots)

    def batched_init(v0: Tensor, operand) -> DavidsonState:
        def inner(v0_, op_):
            out = init(v0_, op_)
            return tuple(getattr(out, f) for f in _TENSOR_FIELDS)

        fields = torch.func.vmap(inner)(v0, operand)
        return DavidsonState(k=(nroots,) * v0.shape[0], **dict(zip(_TENSOR_FIELDS, fields)))

    def batched_solve(state: DavidsonState, operand, diag: Tensor, tol_, max_iter_):
        # own copies: the trips write the active elements back into them
        fields = [getattr(state, f).clone() for f in _TENSOR_FIELDS]
        nb = fields[0].shape[0]
        ks, its = list(state.k), [0] * nb
        while True:
            # one host sync per trip: which elements go on
            errs = torch.amax(fields[6], dim=1).cpu().numpy()
            active = [b for b in range(nb) if its[b] < max_iter_ and errs[b] > tol_]
            if not active:
                break
            k, it = ks[active[0]], its[active[0]]
            idx = torch.as_tensor(active, device=fields[0].device)
            sub = [f.index_select(0, idx) for f in fields]
            op = operand.index_select(0, idx)
            dg = diag.index_select(0, idx)
            if k + fill_steps * nroots > m_max:
                sub = _batched(restart, k)(sub, op)
                k = nroots
            for i in range(fill_steps):
                sub = _batched(lambda s_, o_, d_: step(s_, o_, d_, it + i), k)(sub, op, dg)
                k += nroots
            for f, new in zip(fields, sub):
                f.index_copy_(0, idx, new)
            for b in active:
                ks[b], its[b] = k, it + fill_steps
        final = DavidsonState(k=tuple(ks), **dict(zip(_TENSOR_FIELDS, fields)))
        return final, torch.as_tensor(its, dtype=torch.int64)

    return batched_init, batched_solve


TIERS = ("fast", "precise", "exact", "int8", "int8_precise")


def _check_tier(tier: Optional[str], device, dtype) -> str:
    """The tier, "precise" on CUDA and "exact" on the CPU by default; the
    CUDA packed kernels take float32 only."""
    on_cuda = device.type == "cuda"
    if tier is None:
        tier = "precise" if on_cuda else "exact"
    if tier not in TIERS:
        raise ValueError(
            f"unknown tier {tier!r}: use 'fast', 'precise', 'exact', "
            "'int8' or 'int8_precise'")
    dtype = dtype or config.default_dtype(device)
    if on_cuda and dtype != torch.float32:
        raise ValueError(f"the CUDA packed kernels run in float32, got dtype={dtype}")
    return tier


def packed_storage(matrix: np.ndarray, tier: str, b: int, device, dtype=None):
    """``tier``'s packed storage of ``matrix`` at tile size ``b``: "fast"
    bf16 tiles (K1), "precise" split bf16 planes (K3), "exact" tiles in
    ``dtype`` (default: the device's working dtype; K1 f32 on CUDA),
    "int8"/"int8_precise" one or two int8 planes (K4, K5). "fast" stores
    bf16 tiles on every device, so CPU tests see the operator accuracy the
    card has."""
    from ..ops.kernels.symm import SymmetricBlocked, SymmetricBlockedSplit
    from ..ops.kernels.symm_int8 import SymmetricBlockedInt8, SymmetricBlockedInt8Split

    if tier in ("int8", "int8_precise"):
        cls = SymmetricBlockedInt8Split if tier == "int8_precise" else SymmetricBlockedInt8
        return cls.from_dense(matrix, b=b, device=device)
    if tier == "precise":
        return SymmetricBlockedSplit.from_dense(matrix, b=b, device=device)
    tile_dtype = torch.bfloat16 if tier == "fast" else dtype or config.default_dtype(device)
    return SymmetricBlocked.from_dense(matrix, b=b, dtype=tile_dtype, device=device)


def packed_symmetric_action(matrix: np.ndarray, tier: str, b: int, device,
                            sharding=None):
    """``(matvec, operand, sym)`` of the packed-triangle symmetric action of
    ``matrix`` in ``tier``'s storage (``packed_storage``), shared by
    FusedDavidson and FusedLinearEquations; ``matvec`` runs the storage's
    kernel wrapper (``symm.packed_matvec``).

    With ``sharding`` the storage is packed on the host (the "exact" tiles
    in the rank's working dtype) and each rank keeps its round-robin share
    of the tile pairs (parallel/sharded_symm.py): ``matvec`` maps a rank's
    slice of x to its slice of y and ``sym`` is the ShardedSymmetric."""
    if sharding is not None:
        from ..parallel.sharded_symm import ShardedSymmetric

        host = packed_storage(matrix, tier, b, "cpu", dtype=config.default_dtype(device))
        ssym = ShardedSymmetric.from_storage(host, sharding.mesh)
        return (*ssym.matvec_fn(), ssym)
    from ..ops.kernels.symm import packed_matvec

    sym = packed_storage(matrix, tier, b, device)
    return (*packed_matvec(sym), sym)


class FusedDavidson:
    """Driver around the step: the host only checks errors between steps.

    ``device=None`` means CUDA and raises where CUDA is absent; pass
    ``device="cpu"`` for the host (the tests do). ``dtype=None`` is float32
    on CUDA and float64 on the CPU. ``fuse_chain=None`` turns the chain
    kernel on for float32 on CUDA.

    ``sharding`` (parallel/mesh.py, e.g. ``block_sharding(mesh)``): every
    rank of the mesh builds the solver with the same arguments and a matvec
    that maps its slice of x to its slice of y; ``diagonals`` (and the P
    space) are global and each rank keeps its slice; the device is the
    mesh's."""

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
        self.sharding = check_sharding(sharding)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.p_dense, self.n_p, self.p_action_rows = validate_p_inputs(
            p_space, p_actions, n)
        self._p_dev = None
        eff_m_max = m_max if m_max is not None else max(
            4 * nroots + self.n_p, min(n, 24))
        _validate_rr(rr, nroots, eff_m_max, self.n_p)
        self.matvec = matvec
        self.n = n
        self.nroots = nroots
        self.m_max = eff_m_max
        self.dtype = dtype
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.diag = to_device(np.array(diagonals), dtype, self.device, self.sharding)
        self.operand = operand
        self.expand = expand
        # matvec count per appended direction
        self.matvecs_per_direction = matvecs_per_direction
        self.rr = rr
        if fuse_chain is None:
            # the chain kernel is single-device: off under sharding
            fuse_chain = self.sharding is None and chain_auto(self.device, dtype)
        self.fuse_chain = fuse_chain
        self.anchor_every = max(1, int(anchor_every))
        self.step = make_davidson_step(matvec, nroots, self.m_max, expand=expand, rr=rr,
                                       fuse_chain=fuse_chain, n_p=self.n_p,
                                       anchor_every=self.anchor_every,
                                       sharding=self.sharding)
        self.restart = make_restart(matvec, nroots, self.m_max, n_p=self.n_p,
                                    sharding=self.sharding)
        self._init = make_davidson_init(
            matvec, nroots, self.m_max, n_p=self.n_p,
            p_actions=self.n_p > 0 and self.p_action_rows is not None,
            sharding=self.sharding)
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
                        CUDA, the plain f64 action on the CPU);
        - ``"int8"``    one quantized plane plus the exact diagonal
                        (ops/kernels/symm_int8.py, K4) — half the bf16
                        tier's bytes, the bf16 residual-floor class;
        - ``"int8_precise"`` two quantized planes (K5) — the "precise"
                        accuracy class (~2^-16) at half its bytes.

        Default: "precise" on CUDA, "exact" on the CPU. On the CPU every tier
        runs the plain PyTorch action ("fast" still stores bf16 tiles, and
        the int8 tiers quantize and compute their action in float32, as the
        JAX package does off the TPU). The matrix is padded to the tile
        multiple; returned Ritz vectors carry the padded width — slice with
        ``solver.unpad(x)``.
        """
        sharding = check_sharding(kwargs.get("sharding"))
        device = sharding.mesh.device if sharding is not None else config.resolve_device(device)
        matrix = np.asarray(matrix, dtype=np.float64)
        n = matrix.shape[0]
        tier = _check_tier(tier, device, kwargs.get("dtype"))
        if b is None:
            # the JAX package's tile rule: b=1024 for the fast and int8
            # tiers only when it adds no zero padding over b=512
            b = 512
            if (tier in ("fast", "int8", "int8_precise")
                    and -(-n // 1024) * 1024 == -(-n // 512) * 512):
                b = 1024
        matvec, operand, sym = packed_symmetric_action(matrix, tier, b, device, sharding)
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

    def _global(self, t: Tensor) -> Tensor:
        """A (..., n) block of the state, whole: gathered under sharding."""
        return t if self.sharding is None else self.sharding.gather(t, self.n)

    def init_state(self, v0) -> DavidsonState:
        v0 = v0 if isinstance(v0, torch.Tensor) else torch.as_tensor(np.asarray(v0))
        if self.n_orig != self.n and v0.shape[-1] == self.n_orig:
            # pad caller guesses of the unpadded width with zeros
            pad = torch.zeros(v0.shape[:-1] + (self.n - v0.shape[-1],),
                              dtype=v0.dtype, device=v0.device)
            v0 = torch.cat([v0, pad], dim=-1)
        v0 = to_device(v0, self.dtype, self.device, self.sharding).contiguous()
        if self.check_symmetric and not self._symmetry_checked:
            from ._symmetry import check_symmetric_operator

            check_symmetric_operator(
                self.matvec, self.operand, (v0.shape[0], self.n), self.dtype,
                "FusedDavidson",
                "solvers.linear_eigensystem.LinearEigensystemDavidson"
                "(hermitian=False)",
                device=self.device,
                sharding=self.sharding,
            )
            self._symmetry_checked = True
        if self.n_p:
            if self._p_dev is None:
                p = to_device(self.p_dense, self.dtype, self.device, self.sharding)
                wp = (to_device(self.p_action_rows, self.dtype, self.device, self.sharding)
                      if self.p_action_rows is not None else torch.zeros_like(p))
                self._p_dev = (p, wp)
            state = self._init(v0, self.operand, *self._p_dev)
        else:
            state = self._init(v0, self.operand)
        self.matvecs += self.nroots
        return state

    def _finish(self, state: DavidsonState):
        evals, errors = state.evals.cpu().numpy(), state.errors.cpu().numpy()
        check_finite(errors, "FusedDavidson")
        return evals, self._global(state.x), errors, self.iterations

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
                  n_p=self.n_p, anchor_every=self.anchor_every, sharding=self.sharding)
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
        checks convergence only at restart boundaries.

        ``checkpoint_path`` persists the DavidsonState every
        ``checkpoint_every`` sweeps (utils/checkpoint.py; ``.npz``, or HDF5
        for ``.h5``/``.hdf5``); continue an interrupted run with
        :meth:`resume_fast`."""
        state = self.init_state(v0)
        return self._drive_sweeps(state, checkpoint_path, checkpoint_every)

    def resume_fast(self, checkpoint_path: str, keep_checkpointing=True,
                    checkpoint_every: int = 1):
        """Continue a run_fast interrupted after a checkpoint
        (fused_davidson.py:1095-1138): restores the iteration and matvec
        counters and, by default, keeps checkpointing to the same path.
        A checkpoint written by the JAX package loads here, and the other
        way round. Under sharding every rank reads the file and keeps its
        slices."""
        from ..utils.checkpoint import load_fused_state

        state, meta = load_fused_state(checkpoint_path, sharding=self.sharding,
                                       dtype=self.dtype, device=self.device)
        width = self.n if self.sharding is None else self.diag.shape[-1]
        if tuple(state.v.shape) != (self.m_max, width):
            raise ValueError(
                f"checkpoint stacks are {tuple(state.v.shape)} but this "
                f"solver is configured (m_max={self.m_max}, n={self.n})")
        # equal shapes can still mean another solver: an nroots mismatch
        # breaks the carried blocks, and an n_p mismatch would silently
        # reinterpret frozen P slots as ordinary basis rows
        for field, mine in (("nroots", self.nroots), ("n_p", self.n_p),
                            ("rr", self.rr)):
            if field in meta and meta[field] != mine:
                raise ValueError(
                    f"checkpoint was written with {field}={meta[field]!r} "
                    f"but this solver has {field}={mine!r}")
        self.iterations = int(meta.get("iterations", self.iterations))
        self.matvecs = int(meta.get("matvecs", self.matvecs))
        # checkpoints are saved after a sweep, with the basis at capacity:
        # restart before the next sweep as run_fast's own loop does (an
        # append past capacity would otherwise raise here, and clamp onto
        # live rows in the JAX package). Skip the sweep entirely when the
        # checkpoint is already converged or out of budget.
        errors = state.errors.cpu().numpy()
        if np.all(errors <= self.tol) or self.iterations >= self.max_iter:
            return self._finish(state)
        if state.k + self.nroots > self.m_max:
            state = self.restart(state, self.operand)
        return self._drive_sweeps(
            state, checkpoint_path if keep_checkpointing else None,
            checkpoint_every)

    def _drive_sweeps(self, state, checkpoint_path, checkpoint_every):
        steps = max(1, (self.m_max - self.n_p - self.nroots) // self.nroots)
        sweep = make_davidson_sweep(self.matvec, self.nroots, self.m_max, steps,
                                    expand=self.expand, rr=self.rr,
                                    fuse_chain=self.fuse_chain, n_p=self.n_p,
                                    anchor_every=self.anchor_every,
                                    sharding=self.sharding)
        max_sweeps = max(1, self.max_iter // steps + 1)
        for sweeps_done in range(1, max_sweeps + 1):
            state = sweep(state, self.operand, self.diag, (sweeps_done - 1) * steps)
            self.iterations += steps
            self.matvecs += steps * self.nroots * self.matvecs_per_direction
            errors = state.errors.cpu().numpy()
            if checkpoint_path is not None and sweeps_done % max(1, checkpoint_every) == 0:
                self._checkpoint(state, checkpoint_path)
            if np.all(errors <= self.tol) or self.iterations >= self.max_iter:
                break
            state = self.restart(state, self.operand)
        return self._finish(state)

    def _checkpoint(self, state: DavidsonState, path: str) -> None:
        """Save the state; under sharding its (rows, N) fields are gathered,
        rank 0 writes the file and every rank waits for it."""
        from ..utils.checkpoint import save_fused_state

        if self.sharding is not None:
            state = state._replace(**{f: self._global(getattr(state, f))
                                      for f in ("v", "w", "x", "r")})
        if self.sharding is None or self.sharding.mesh.rank == 0:
            save_fused_state(state, path, iterations=self.iterations,
                             matvecs=self.matvecs, tol=float(self.tol),
                             nroots=self.nroots, n_p=self.n_p, rr=self.rr)
        if self.sharding is not None:
            barrier(self.sharding.mesh)
