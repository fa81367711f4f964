"""Non-hermitian Davidson and linear equations in PyTorch (port of
iterative_solver_tpu/solvers/fused_nonsym.py).

The reference solves non-hermitian eigenproblems through its one Davidson
template with hermiticity off (LinearEigensystemDavidson.h:130-184) and the
complex-pair machinery of helper-implementation.h:382-527. Two tiers:

- ``rr="host"``: each outer iteration is one device chunk holding every
  O(N) stage (Ritz reconstruction X = C V, AX = C W, pair-aware residuals,
  Jacobi-preconditioned expansion, two-pass Gram-Schmidt, null-drop and
  Cholesky whitening, append and action, incremental projected matrix H);
  the host touches only (m_max, m_max) matrices between chunks: LAPACK
  ``eig``, ascending real parts, complex-pair extraction (``ritz_nonsym``).
- ``rr="device"``: no eigendecomposition inside the loop. Simultaneous
  Rayleigh-shifted inverse iteration on H tracks the invariant subspace of
  the leftmost eigenvalues with batched LU solves and Cholesky whitening;
  one host ``eig`` of the final (r, r) G recovers the pairs.

Complex pairs stay in REAL arithmetic: for a pair a ± bi with eigenvector
p + iq the rows x_p, x_q satisfy A x_p ~ a x_p - b x_q, A x_q ~ b x_p +
a x_q, so the residual matrix LAMBDA carries 2 x 2 blocks [[a, -b], [b, a]].

Differences from the JAX package, each kept to the same semantics:

- ``lax.while_loop`` and ``lax.cond`` become host loops: the device loop
  reads one scalar per iteration (the largest residual norm), which gives
  both the stopping test ``it < it_end and max errs > tol`` and the gate of
  the global selection step ``max errs > 30 tol``; errs is inf before the
  first iteration. The slot count ``k`` is a host int, so the restart test
  ``k + r > m_max`` needs no read.
- The batched solves run the iteration and the restart under
  ``torch.func.vmap`` on the elements still active, which share the host
  ``k``; the gated global step is computed for every element and selected
  with ``torch.where``, which is what JAX's batched ``cond`` computes too.
- Small solves go through ``solve_ex`` / ``lu_factor_ex`` / ``cholesky_ex``,
  which neither raise nor read the device (a singular system gives inf or
  NaN, as in JAX; the finite checks then raise).
- The "fast" dense tier stores bf16 and rounds x to bf16 with f32 sums, as
  the TPU's default-precision matmul does (JAX's CPU path keeps x in f32).

Sharding is not ported yet and raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..array.vector_ops import chol_jitter
from ..ops.kernels.chain import _cholesky_nan, whiten_after_chain
from ._finite import check_finite
from .fused_davidson import validate_p_inputs

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6c)"


class NonSymDeviceState(NamedTuple):
    """Checkpointable state of the device-RR loop between chunks: enough to
    run the loop on (x, errs and restarts are recomputed each chunk).
    ``k`` and ``it`` are host ints."""

    v: Tensor
    w: Tensor
    mask: Tensor
    k: int
    h: Tensor
    C: Tensor
    best_err: Tensor
    bx: Tensor
    bG: Tensor
    bR: Tensor
    it: int


class LineqDeviceState(NamedTuple):
    """Checkpointable between-chunks state of the linear device loop."""

    v: Tensor
    w: Tensor
    mask: Tensor
    k: int
    h: Tensor
    beta: Tensor
    best_err: Tensor
    bx: Tensor
    berrs: Tensor
    it: int


def ritz_nonsym(h: np.ndarray, nroots: int):
    """Host-side small-matrix stage: right eigenpairs of the projected
    matrix, ascending by real part, complex-conjugate pairs converted to
    real (p, q) coefficient rows with their 2x2 LAMBDA block
    (fused_nonsym.py:87-172, a numpy copy).

    Returns ``(evals_complex (nroots,), coeff (nroots, k), lam (nroots,
    nroots), shifts (nroots,))``: coeff rows reconstruct X = coeff @ V; lam
    is the real block-diagonal residual matrix; shifts the real parts the
    Jacobi preconditioner uses (helper-implementation.h:382-448). A pair
    that straddles the window is dropped, so fewer rows may come back."""
    k = h.shape[0]
    nroots = min(nroots, k)
    w, vr = np.linalg.eig(h)
    order = np.argsort(w.real, kind="stable")
    w = w[order]
    vr = vr[:, order]
    coeff = np.zeros((nroots, k))
    lam = np.zeros((nroots, nroots))
    evals = np.zeros((nroots,), dtype=np.complex128)
    i = 0
    while i < nroots:
        li = w[i]
        if abs(li.imag) > 1e-13 * max(1.0, abs(li)):
            # for a real h, LAPACK returns conjugate pairs adjacent and the
            # stable sort keeps them so; verify before consuming slot i+1,
            # and swap the partner in if it sits elsewhere
            d = np.abs(w[i + 1:] - np.conj(li))
            if d.size:
                j = i + 1 + int(np.argmin(d))
                if d[j - (i + 1)] <= 1e-8 * max(1.0, abs(li)) and j != i + 1:
                    w[[i + 1, j]] = w[[j, i + 1]]
                    vr[:, [i + 1, j]] = vr[:, [j, i + 1]]
            if (d.size == 0
                    or abs(w[i + 1] - np.conj(li)) > 1e-8 * max(1.0, abs(li))):
                # no conjugate partner: treat the root at its real part
                y = vr[:, i].real
                nrm = np.linalg.norm(y)
                mx = int(np.argmax(np.abs(y)))
                if y[mx] < 0:
                    y = -y
                coeff[i] = y / (nrm if nrm > 0 else 1.0)
                lam[i, i] = li.real
                evals[i] = li.real
                i += 1
                continue
            if i + 1 >= nroots:
                # the pair straddles the window: drop it rather than split it
                return (evals[:i], coeff[:i], lam[:i, :i],
                        np.real(evals[:i]))
            a, b = li.real, abs(li.imag)
            y = vr[:, i] if li.imag > 0 else np.conj(vr[:, i])
            p, q = y.real, y.imag
            sp = np.linalg.norm(p) or 1.0
            sq = np.linalg.norm(q) or 1.0
            coeff[i] = p / sp
            coeff[i + 1] = q / sq
            # with x_p = p/sp, x_q = q/sq: A x_p = a x_p - b (sq/sp) x_q etc.
            lam[i, i] = a
            lam[i + 1, i + 1] = a
            lam[i, i + 1] = -b * (sq / sp)
            lam[i + 1, i] = b * (sp / sq)
            evals[i] = a + 1j * b
            evals[i + 1] = a - 1j * b
            i += 2
        else:
            y = vr[:, i].real
            nrm = np.linalg.norm(y)
            mx = int(np.argmax(np.abs(y)))
            if y[mx] < 0:
                y = -y
            coeff[i] = y / (nrm if nrm > 0 else 1.0)
            lam[i, i] = li.real
            evals[i] = li.real
            i += 1
    return evals, coeff, lam, evals.real.copy()


# ---------------------------------------------------------------------------
# device stages shared by both families


def _dots(a: Tensor, b: Tensor) -> Tensor:
    return torch.einsum("in,in->i", a, b)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _zeros(shape, like: Tensor) -> Tensor:
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _put_rows(stack: Tensor, k: int, rows: Tensor) -> Tensor:
    """``stack`` with rows [k, k + len(rows)) replaced: a new tensor, so it
    works under ``torch.func.vmap`` whatever is batched. Raises past the
    capacity (``dynamic_update_slice`` would clamp onto live rows)."""
    r = rows.shape[0]
    if k + r > stack.shape[0]:
        raise ValueError(f"append of {r} rows at slot {k} exceeds the capacity "
                         f"{stack.shape[0]}")
    return torch.cat([stack[:k], rows.to(stack.dtype), stack[k + r:]])


def _put_cols(mat: Tensor, k: int, cols: Tensor) -> Tensor:
    r = cols.shape[1]
    return torch.cat([mat[:, :k], cols.to(mat.dtype), mat[:, k + r:]], dim=1)


def _lower_solve(l: Tensor, x: Tensor) -> Tensor:
    return torch.linalg.solve_triangular(l, x, upper=False)


def _make_append(matvec: Callable, r: int, m_max: int, null_thresh: float):
    """Append stage of both families: two-pass classical Gram-Schmidt
    against the live basis, null-drop and Cholesky whitening, stack append,
    operator application, mask update (fused_nonsym.py:175-203). ``k`` is a
    host int."""

    def append(v, w, mask, k: int, t, operand):
        vm = v * mask[:, None]
        n0_2 = _dots(t, t)
        tt = t
        for _ in range(2):
            proj = torch.matmul(tt, vm.T)
            tt = tt - torch.matmul(proj, vm)
        n2 = _dots(tt, tt)
        tt, keep = whiten_after_chain(tt, n0_2, n2, r, null_thresh)
        w_rows = matvec(tt, operand).to(w.dtype)
        v_new = _put_rows(v, k, tt)
        w_new = _put_rows(w, k, w_rows)
        keep_full = torch.cat([torch.zeros(k, dtype=torch.bool, device=mask.device), keep,
                               torch.zeros(m_max - k - r, dtype=torch.bool,
                                           device=mask.device)])
        mask_new = torch.where(keep_full, torch.ones_like(mask), mask)
        return v_new, w_new, mask_new, k + r, tt, w_rows

    return append


def _incremental_update(h, v, w, mask, k0: int, rows: int):
    """Only the ``rows`` appended slots change (old rows are append-only):
    two (rows, m_max) products replace the full recompute of H. Returns
    ``(h, new_v)``; new_v lets the linear twin update its RHS projection."""
    vm2 = v * mask[:, None]
    wm2 = w * mask[:, None]
    new_v = vm2[k0:k0 + rows]
    new_w = wm2[k0:k0 + rows]
    h = _put_rows(h, k0, torch.matmul(new_v, wm2.T))
    h = _put_cols(h, k0, torch.matmul(vm2, new_w.T))
    return h, new_v


def _orthonormal_block(x: Tensor):
    """(t, live): the (r, N) block orthonormalised by a Cholesky of its
    Gram, rows below 1e-12 of the largest squared norm kept dead (zero)."""
    r = x.shape[0]
    g = torch.matmul(x, x.T)
    g = 0.5 * (g + g.T)
    gd = torch.diagonal(g)
    live = gd > 1e-12 * torch.clamp(torch.max(gd), min=1e-300)
    g = g + chol_jitter(g.dtype) * _eye(r, g)
    t = _lower_solve(_cholesky_nan(g), x)
    return t * live[:, None].to(t.dtype), live


def _reset_core(matvec: Callable, r: int, m_max: int, x, operand):
    """Shared init/restart core: orthonormalise an (r, N) block with zero
    rows kept DEAD (a straddling-pair window returns fewer rows; a live
    zero row would put a spurious eigenvalue 0 into H), apply the operator,
    lay out fresh stacks. Returns (v, w, mask, h)."""
    t, live = _orthonormal_block(x)
    w_rows = matvec(t, operand).to(x.dtype)
    pad = _zeros((m_max - r, x.shape[1]), x)
    v = torch.cat([t, pad])
    w = torch.cat([w_rows, pad])
    mask = torch.cat([live.to(x.dtype), _zeros((m_max - r,), x)])
    h = torch.matmul(v * mask[:, None], (w * mask[:, None]).T)
    return v, w, mask, h


def make_nonsym_chunk(matvec: Callable, nroots: int, m_max: int,
                      null_thresh: float = 1e-10, inner: int = 1):
    """``inner`` appends' worth of O(N) work between two host stages.

    Append 1 expands the Jacobi-preconditioned residual at the host-given
    Ritz data; appends 2..inner are frozen-shift Krylov enrichment: the new
    block's residual proxy (A - shift) t reuses the action the append
    already paid for (fused_nonsym.py:250-289)."""
    append = _make_append(matvec, nroots, m_max, null_thresh)

    def chunk(v, w, mask, k: int, h, coeff, lam, shifts, operand, diag):
        vm = v * mask[:, None]
        wm = w * mask[:, None]
        x = torch.matmul(coeff, vm)
        ax = torch.matmul(coeff, wm)
        r_blk = ax - torch.matmul(lam, x)
        errors = torch.sqrt(torch.abs(_dots(r_blk, r_blk)))
        # Jacobi preconditioner at the Ritz real parts (IterativeSolver.h:
        # 34-44), regulariser relative to the spectrum's scale
        scale_est = torch.max(torch.abs(diag)) + torch.max(torch.abs(shifts))
        denom = diag[None, :] - shifts[:, None] + 1e-15 * scale_est + 1e-300
        k0 = k
        t = r_blk / denom
        v, w, mask, k, t_app, w_rows = append(v, w, mask, k, t, operand)
        for _ in range(inner - 1):
            t = (w_rows - shifts[:, None] * t_app) / denom
            v, w, mask, k, t_app, w_rows = append(v, w, mask, k, t, operand)
        h, _ = _incremental_update(h, v, w, mask, k0, inner * nroots)
        return v, w, mask, k, h, x, errors

    return chunk


def make_nonsym_reset(matvec: Callable, nroots: int, m_max: int):
    """Init/restart: orthonormalise an (r, N) block, apply the operator,
    lay out fresh (m_max, N) stacks and the projected matrix."""

    def reset(x, operand):
        v, w, mask, h = _reset_core(matvec, nroots, m_max, x, operand)
        return v, w, mask, nroots, h

    return reset


def _rotate_x(bx, coeff):
    """Final pair rotation of the best snapshot's rows, left on the device."""
    return torch.matmul(coeff, bx)


def _check_live_p_guess(p_dense, v0, r, n_p, what):
    """A C row seeded on a dead slot stays zero forever and reads as a
    FABRICATED eigenvalue 0.0 (fused_nonsym.py:301-326): with n_p < r and
    guesses swallowed by the P span, refuse on the host, with the same GS
    the device init applies."""
    if n_p >= r:
        return
    pd = np.asarray(p_dense, dtype=np.float64)
    q, _ = np.linalg.qr(pd.T)
    pw = q.T[:n_p]
    v = _host_array(v0)
    for _ in range(2):
        v = v - (v @ pw.T) @ pw
    norms2 = np.einsum("in,in->i", v, v)
    live = int(np.sum(norms2 > 1e-12 * max(float(norms2.max()), 1e-300)))
    if n_p + live < r:
        raise ValueError(
            f"{what}: only {n_p} P rows + {live} guess rows outside the P "
            f"span for {r} requested roots/RHS — provide initial guesses "
            "with components outside span(P) (a dead tracking row would "
            "return a fabricated zero eigenvalue)")


def _whiten_p(p, wp, use_actions, matvec, operand, n_p):
    """Whiten the P block by a Cholesky of its Gram with a dtype-aware
    jitter; the user's action rows (if given) through the same transform,
    else the operator's."""
    gp = torch.matmul(p, p.T)
    gp = gp + chol_jitter(gp.dtype) * _eye(n_p, gp)
    lp = _cholesky_nan(gp)
    pv = _lower_solve(lp, p)
    pw = _lower_solve(lp, wp) if use_actions else matvec(pv, operand)
    return pv, pw


def _live_one_hot(mask, r):
    """(r, m_max) one-hot rows over the FIRST r live slots (a guess row
    swallowed by the P span is dead; seeding C on it would read as instant
    convergence with zero vectors)."""
    pos = torch.cumsum(mask, 0) * mask            # 1-based rank among live
    ranks = torch.arange(1, r + 1, dtype=mask.dtype, device=mask.device)
    return (pos[None, :] == ranks[:, None]).to(mask.dtype)


def _reset_core_p(matvec: Callable, r: int, m_max: int, x, operand, pv, pw):
    """P-preserving init/collapse core: the frozen P slots [0, n_p) keep
    their basis AND action rows, the (r, N) block is Gram-Schmidted against
    them and orthonormalised with dead rows kept dead. Returns (v, w, mask,
    h, t)."""
    n_p = pv.shape[0]
    for _ in range(2):
        x = x - torch.matmul(torch.matmul(x, pv.T), pv)
    t, live = _orthonormal_block(x)
    w_rows = matvec(t, operand) * live[:, None].to(t.dtype)
    pad = _zeros((m_max - n_p - r, x.shape[1]), x)
    v = torch.cat([pv.to(x.dtype), t, pad])
    w = torch.cat([pw.to(x.dtype), w_rows.to(x.dtype), pad])
    mask = torch.cat([torch.ones(n_p, dtype=x.dtype, device=x.device), live.to(x.dtype),
                      _zeros((m_max - n_p - r,), x)])
    h = torch.matmul(v * mask[:, None], (w * mask[:, None]).T)
    return v, w, mask, h, t


def _make_refine(r: int, m_max: int, rr_steps: int):
    """Device-side RR refinement (fused_nonsym.py:402-469): simultaneous
    Rayleigh-quotient inverse iteration, each row through its own shifted
    solve (batched LU), re-orthonormalised by Cholesky whitening; first, while
    the residuals are far from tol (``do_global``), one common-shift inverse
    step just below the window that lets a missed lower root swap in.
    ``do_global`` is a host bool, or a bool tensor under vmap (both branches
    computed, one selected)."""

    def _orth(ct, eye_r):
        # bound the amplification before the Gram
        ct = ct / torch.clamp(torch.amax(torch.abs(ct), dim=1, keepdim=True), min=1e-30)
        g = torch.matmul(ct, ct.T)
        g = 0.5 * (g + g.T) + chol_jitter(g.dtype) * eye_r
        return _lower_solve(_cholesky_nan(g), ct)

    def _galerkin(C, hm):
        return torch.matmul(torch.matmul(C, hm.T), C.T)

    def refine(C, h, mask, do_global):
        mm = mask[:, None] * mask[None, :]
        scale = torch.max(torch.abs(h)) + 1.0
        hm = h * mm + torch.diag_embed((1.0 - mask) * 10.0 * scale)
        eye = _eye(m_max, h)
        eye_r = _eye(r, h)
        G = _galerkin(C, hm)
        for _ in range(rr_steps):
            shifts = torch.diagonal(G)
            smin = torch.min(shifts)
            scale_s = torch.max(torch.abs(shifts)) + 1.0
            sigma_g = smin - 0.1 * (torch.max(shifts) - smin) - 1e-3 * (torch.abs(smin) + 1.0)
            if do_global is not False:
                ct = torch.linalg.solve_ex(hm - sigma_g * eye, C.T)[0].T
                Cn = _orth(ct, eye_r)
                Gn = _galerkin(Cn, hm)
                if do_global is True:
                    C, G = Cn, Gn
                else:
                    C = torch.where(do_global, Cn, C)
                    G = torch.where(do_global, Gn, G)
            shifts = torch.diagonal(G)
            sigmas = shifts - 1e-5 * scale_s
            a_b = hm[None, :, :] - sigmas[:, None, None] * eye[None, :, :]
            ct = torch.linalg.solve_ex(a_b, C[:, :, None])[0][..., 0]     # (r, m_max)
            C = _orth(ct, eye_r)
            G = _galerkin(C, hm)
        return C, G, torch.diagonal(G)

    return refine


def _make_nonsym_iterate(matvec: Callable, r: int, m_max: int,
                         null_thresh: float, rr_steps: int):
    """One device-RR Davidson iteration (refine, Ritz block, residual Gram,
    best snapshot, preconditioned append, incremental H), no restart:
    shared by the single loop and the batched solve."""
    append = _make_append(matvec, r, m_max, null_thresh)
    refine = _make_refine(r, m_max, rr_steps)

    def iterate(v, w, mask, k: int, h, C, best_err, bx, bG, bR, operand, diag,
                do_global):
        C, G, shifts = refine(C, h, mask, do_global)
        vm = v * mask[:, None]
        wm = w * mask[:, None]
        x = torch.matmul(C, vm)
        ax = torch.matmul(C, wm)
        rblk = ax - torch.matmul(G, x)
        # (r, r) residual Gram: its diagonal gives the row errors, and the
        # final host eig rotates it with no O(N) fetch
        r_gram = torch.matmul(rblk, rblk.T)
        errs = torch.sqrt(torch.abs(torch.diagonal(r_gram)))
        maxe = torch.max(errs)
        better = maxe < best_err
        best_err = torch.where(better, maxe, best_err)
        bx = torch.where(better, x, bx)
        bG = torch.where(better, G, bG)
        bR = torch.where(better, r_gram, bR)
        scale_est = torch.max(torch.abs(diag)) + torch.max(torch.abs(shifts))
        denom = diag[None, :] - shifts[:, None] + 1e-15 * scale_est + 1e-300
        t = rblk / denom
        k0 = k
        v, w, mask, k, _t_app, _w_rows = append(v, w, mask, k, t, operand)
        h, _ = _incremental_update(h, v, w, mask, k0, r)
        return v, w, mask, k, h, C, x, errs, best_err, bx, bG, bR

    return iterate


def _make_nonsym_collapse(matvec: Callable, r: int, m_max: int, n_p: int = 0):
    """Restart: collapse onto the Ritz block x; the operator re-anchors AX
    exactly. With ``n_p > 0`` the frozen P slots survive and C keeps the
    EXACT coordinates of the outgoing block in the fresh basis."""

    def collapse(x, k: int, operand, v, w):
        if n_p:
            pv = v[:n_p]
            pc = torch.matmul(x, pv.T)                       # (r, n_p)
            rv, rw, rmask, rh, t = _reset_core_p(matvec, r, m_max, x, operand, pv,
                                                 w[:n_p])
            xs = x - torch.matmul(pc, pv)
            cx = torch.matmul(xs, t.T)                       # (r, r)
            rC = torch.cat([pc.to(x.dtype), cx.to(x.dtype),
                            _zeros((r, m_max - n_p - r), x)], dim=1)
            return rv, rw, rmask, n_p + r, rh, rC
        rv, rw, rmask, rh = _reset_core(matvec, r, m_max, x, operand)
        rC = torch.cat([_eye(r, x), _zeros((r, m_max - r), x)], dim=1)
        return rv, rw, rmask, r, rh, rC

    return collapse


def _thresholds(tol: float, dtype) -> tuple:
    """(tol, 30 tol) rounded to the working dtype, as the JAX loop compares
    errors with a tolerance of their own dtype."""
    t = torch.tensor(tol, dtype=dtype)
    return float(t), float(30.0 * t)


def make_nonsym_device_loop(matvec: Callable, r: int, m_max: int,
                            null_thresh: float = 1e-10, rr_steps: int = 1,
                            n_p: int = 0, p_actions: bool = False):
    """The device-RR non-hermitian Davidson loop (fused_nonsym.py:545-660):
    no eigendecomposition inside. With basis rows V, action rows W and H =
    V Wᵀ, inverse subspace iteration C' = (H - sigma I)⁻¹ Cᵀ, C =
    chol-whiten(C'), G = C Hᵀ Cᵀ tracks the invariant subspace of the
    leftmost eigenvalues; the residual R = C W - G (C V) is real even for
    a complex pair. The best snapshot (x, G, residual Gram) is carried.

    Returns ``(run_init, run_cont)``; each returns the loop's state ``(v,
    w, mask, k, h, C, x, errs, it, best_err, bx, bG, bR, restarts)``, with
    k, it and restarts host ints. Each iteration reads one scalar."""
    iterate = _make_nonsym_iterate(matvec, r, m_max, null_thresh, rr_steps)
    collapse = _make_nonsym_collapse(matvec, r, m_max, n_p)

    def _loop(v, w, mask, k, h, C, tol, it0, it_end, best_err, bx, bG, bR, operand,
              diag):
        tol_f, global_f = _thresholds(tol, v.dtype)
        x = _zeros((r, v.shape[1]), v)
        errs = torch.full((r,), float("inf"), dtype=v.dtype, device=v.device)
        it, restarts = int(it0), 0
        while it < it_end:
            emax = float(torch.max(errs))
            # NaN > tol is False: a NaN error ends the loop, as in JAX
            if not emax > tol_f:
                break
            # selection pressure only while far from tol (inf at first)
            do_global = emax > global_f
            (v, w, mask, k, h, C, x, errs, best_err, bx, bG, bR) = iterate(
                v, w, mask, k, h, C, best_err, bx, bG, bR, operand, diag, do_global)
            if k + r > m_max:
                v, w, mask, k, h, C = collapse(x, k, operand, v, w)
                restarts += 1
            it += 1
        return (v, w, mask, k, h, C, x, errs, it, best_err, bx, bG, bR, restarts)

    def _fresh(x0):
        best_err = torch.tensor(float("inf"), dtype=x0.dtype, device=x0.device)
        return best_err, _zeros((r, x0.shape[1]), x0), _zeros((r, r), x0)

    def run_init(x0, operand, diag, tol, it_end):
        """Init (orthonormalise, apply, lay out) and the loop."""
        v, w, mask, h = _reset_core(matvec, r, m_max, x0, operand)
        C = torch.cat([_eye(r, x0), _zeros((r, m_max - r), x0)], dim=1)
        best_err, z, zr = _fresh(x0)
        return _loop(v, w, mask, r, h, C, tol, 0, it_end, best_err, z, zr, zr,
                     operand, diag)

    def run_init_p(x0, operand, diag, tol, it_end, p, wp):
        """P-space init: whiten and freeze P into slots [0, n_p) (user action
        rows through the same whitening, or the operator's), GS the guess
        block against it, then the loop; C spans every masked slot, so the
        refinement needs no further P logic."""
        pv, pw = _whiten_p(p, wp, p_actions, matvec, operand, n_p)
        v, w, mask, h, _t = _reset_core_p(matvec, r, m_max, x0, operand, pv, pw)
        C = _live_one_hot(mask, r).to(x0.dtype)
        best_err, z, zr = _fresh(x0)
        return _loop(v, w, mask, n_p + r, h, C, tol, 0, it_end, best_err, z, zr, zr,
                     operand, diag)

    def run_cont(v, w, mask, k, h, C, operand, diag, tol, it0, it_end, best_err, bx, bG,
                 bR):
        """The loop on from a carried state (solves longer than a chunk)."""
        return _loop(v, w, mask, int(k), h, C, tol, it0, it_end, best_err, bx, bG, bR,
                     operand, diag)

    return (run_init_p if n_p else run_init), run_cont


def make_nonsym_sweep_solve(matvec: Callable, r: int, m_max: int,
                            null_thresh: float = 1e-10, rr_steps: int = 1):
    """Whole non-hermitian device-RR solve with restarts hoisted to sweep
    boundaries (fused_nonsym.py:663-729): each trip collapses the basis if
    a sweep of ``(m_max - r) // r`` iterations would not fit, then runs the
    sweep; the convergence test is read once per trip, so iteration counts
    quantise up to the sweep. Returns ``(init, solve)`` for one system;
    ``make_batched_nonsym_solve`` runs the same iteration over a batch."""
    iterate = _make_nonsym_iterate(matvec, r, m_max, null_thresh, rr_steps)
    collapse = _make_nonsym_collapse(matvec, r, m_max)
    fill_steps = max(1, (m_max - r) // r)

    def init(v0, operand):
        v, w, mask, h = _reset_core(matvec, r, m_max, v0, operand)
        C = torch.cat([_eye(r, v0), _zeros((r, m_max - r), v0)], dim=1)
        return v, w, mask, r, h, C

    def solve(v, w, mask, k, h, C, operand, diag, tol_, max_iter_):
        tol_f, global_f = _thresholds(tol_, v.dtype)
        x = _zeros((r, v.shape[1]), v)
        errs = torch.full((r,), float("inf"), dtype=v.dtype, device=v.device)
        best_err = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
        bx, bG, bR = x, _zeros((r, r), v), _zeros((r, r), v)
        it = 0
        while it < max_iter_ and float(torch.max(errs)) > tol_f:
            if k + fill_steps * r > m_max:
                v, w, mask, k, h, C = collapse(x, k, operand, v, w)
            for _ in range(fill_steps):
                do_global = torch.max(errs) > global_f
                (v, w, mask, k, h, C, x, errs, best_err, bx, bG, bR) = iterate(
                    v, w, mask, k, h, C, best_err, bx, bG, bR, operand, diag, do_global)
            it += fill_steps
        return x, errs, best_err, bx, bG, bR, it

    return init, solve


def _take(tree, axes, idx):
    """The batch elements ``idx`` of each leaf of ``tree`` that ``axes`` (a
    vmap in_dims prefix: 0, None or a tuple of those) says is batched."""
    if axes is None:
        return tree
    if isinstance(axes, int):
        if isinstance(tree, torch.Tensor):
            return tree.index_select(axes, idx)
        return type(tree)(_take(t, axes, idx) for t in tree)
    return type(tree)(_take(t, a, idx) for t, a in zip(tree, axes))


def _batched_trips(fields, ks, its, r, m_max, fill_steps, tol_, max_iter_, operand,
                   operand_axes, collapse_fn, step_fn):
    """Shared trip loop of the batched sweep solves: one host read per trip
    (the largest error of each element); the elements still active (not
    converged, under ``max_iter``) share their slot count and run one
    collapse (when a sweep would not fit) and one sweep under vmap; the
    others hold their state. ``fields`` (v, w, mask, h, C or beta, x, errs,
    ...) are modified in place."""
    nb = fields[0].shape[0]
    tol_f = _thresholds(tol_, fields[0].dtype)[0]
    while True:
        # fields[6]: each element's errors
        errs = torch.amax(fields[6], dim=1).cpu().numpy()
        active = [b for b in range(nb) if its[b] < max_iter_ and errs[b] > tol_f]
        if not active:
            break
        k = ks[active[0]]
        idx = torch.as_tensor(active, device=fields[0].device)
        sub = [f.index_select(0, idx) for f in fields]
        op = _take(operand, operand_axes, idx)
        if k + fill_steps * r > m_max:
            sub, k = collapse_fn(sub, k, op, idx)
        for _ in range(fill_steps):
            sub, k = step_fn(sub, k, op, idx)
        for f, new in zip(fields, sub):
            f.index_copy_(0, idx, new)
        for b in active:
            ks[b] = k
            its[b] += fill_steps


def make_batched_nonsym_solve(matvec: Callable, nroots: int, m_max: int,
                              null_thresh: float = 1e-10, rr_steps: int = 1,
                              operand_axes=0):
    """Many independent non-hermitian eigenproblems at once
    (fused_nonsym.py:732-764): only the device-RR iteration, with no host
    stage inside, batches. Usage:

        binit, bsolve = make_batched_nonsym_solve(matvec, r, m_max)
        state = binit(v0_batch, operand_batch)            # each (B, ...)
        x, errs, best_err, bx, bG, bR, iters = bsolve(
            *state, operand_batch, diag_batch, tol, max_iter)
        evals, x_rot, errors = finalize_nonsym_batch(bx, bG, bR)

    The iteration, the restart and the init run under ``torch.func.vmap``;
    each trip runs one basis-fill sweep on the elements still active, so
    each element's iteration count quantises to the sweep length. The
    matvec must be vmap-compatible (dense products and the int8 tiers are;
    the packed kernel wrappers are not). ``operand_axes`` is a vmap in_dims
    prefix for the operand: ``(None, 0)`` shares one operator with a
    per-element parameter. ``state``'s k is a tuple of host ints, iters a
    (B,) int64 tensor."""
    iterate = _make_nonsym_iterate(matvec, nroots, m_max, null_thresh, rr_steps)
    collapse = _make_nonsym_collapse(matvec, nroots, m_max)
    fill_steps = max(1, (m_max - nroots) // nroots)

    def init(v0, operand):
        v, w, mask, h = _reset_core(matvec, nroots, m_max, v0, operand)
        C = torch.cat([_eye(nroots, v0), _zeros((nroots, m_max - nroots), v0)], dim=1)
        return v, w, mask, h, C

    def batched_init(v0, operand):
        v, w, mask, h, C = torch.func.vmap(init, in_dims=(0, operand_axes))(v0, operand)
        return v, w, mask, (nroots,) * v0.shape[0], h, C

    def batched_solve(v, w, mask, k, h, C, operand, diag, tol_, max_iter_):
        nb, n = v.shape[0], v.shape[2]
        x = _zeros((nb, nroots, n), v)
        inf = torch.full((nb, nroots), float("inf"), dtype=v.dtype, device=v.device)
        # v w mask h C x errs best_err bx bG bR: own copies, written in place
        fields = [v.clone(), w.clone(), mask.clone(), h.clone(), C.clone(), x, inf,
                  inf[:, 0].clone(), x.clone(), _zeros((nb, nroots, nroots), v),
                  _zeros((nb, nroots, nroots), v)]
        ks, its = list(k), [0] * nb
        global_f = _thresholds(tol_, v.dtype)[1]

        def collapse_fn(sub, k_, op, idx):
            def one(x_, v_, w_, o_):
                rv, rw, rmask, _, rh, rC = collapse(x_, k_, o_, v_, w_)
                return rv, rw, rmask, rh, rC

            rv, rw, rmask, rh, rC = torch.func.vmap(
                one, in_dims=(0, 0, 0, operand_axes))(sub[5], sub[0], sub[1], op)
            return [rv, rw, rmask, rh, rC] + sub[5:], nroots

        def step_fn(sub, k_, op, idx):
            def one(v_, w_, mask_, h_, C_, e_, be_, bx_, bG_, bR_, o_, d_):
                do_global = torch.max(e_) > global_f
                out = iterate(v_, w_, mask_, k_, h_, C_, be_, bx_, bG_, bR_, o_, d_,
                              do_global)
                (v2, w2, m2, _, h2, C2, x2, e2, be2, bx2, bG2, bR2) = out
                return v2, w2, m2, h2, C2, x2, e2, be2, bx2, bG2, bR2

            dg = diag.index_select(0, idx)
            out = torch.func.vmap(one, in_dims=(0,) * 10 + (operand_axes, 0))(
                *sub[:5], *sub[6:], op, dg)
            return list(out), k_ + nroots

        _batched_trips(fields, ks, its, nroots, m_max, fill_steps, tol_, max_iter_,
                       operand, operand_axes, collapse_fn, step_fn)
        _, _, _, _, _, x, errs, best_err, bx, bG, bR = fields
        return x, errs, best_err, bx, bG, bR, torch.as_tensor(its, dtype=torch.int64)

    return batched_init, batched_solve


def _extract_lowest_block(bG_h, r: int, context: str = ""):
    """Host LAPACK eig of a best-snapshot (r, r) G, shared by the batch
    finalizer and the device-RR chunk loop: it passes Gᵀ, because the rotated rows
    y = z X satisfy y Aᵀ = z G X + z R, so z must be a LEFT eigenvector of G
    (``ritz_nonsym(h)`` returns rows with coeff hᵀ = lam coeff). Returns
    ``(evals, coeff, r_eff)``; raises when the lowest root is a conjugate
    pair the window cannot hold."""
    evals, coeff, _lam, _shifts = ritz_nonsym(np.asarray(bG_h, dtype=np.float64).T, r)
    r_eff = coeff.shape[0]
    if r_eff == 0:
        raise ValueError(
            f"{context}the lowest subspace root is a complex conjugate "
            f"pair and nroots={r} cannot hold both members — increase "
            "nroots (a pair needs two slots)")
    return evals, coeff, r_eff


def _rotated_errors(coeff, bR_h):
    """Per-root residual norms after the host-eig rotation: the (r, r)
    residual Gram rotated as coeff R coeffᵀ, no O(N) fetch."""
    bR64 = np.asarray(bR_h, dtype=np.float64)
    return np.sqrt(np.abs(np.diag(coeff @ bR64 @ coeff.T)))


def finalize_nonsym_batch(bx, bG, bR):
    """Host pair extraction for a batch of device-RR solves: per element a
    LAPACK eig of the (r, r) Gᵀ (left eigenvectors), errors from the rotated
    residual Gram, then one batched einsum rotates every solution row on
    the device. Returns ``(evals_list, x_rot (B, r, N) tensor,
    errors_list)``: lists, because a straddling pair can shrink one
    element's root count (its padded rows of x_rot are zero)."""
    bG_h, bR_h = _host_arrays(bG, bR)
    B, r, _ = bG_h.shape
    evals_out, errors_out = [], []
    coeffs = np.zeros((B, r, r))
    for i in range(B):
        evals, coeff, r_eff = _extract_lowest_block(bG_h[i], r,
                                                    context=f"batch element {i}: ")
        errors = _rotated_errors(coeff, bR_h[i])
        evals_out.append(evals)
        errors_out.append(errors[:r_eff])
        coeffs[i, :r_eff] = coeff
    x_rot = torch.einsum("bij,bjn->bin",
                         torch.as_tensor(coeffs, dtype=bx.dtype, device=bx.device), bx)
    return evals_out, x_rot, errors_out


def _dense_tier_action(matrix: np.ndarray, tier: str, dtype, device):
    """(matvec, operand) of a dense, possibly non-symmetric operator at the
    requested storage tier, shared by both from_dense constructors
    (fused_nonsym.py:813-846): "precise" stores it in the working dtype
    (f32 with TF32 off on the card); "fast" in bf16 when the working dtype
    is f32 (x rounded to bf16, f32 sums, as the TPU's default precision
    does), else in the working dtype; "int8" and "int8_precise" one or two
    quantized planes (ops/kernels/dense_int8.py)."""
    if tier in ("int8", "int8_precise"):
        from ..ops.kernels.dense_int8 import (
            DenseInt8,
            DenseInt8Split,
            dense_int8_matvec,
            dense_int8_matvec_split,
        )

        if tier == "int8":
            return dense_int8_matvec, DenseInt8.from_dense(matrix, device=device).tree()
        return (dense_int8_matvec_split,
                DenseInt8Split.from_dense(matrix, device=device).tree())
    if tier == "fast" and dtype == torch.float32:
        def matvec(x, op):
            xb = x.to(torch.bfloat16).to(torch.float32)
            if xb.is_cuda:
                # bf16 x bf16 products, f32 sums and output
                return torch.mm(xb.to(torch.bfloat16), op.T, out_dtype=torch.float32)
            return torch.matmul(xb, op.to(torch.float32).T)

        return matvec, torch.as_tensor(matrix, dtype=torch.bfloat16, device=device)

    def matvec(x, op):
        return torch.matmul(x, op.T)

    return matvec, torch.as_tensor(matrix, dtype=dtype, device=device)


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.array(x, dtype=np.float64)


def _host_arrays(*tensors):
    """float64 numpy copies of small device tensors of one dtype, in one
    transfer."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy().astype(np.float64)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


_TIERS = ("precise", "fast", "int8", "int8_precise")


def _from_dense_parts(matrix, tier: str, device, kwargs):
    """(matvec, operand, diagonal, n, dtype, device) for from_dense."""
    if tier not in _TIERS:
        raise ValueError(f"tier must be one of {_TIERS}, got {tier!r}")
    device = config.resolve_device(device)
    matrix = np.asarray(matrix, dtype=np.float64)
    n = matrix.shape[0]
    if matrix.shape != (n, n):
        raise ValueError("operator must be square")
    dtype = kwargs.pop("dtype", None) or config.default_dtype(device)
    matvec, operand = _dense_tier_action(matrix, tier, dtype, device)
    return matvec, operand, np.diag(matrix), n, dtype, device


class _NonSymBase:
    """Construction shared by both families: device, dtype, P space."""

    def _setup(self, matvec, diagonals, n, r, m_max, dtype, sharding, tol, max_iter,
               operand, null_thresh, inner, rr, chunk_iters, p_space, p_actions, device,
               default_m_max):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        if rr not in ("host", "device"):
            raise ValueError(f"rr must be 'host' or 'device', got {rr!r}")
        self.p_dense, self.n_p, self.p_action_rows = validate_p_inputs(p_space, p_actions, n)
        if self.n_p and rr != "device":
            raise ValueError(
                "P space on the non-hermitian fused family runs on the "
                "device tier — pass rr='device' (the host-driven parity "
                "solvers carry the host-loop P path)")
        self.device = config.resolve_device(device)
        self.dtype = dtype or config.default_dtype(self.device)
        self.matvec = matvec
        self.n = n
        self.m_max = m_max if m_max is not None else default_m_max + self.n_p
        if self.m_max < 2 * r + self.n_p:
            raise ValueError(f"m_max must be >= 2*{self._what} + n_p")
        if max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        self.sharding = None
        self.tol = tol
        self.max_iter = max_iter
        self.operand = operand
        self.diag = torch.as_tensor(_host_array(diagonals), dtype=self.dtype,
                                    device=self.device)
        self.inner = max(1, int(inner))
        self.rr = rr
        self.chunk_iters = max(1, int(chunk_iters))
        self._null_thresh = null_thresh
        self._chunks = {}
        self.iterations = 0
        self.matvecs = 0

    def _put_block(self, x) -> Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.device, dtype=self.dtype).contiguous()
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _p_blocks(self):
        p = self._put_block(self.p_dense)
        wp = (self._put_block(self.p_action_rows) if self.p_action_rows is not None
              else torch.zeros_like(p))
        return p, wp


class FusedNonSymDavidson(_NonSymBase):
    """Davidson for non-hermitian operators (fused_nonsym.py:849-1334).

    The surface of FusedDavidson: ``matvec(x, operand) -> x Aᵀ`` over row
    blocks, fixed-capacity stacks, any operator tier. Eigenvalues may come
    back complex (conjugate pairs), in ``eigenvalues`` order, with the
    pair's real 2D invariant-subspace rows in ``x``. ``device=None`` means
    the CUDA card; ``dtype=None`` is float32 there and float64 on the CPU.
    Reference twin: LinearEigensystemDavidson.h:130-184 at
    hermiticity=false."""

    _what = "nroots"

    def __init__(
        self,
        matvec: Callable,
        diagonals,
        n: int,
        nroots: int,
        m_max: Optional[int] = None,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 100,
        operand=None,
        null_thresh: float = 1e-10,
        inner: int = 1,
        rr: str = "host",
        rr_steps: int = 1,
        chunk_iters: int = 64,
        p_space=None,
        p_actions=None,
        device=None,
    ):
        if rr == "device" and inner != 1:
            raise ValueError("inner enrichment is a host-RR option; "
                             "rr='device' refreshes shifts every iteration")
        self.nroots = nroots
        self._setup(matvec, diagonals, n, nroots, m_max, dtype, sharding,
                    convergence_threshold, max_iter, operand, null_thresh, inner, rr,
                    chunk_iters, p_space, p_actions, device,
                    max(4 * nroots, 2 * nroots + 2))
        self.rr_steps = max(1, int(rr_steps))
        # the device-RR chunk loop raises the ACTIVE refinement passes to 2 when
        # the tracked window carries genuine complex pairs far from tol;
        # rr_steps_active reports what the last solve ended on
        self.rr_steps_active = self.rr_steps
        self._device_loops = {}
        self._reset = make_nonsym_reset(matvec, nroots, self.m_max)
        # (iteration, max residual) pairs: per eig cycle in host mode, per
        # chunk in device mode
        self.history = []

    @classmethod
    def from_dense(cls, matrix, nroots: int, tier: str = "precise", device=None,
                   **kwargs):
        """One-call construction from a dense (possibly non-symmetric)
        matrix. Tiers: "precise" (the working dtype: f32 with TF32 off on
        the card), "fast" (bf16 storage, x rounded to bf16, f32 sums),
        "int8" (one quantized plane plus the exact f32 diagonal, a quarter
        of the f32 bytes) and "int8_precise" (two planes, ~2^-14 coupling
        error)."""
        matvec, operand, diag, n, dtype, device = _from_dense_parts(matrix, tier, device,
                                                                    kwargs)
        return cls(matvec, diag, n, nroots, dtype=dtype, operand=operand, device=device,
                   **kwargs)

    def _chunk_fn(self, inner: int):
        fn = self._chunks.get(inner)
        if fn is None:
            fn = make_nonsym_chunk(self.matvec, self.nroots, self.m_max, self._null_thresh,
                                   inner=inner)
            self._chunks[inner] = fn
        return fn

    def solve(self, v0, checkpoint_path: Optional[str] = None, checkpoint_every: int = 1):
        """Returns ``(evals_complex, x real-form rows, errors, iterations)``.

        ``checkpoint_path`` (device tier only) persists a resumable
        NonSymDeviceState every ``checkpoint_every`` chunks; continue with
        :meth:`resume`. If a conjugate pair straddles the window at the end,
        the returned set shrinks by one instead of splitting the pair. The
        device tier's errors are recomputed after the final rotation; where
        they miss the tolerance it tightens its in-loop tolerance and
        iterates on (at most twice)."""
        if self.rr == "device":
            return self._solve_device_rr(v0, checkpoint_path, checkpoint_every)
        if checkpoint_path is not None:
            raise ValueError("mid-solve checkpointing is a device-tier "
                             "feature — pass rr='device'")
        r = self.nroots
        v, w, mask, k, h = self._reset(self._put_block(v0), self.operand)
        self.matvecs += r
        self.history = []
        evals = np.zeros((r,), dtype=np.complex128)
        x_out = None
        r_eff = r
        errors = np.full((r,), np.inf)
        errs_dev = None
        # best-snapshot guard: the non-symmetric eig is NOT variational, so
        # noise appended at the residual floor can move its solutions
        # anywhere; return the best state seen if iterating on turns
        # catastrophic (two consecutive 10x-best cycles)
        best = None  # (max_err, evals, x, errors, r_eff)
        spikes = 0
        for _ in range(self.max_iter):
            # one transfer per cycle: h, mask and the previous chunk's errors
            if errs_dev is None:
                h_host, mask_host = _host_arrays(h, mask)
            else:
                h_host, mask_host, errs_h = _host_arrays(h, mask, errs_dev)
                errors = errs_h[:r_eff]
                self.history.append((self.iterations, float(errors.max())))
                if best is None or errors.max() < best[0]:
                    best = (errors.max(), evals, x_out, errors, r_eff)
                if np.all(errors <= self.tol):
                    break
                if errors.max() > 10.0 * best[0] + 1e-300:
                    spikes += 1
                    if spikes >= 2:
                        break
                else:
                    spikes = 0
            act = np.where(mask_host > 0.5)[0]
            hm = h_host[np.ix_(act, act)]
            evals, coeff_act, lam, shifts = ritz_nonsym(hm, r)
            r_eff = coeff_act.shape[0]
            if r_eff == 0:
                raise ValueError(
                    "the lowest subspace root is a complex conjugate pair "
                    f"and nroots={r} cannot hold both members — "
                    "increase nroots (a pair needs two slots)")
            coeff = np.zeros((r, self.m_max))
            coeff[:r_eff, act] = coeff_act
            lam_full = np.zeros((r, r))
            lam_full[:r_eff, :r_eff] = lam
            shifts_full = np.zeros((r,))
            shifts_full[:r_eff] = shifts
            room = (self.m_max - k) // r
            # keep one residual-driven append before the next restart
            inner_now = max(1, min(self.inner, room - 1 if room > 1 else 1))
            v, w, mask, k, h, x, errs_dev = self._chunk_fn(inner_now)(
                v, w, mask, k, h, self._put_block(coeff), self._put_block(lam_full),
                self._put_block(shifts_full), self.operand, self.diag)
            self.iterations += inner_now
            self.matvecs += inner_now * r
            x_out = x
            if k + r > self.m_max:
                v, w, mask, k, h = self._reset(x, self.operand)
                self.matvecs += r
        else:
            # max_iter exhausted: report the last chunk's errors
            if errs_dev is not None:
                errors = _host_arrays(errs_dev)[0][:r_eff]
        if best is not None and best[0] < errors.max():
            _, evals, x_out, errors, r_eff = best
        check_finite(errors, "FusedNonSymDavidson")
        return evals[:r_eff], x_out[:r_eff], errors, self.iterations

    def _loops(self, steps: Optional[int] = None):
        """(run_init, run_cont) for ``steps`` refinement passes (default the
        constructor's rr_steps), cached per steps."""
        steps = self.rr_steps if steps is None else int(steps)
        loop = self._device_loops.get(steps)
        if loop is None:
            loop = make_nonsym_device_loop(
                self.matvec, self.nroots, self.m_max, self._null_thresh, steps,
                n_p=self.n_p, p_actions=self.p_action_rows is not None)
            self._device_loops[steps] = loop
        return loop

    def _solve_device_rr(self, v0, checkpoint_path=None, checkpoint_every: int = 1):
        """rr="device": chunks of ``chunk_iters`` iterations; between chunks
        the host reads errs, best_err and the (r, r) G and residual Gram in
        one transfer, and the final G is diagonalised once on the host."""
        r = self.nroots
        run_init, _ = self._loops()
        it_end = min(self.chunk_iters, self.max_iter)
        if self.n_p:
            _check_live_p_guess(self.p_dense, v0, r, self.n_p, "FusedNonSymDavidson")
            state = run_init(self._put_block(v0), self.operand, self.diag, self.tol, it_end,
                             *self._p_blocks())
            if self.p_action_rows is None:
                self.matvecs += self.n_p
        else:
            state = run_init(self._put_block(v0), self.operand, self.diag, self.tol, it_end)
        self.matvecs += r
        return self._drive_device_chunks(state, 0, checkpoint_path, checkpoint_every)

    def resume(self, checkpoint_path: str, keep_checkpointing: bool = True,
               checkpoint_every: int = 1):
        """Continue an interrupted device-tier solve from a checkpoint of
        ``solve(..., checkpoint_path=...)``, the JAX package's included; by
        default keeps writing to the same path, and restores the matvec
        count."""
        from ..utils.checkpoint import load_named_state

        st, meta = load_named_state(checkpoint_path, NonSymDeviceState, dtype=self.dtype,
                                    device=self.device)
        if tuple(st.v.shape) != (self.m_max, self.n):
            raise ValueError(
                f"checkpoint stacks are {tuple(st.v.shape)} but this solver "
                f"is configured (m_max={self.m_max}, n={self.n}) — resume "
                "with the same capacity and dimension")
        if st.C.shape[0] != self.nroots:
            raise ValueError(
                f"checkpoint tracks {st.C.shape[0]} roots, solver wants {self.nroots}")
        if "n_p" in meta and meta["n_p"] != self.n_p:
            raise ValueError(
                f"checkpoint was written with n_p={meta['n_p']} but this "
                f"solver has n_p={self.n_p}")
        self.matvecs = int(meta.get("matvecs", self.matvecs))
        _, run_cont = self._loops()
        it_host = int(meta.get("iterations", int(st.it)))
        it_end = min(it_host + self.chunk_iters, self.max_iter)
        state = run_cont(st.v, st.w, st.mask, int(st.k), st.h, st.C, self.operand, self.diag,
                         self.tol, it_host, it_end, st.best_err, st.bx, st.bG, st.bR)
        return self._drive_device_chunks(
            state, it_host, checkpoint_path if keep_checkpointing else None,
            checkpoint_every, history_seed=meta.get("history"))

    def _drive_device_chunks(self, state, it_host, checkpoint_path, checkpoint_every,
                             history_seed=None):
        r = self.nroots
        steps_active = self.rr_steps
        self.rr_steps_active = steps_active
        _, run_cont = self._loops(steps_active)
        tol_dev = float(self.tol)
        spikes = 0
        chunks_done = 0
        rechecks = 0
        self.history = [tuple(h) for h in history_seed] if history_seed else []
        while True:
            (v, w, mask, k, h, C, _x, errs_dev, it_now, best_err, bx, bG, bR,
             restarts) = state
            # one small transfer per chunk (G and the residual Gram ride
            # along, so the final rotation needs no O(N) fetch)
            errors, be_h, bG_h, bR_h = _host_arrays(errs_dev, best_err, bG, bR)
            n_iters = it_now - it_host
            it_host = it_now
            self.iterations = it_host
            self.matvecs += n_iters * r + restarts * r
            self.history.append((it_host, float(errors.max())))
            chunks_done += 1
            if checkpoint_path is not None and chunks_done % max(1, checkpoint_every) == 0:
                from ..utils.checkpoint import save_fused_state

                save_fused_state(
                    NonSymDeviceState(v, w, mask, k, h, C, best_err, bx, bG, bR, it_host),
                    checkpoint_path, iterations=it_host, matvecs=self.matvecs,
                    tol=float(self.tol), nroots=self.nroots, n_p=self.n_p,
                    history=[[int(i), float(e)] for i, e in self.history[-200:]])
            if np.all(errors <= tol_dev) or it_host >= self.max_iter:
                evals, coeff, r_eff = _extract_lowest_block(bG_h, r)
                errors_rot = _rotated_errors(coeff, bR_h)[:r_eff]
                # the rotation mixes rows (up to ~sqrt(r) amplification):
                # where the rotated errors miss the user's tolerance, tighten
                # the loop's by the measured ratio and iterate on (at most
                # twice)
                if (errors_rot.size and np.max(errors_rot) > self.tol
                        and it_host < self.max_iter and spikes < 2 and rechecks < 2):
                    rechecks += 1
                    tol_dev = max(tol_dev * float(self.tol) / float(np.max(errors_rot)),
                                  1e-3 * float(self.tol))
                    it_end = min(it_host + self.chunk_iters, self.max_iter)
                    state = run_cont(v, w, mask, k, h, C, self.operand, self.diag,
                                     tol_dev, it_host, it_end, best_err, bx, bG, bR)
                    continue
                break
            # contamination guard across chunks (two consecutive spikes)
            if errors.max() > 10.0 * float(be_h):
                spikes += 1
                if spikes >= 2:
                    evals, coeff, r_eff = _extract_lowest_block(bG_h, r)
                    errors_rot = _rotated_errors(coeff, bR_h)[:r_eff]
                    break
            else:
                spikes = 0
            # auto-escalation: one refinement pass tracks a complex pair
            # slowly; when G carries genuine pairs far from tol, use two
            if steps_active < 2 and errors.size and errors.max() > 30.0 * float(self.tol):
                wG = np.linalg.eigvals(bG_h)
                spread = float(wG.real.max() - wG.real.min()) + 1e-12
                if np.any(np.abs(wG.imag) > 1e-2 * spread):
                    steps_active = 2
                    self.rr_steps_active = 2
                    _, run_cont = self._loops(steps_active)
            it_end = min(it_host + self.chunk_iters, self.max_iter)
            state = run_cont(v, w, mask, k, h, C, self.operand, self.diag, tol_dev, it_host,
                             it_end, best_err, bx, bG, bR)
        errors = errors_rot
        coeff_full = np.zeros((r, r))
        coeff_full[:r_eff] = coeff
        x_out = _rotate_x(bx, self._put_block(coeff_full))
        check_finite(errors, "FusedNonSymDavidson")
        return evals[:r_eff], x_out[:r_eff], errors, self.iterations


# ---------------------------------------------------------------------------
# linear equations


def _lineq_denominator(diag):
    d = diag if diag.ndim == 2 else diag[None, :]
    return d + 1e-15 * torch.max(torch.abs(d)) + 1e-300


def _make_lineq_iterate(matvec, nrhs, m_max, null_thresh, refine_passes):
    """One Petrov-Galerkin Davidson iteration of the linear device tier
    (fused_nonsym.py:1336-1382): projected LU solve with ``refine_passes``
    rounds of iterative refinement, solution block, relative residuals,
    best snapshot, preconditioned append, incremental H and beta."""
    append = _make_append(matvec, nrhs, m_max, null_thresh)

    def proj_solve(hm, beta):
        lu, piv, _ = torch.linalg.lu_factor_ex(hm)
        cm = torch.linalg.lu_solve(lu, piv, beta)
        for _ in range(refine_passes):
            resid = beta - torch.matmul(hm, cm)
            cm = cm + torch.linalg.lu_solve(lu, piv, resid)
        return cm

    def iterate(v, w, mask, k: int, h, beta, best_err, bx, berrs, operand, diag, b,
                b_norm):
        mm = mask[:, None] * mask[None, :]
        scale = torch.max(torch.abs(h)) + 1.0
        hm = h * mm + torch.diag_embed((1.0 - mask) * 10.0 * scale)
        bm = beta * mask[:, None]
        coeff = proj_solve(hm, bm).T                  # (nrhs, m_max)
        vm = v * mask[:, None]
        wm = w * mask[:, None]
        x = torch.matmul(coeff, vm)
        ax = torch.matmul(coeff, wm)
        rblk = ax - b
        errs = torch.sqrt(torch.abs(_dots(rblk, rblk))) / b_norm
        maxe = torch.max(errs)
        better = maxe < best_err
        best_err = torch.where(better, maxe, best_err)
        bx = torch.where(better, x, bx)
        berrs = torch.where(better, errs, berrs)
        t = rblk / _lineq_denominator(diag)
        k0 = k
        v, w, mask, k, _t_app, _w_rows = append(v, w, mask, k, t, operand)
        h, new_v = _incremental_update(h, v, w, mask, k0, nrhs)
        beta = _put_rows(beta, k0, torch.matmul(new_v, b.T))
        return v, w, mask, k, h, beta, x, errs, best_err, bx, berrs

    return iterate


def _make_lineq_collapse(matvec, nrhs, m_max, n_p: int = 0):
    """Restart of the linear device tier: collapse onto the solution block,
    re-anchor the action, recompute the RHS projection; frozen P slots
    survive."""

    def collapse(x, k: int, operand, b, v, w):
        if n_p:
            rv, rw, rmask, rh, _t = _reset_core_p(matvec, nrhs, m_max, x, operand, v[:n_p],
                                                  w[:n_p])
            rbeta = torch.matmul(rv * rmask[:, None], b.T)
            return rv, rw, rmask, n_p + nrhs, rh, rbeta
        rv, rw, rmask, rh = _reset_core(matvec, nrhs, m_max, x, operand)
        rbeta = torch.matmul(rv * rmask[:, None], b.T)
        return rv, rw, rmask, nrhs, rh, rbeta

    return collapse


def make_nonsym_lineq_device_loop(matvec: Callable, nrhs: int, m_max: int,
                                  null_thresh: float = 1e-10, refine_passes: int = 2,
                                  n_p: int = 0, p_actions: bool = False):
    """Non-symmetric A X = B, the whole Petrov-Galerkin Davidson loop on the
    device with no host stage (fused_nonsym.py:1408-1499): the projected
    (m, m) solve by LU with iterative refinement, dead slots decoupled by a
    large diagonal and a zero RHS, restarts onto the solution block, the
    best snapshot carried. One scalar read per iteration. Returns
    ``(run_init, run_cont)``; each returns the loop's state ``(v, w, mask,
    k, h, beta, x, errs, it, best_err, bx, berrs, restarts)``."""
    iterate = _make_lineq_iterate(matvec, nrhs, m_max, null_thresh, refine_passes)
    collapse = _make_lineq_collapse(matvec, nrhs, m_max, n_p)

    def _loop(v, w, mask, k, h, beta, tol, it0, it_end, best_err, bx, berrs, operand,
              diag, b, b_norm):
        tol_f = _thresholds(tol, v.dtype)[0]
        x = _zeros((nrhs, v.shape[1]), v)
        errs = torch.full((nrhs,), float("inf"), dtype=v.dtype, device=v.device)
        it, restarts = int(it0), 0
        while it < it_end and float(torch.max(errs)) > tol_f:
            (v, w, mask, k, h, beta, x, errs, best_err, bx, berrs) = iterate(
                v, w, mask, k, h, beta, best_err, bx, berrs, operand, diag, b, b_norm)
            if k + nrhs > m_max:
                v, w, mask, k, h, beta = collapse(x, k, operand, b, v, w)
                restarts += 1
            it += 1
        return (v, w, mask, k, h, beta, x, errs, it, best_err, bx, berrs, restarts)

    def _fresh(x0):
        return (torch.tensor(float("inf"), dtype=x0.dtype, device=x0.device),
                _zeros((nrhs, x0.shape[1]), x0),
                torch.full((nrhs,), float("inf"), dtype=x0.dtype, device=x0.device))

    def run_init(x0, operand, diag, b, b_norm, tol, it_end):
        v, w, mask, h = _reset_core(matvec, nrhs, m_max, x0, operand)
        beta = torch.matmul(v * mask[:, None], b.T)
        return _loop(v, w, mask, nrhs, h, beta, tol, 0, it_end, *_fresh(x0), operand,
                     diag, b, b_norm)

    def run_init_p(x0, operand, diag, b, b_norm, tol, it_end, p, wp):
        """P-space init: whiten and freeze P into slots [0, n_p), GS the
        guess block against it."""
        pv, pw = _whiten_p(p, wp, p_actions, matvec, operand, n_p)
        v, w, mask, h, _t = _reset_core_p(matvec, nrhs, m_max, x0, operand, pv, pw)
        beta = torch.matmul(v * mask[:, None], b.T)
        return _loop(v, w, mask, n_p + nrhs, h, beta, tol, 0, it_end, *_fresh(x0),
                     operand, diag, b, b_norm)

    def run_cont(v, w, mask, k, h, beta, operand, diag, b, b_norm, tol, it0, it_end,
                 best_err, bx, berrs):
        return _loop(v, w, mask, int(k), h, beta, tol, it0, it_end, best_err, bx, berrs,
                     operand, diag, b, b_norm)

    return (run_init_p if n_p else run_init), run_cont


def make_nonsym_lineq_sweep_solve(matvec: Callable, nrhs: int, m_max: int,
                                  null_thresh: float = 1e-10, refine_passes: int = 2):
    """Whole non-symmetric A X = B solve with restarts hoisted to sweep
    boundaries (fused_nonsym.py:1502-1561) for one system; returns
    ``(init, solve)``. ``make_batched_nonsym_lineq_solve`` runs the same
    iteration over a batch."""
    iterate = _make_lineq_iterate(matvec, nrhs, m_max, null_thresh, refine_passes)
    collapse = _make_lineq_collapse(matvec, nrhs, m_max)
    fill_steps = max(1, (m_max - nrhs) // nrhs)

    def init(x0, operand, b):
        v, w, mask, h = _reset_core(matvec, nrhs, m_max, x0, operand)
        return v, w, mask, nrhs, h, torch.matmul(v * mask[:, None], b.T)

    def solve(v, w, mask, k, h, beta, operand, diag, b, b_norm, tol_, max_iter_):
        tol_f = _thresholds(tol_, v.dtype)[0]
        x = _zeros((nrhs, v.shape[1]), v)
        errs = torch.full((nrhs,), float("inf"), dtype=v.dtype, device=v.device)
        best_err = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
        bx, berrs = x, errs
        it = 0
        while it < max_iter_ and float(torch.max(errs)) > tol_f:
            if k + fill_steps * nrhs > m_max:
                v, w, mask, k, h, beta = collapse(x, k, operand, b, v, w)
            for _ in range(fill_steps):
                (v, w, mask, k, h, beta, x, errs, best_err, bx, berrs) = iterate(
                    v, w, mask, k, h, beta, best_err, bx, berrs, operand, diag, b, b_norm)
            it += fill_steps
        return x, errs, best_err, bx, berrs, it

    return init, solve


def make_batched_nonsym_lineq_solve(matvec: Callable, nrhs: int, m_max: int,
                                    null_thresh: float = 1e-10, refine_passes: int = 2,
                                    operand_axes=0):
    """Many independent non-symmetric A_k X_k = B_k systems at once
    (fused_nonsym.py:1564-1590). ``operand_axes`` is a vmap in_dims prefix
    for the operand: the key use is SHIFTED systems sharing one operator,
    ``operand = (A, sigmas)``, ``operand_axes = (None, 0)`` with
    ``matvec(x, (op, s)) = x @ op.T + s * x``. The returned ``bx`` is the
    solution, ``berrs`` the per-RHS errors. Usage:

        binit, bsolve = make_batched_nonsym_lineq_solve(mv, nrhs, m_max,
                                                        operand_axes=(None, 0))
        state = binit(x0_b, operand, b_b)
        x, errs, best_err, bx, berrs, iters = bsolve(
            *state, operand, diag_b, b_b, b_norm_b, tol, max_iter)
    """
    iterate = _make_lineq_iterate(matvec, nrhs, m_max, null_thresh, refine_passes)
    collapse = _make_lineq_collapse(matvec, nrhs, m_max)
    fill_steps = max(1, (m_max - nrhs) // nrhs)

    def init(x0, operand, b):
        v, w, mask, h = _reset_core(matvec, nrhs, m_max, x0, operand)
        return v, w, mask, h, torch.matmul(v * mask[:, None], b.T)

    def batched_init(x0, operand, b):
        v, w, mask, h, beta = torch.func.vmap(init, in_dims=(0, operand_axes, 0))(
            x0, operand, b)
        return v, w, mask, (nrhs,) * x0.shape[0], h, beta

    def batched_solve(v, w, mask, k, h, beta, operand, diag, b, b_norm, tol_, max_iter_):
        nb, n = v.shape[0], v.shape[2]
        x = _zeros((nb, nrhs, n), v)
        inf = torch.full((nb, nrhs), float("inf"), dtype=v.dtype, device=v.device)
        # v w mask h beta x errs best_err bx berrs: own copies, written in place
        fields = [v.clone(), w.clone(), mask.clone(), h.clone(), beta.clone(), x, inf,
                  inf[:, 0].clone(), x.clone(), inf.clone()]
        ks, its = list(k), [0] * nb

        def collapse_fn(sub, k_, op, idx):
            bb = b.index_select(0, idx)

            def one(x_, v_, w_, o_, b_):
                rv, rw, rmask, _, rh, rbeta = collapse(x_, k_, o_, b_, v_, w_)
                return rv, rw, rmask, rh, rbeta

            out = torch.func.vmap(one, in_dims=(0, 0, 0, operand_axes, 0))(
                sub[5], sub[0], sub[1], op, bb)
            return list(out) + sub[5:], nrhs

        def step_fn(sub, k_, op, idx):
            def one(v_, w_, mask_, h_, beta_, be_, bx_, berrs_, o_, d_, b_, bn_):
                out = iterate(v_, w_, mask_, k_, h_, beta_, be_, bx_, berrs_, o_, d_, b_,
                              bn_)
                (v2, w2, m2, _, h2, beta2, x2, e2, be2, bx2, berrs2) = out
                return v2, w2, m2, h2, beta2, x2, e2, be2, bx2, berrs2

            args = [t.index_select(0, idx) for t in (diag, b, b_norm)]
            out = torch.func.vmap(one, in_dims=(0,) * 8 + (operand_axes, 0, 0, 0))(
                *sub[:5], *sub[7:], op, *args)
            return list(out), k_ + nrhs

        _batched_trips(fields, ks, its, nrhs, m_max, fill_steps, tol_, max_iter_, operand,
                       operand_axes, collapse_fn, step_fn)
        _, _, _, _, _, x, errs, best_err, bx, berrs = fields
        return x, errs, best_err, bx, berrs, torch.as_tensor(its, dtype=torch.int64)

    return batched_init, batched_solve


def make_nonsym_lineq_chunk(matvec: Callable, nrhs: int, m_max: int,
                            null_thresh: float = 1e-10, inner: int = 1):
    """Linear twin of make_nonsym_chunk (fused_nonsym.py:1593-1629): the
    solution block, residual, preconditioned expansion, GS and whitening,
    append, and the incremental projected matrix and RHS projection; the
    projected solve itself runs on the host in f64."""
    append = _make_append(matvec, nrhs, m_max, null_thresh)

    def chunk(v, w, mask, k: int, h, beta, coeff, operand, diag, b, b_norm):
        vm = v * mask[:, None]
        wm = w * mask[:, None]
        x = torch.matmul(coeff, vm)
        ax = torch.matmul(coeff, wm)
        r = ax - b
        errors = torch.sqrt(torch.abs(_dots(r, r))) / b_norm
        denom = _lineq_denominator(diag)
        k0 = k
        v, w, mask, k, t_app, w_rows = append(v, w, mask, k, r / denom, operand)
        for _ in range(inner - 1):
            # Krylov enrichment: precondition the appended block's image
            v, w, mask, k, t_app, w_rows = append(v, w, mask, k, w_rows / denom, operand)
        h, new_v = _incremental_update(h, v, w, mask, k0, inner * nrhs)
        beta = _put_rows(beta, k0, torch.matmul(new_v, b.T))
        return v, w, mask, k, h, beta, x, errors

    return chunk


def make_nonsym_lineq_reset(matvec: Callable, nrhs: int, m_max: int):
    def reset(x, operand, b):
        v, w, mask, h = _reset_core(matvec, nrhs, m_max, x, operand)
        return v, w, mask, nrhs, h, torch.matmul(v * mask[:, None], b.T)

    return reset


class FusedNonSymLinearEquations(_NonSymBase):
    """Multi-RHS A X = B for NON-symmetric A (fused_nonsym.py:1642-1999):
    Petrov-Galerkin projection on the Davidson basis. ``rr="host"`` solves
    the (m, m) projected system on the host in f64 between device chunks;
    ``rr="device"`` runs the whole loop on the device (LU with iterative
    refinement). Errors are RELATIVE residuals |A x_i - b_i| / |b_i|.
    Reference twin: LinearEquationsDavidson.h at hermiticity=false."""

    _what = "nrhs"

    def __init__(
        self,
        matvec: Callable,
        diagonals,
        n: int,
        nrhs: int,
        m_max: Optional[int] = None,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 200,
        operand=None,
        null_thresh: float = 1e-10,
        inner: int = 1,
        rr: str = "host",
        refine_passes: int = 2,
        chunk_iters: int = 64,
        p_space=None,
        p_actions=None,
        device=None,
    ):
        if rr == "device" and inner != 1:
            raise ValueError("inner enrichment is a host-RR option; "
                             "rr='device' refreshes the projected solve "
                             "every iteration")
        self.nrhs = nrhs
        self._setup(matvec, diagonals, n, nrhs, m_max, dtype, sharding,
                    convergence_threshold, max_iter, operand, null_thresh, inner, rr,
                    chunk_iters, p_space, p_actions, device, max(4 * nrhs, min(n, 24)))
        self.refine_passes = max(0, int(refine_passes))
        self._device_loop = None
        self._reset = make_nonsym_lineq_reset(matvec, nrhs, self.m_max)

    @classmethod
    def from_dense(cls, matrix, nrhs: int, tier: str = "precise", device=None, **kwargs):
        """From a dense (possibly non-symmetric) matrix, in the tiers of
        FusedNonSymDavidson.from_dense (the int8 tiers quantize only the
        couplings; the preconditioner sees the exact diagonal)."""
        matvec, operand, diag, n, dtype, device = _from_dense_parts(matrix, tier, device,
                                                                    kwargs)
        return cls(matvec, diag, n, nrhs, dtype=dtype, operand=operand, device=device,
                   **kwargs)

    def _chunk_fn(self, inner: int):
        fn = self._chunks.get(inner)
        if fn is None:
            fn = make_nonsym_lineq_chunk(self.matvec, self.nrhs, self.m_max,
                                         self._null_thresh, inner=inner)
            self._chunks[inner] = fn
        return fn

    def solve(self, b, x0=None, checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1):
        """Returns ``(x (nrhs, N), errors (nrhs,), iterations)``.

        ``checkpoint_path`` (device tier only) persists a resumable
        LineqDeviceState every ``checkpoint_every`` chunks; continue with
        :meth:`resume` (pass the SAME ``b``)."""
        b_host, b_dev, b_norm = self._prep_b(b)
        if x0 is None:
            d = _host_arrays(self.diag)[0]
            # diag may be (N,) shared or (nrhs, N) per RHS
            d2 = d if d.ndim == 2 else d[None, :]
            x0 = b_host / np.where(np.abs(d2) > 1e-12, d2, 1.0)
        if self.rr == "device":
            return self._solve_device(x0, b_dev, b_norm, checkpoint_path, checkpoint_every)
        if checkpoint_path is not None:
            raise ValueError("mid-solve checkpointing is a device-tier "
                             "feature — pass rr='device'")
        nrhs = self.nrhs
        v, w, mask, k, h, beta = self._reset(self._put_block(x0), self.operand, b_dev)
        self.matvecs += nrhs
        x_out = None
        errors = np.full((nrhs,), np.inf)
        errs_dev = None
        best = None
        spikes = 0
        for _ in range(self.max_iter):
            if errs_dev is None:
                h_host, beta_host, mask_host = _host_arrays(h, beta, mask)
            else:
                h_host, beta_host, mask_host, errors = _host_arrays(h, beta, mask, errs_dev)
                if best is None or errors.max() < best[0]:
                    best = (errors.max(), x_out, errors)
                if np.all(errors <= self.tol):
                    break
                if errors.max() > 10.0 * best[0] + 1e-300:
                    spikes += 1
                    if spikes >= 2:
                        break
                else:
                    spikes = 0
            act = np.where(mask_host > 0.5)[0]
            hm = h_host[np.ix_(act, act)]
            bm = beta_host[act]
            try:
                cm = np.linalg.solve(hm, bm)
            except np.linalg.LinAlgError:
                cm = np.linalg.lstsq(hm, bm, rcond=None)[0]
            coeff = np.zeros((nrhs, self.m_max))
            coeff[:, act] = cm.T
            room = (self.m_max - k) // nrhs
            inner_now = max(1, min(self.inner, room - 1 if room > 1 else 1))
            v, w, mask, k, h, beta, x, errs_dev = self._chunk_fn(inner_now)(
                v, w, mask, k, h, beta, self._put_block(coeff), self.operand, self.diag,
                b_dev, b_norm)
            self.iterations += inner_now
            self.matvecs += inner_now * nrhs
            x_out = x
            if k + nrhs > self.m_max:
                v, w, mask, k, h, beta = self._reset(x, self.operand, b_dev)
                self.matvecs += nrhs
        else:
            if errs_dev is not None:
                errors = _host_arrays(errs_dev)[0]
        if best is not None and best[0] < errors.max():
            _, x_out, errors = best
        check_finite(errors, "FusedNonSymLinearEquations")
        return x_out, errors, self.iterations

    def _loops(self):
        if self._device_loop is None:
            self._device_loop = make_nonsym_lineq_device_loop(
                self.matvec, self.nrhs, self.m_max, self._null_thresh, self.refine_passes,
                n_p=self.n_p, p_actions=self.p_action_rows is not None)
        return self._device_loop

    def _prep_b(self, b):
        b_host = np.atleast_2d(_host_array(b))
        b_dev = self._put_block(b_host)
        b_norm_host = np.linalg.norm(b_host, axis=1)
        b_norm = torch.as_tensor(np.where(b_norm_host > 0, b_norm_host, 1.0),
                                 dtype=self.dtype, device=self.device)
        # fingerprint for resume: another b would mix old beta projections
        # with new ones (a stall or a wrong answer, not an error)
        self._b_fp = [float(x) for x in b_norm_host] + [
            float(s) for s in b_host.sum(axis=1)]
        return b_host, b_dev, b_norm

    def resume(self, checkpoint_path: str, b, keep_checkpointing: bool = True,
               checkpoint_every: int = 1):
        """Continue an interrupted device-tier solve (the JAX package's
        checkpoints included); ``b`` must be the RHS block the original
        solve used. Keeps writing checkpoints to the same path by default;
        restores the matvec count."""
        from ..utils.checkpoint import load_named_state

        _b_host, b_dev, b_norm = self._prep_b(b)
        st, meta = load_named_state(checkpoint_path, LineqDeviceState, dtype=self.dtype,
                                    device=self.device)
        if tuple(st.v.shape) != (self.m_max, self.n):
            raise ValueError(
                f"checkpoint stacks are {tuple(st.v.shape)} but this solver "
                f"is configured (m_max={self.m_max}, n={self.n}) — resume "
                "with the same capacity and dimension")
        if st.bx.shape[0] != self.nrhs:
            raise ValueError(
                f"checkpoint tracks {st.bx.shape[0]} RHS, solver wants {self.nrhs}")
        if "n_p" in meta and meta["n_p"] != self.n_p:
            raise ValueError(
                f"checkpoint was written with n_p={meta['n_p']} but this "
                f"solver has n_p={self.n_p}")
        fp_saved = meta.get("b_fp")
        if fp_saved is not None:
            fp_now = np.asarray(self._b_fp, dtype=np.float64)
            fp_saved = np.asarray(fp_saved, dtype=np.float64)
            scale = np.maximum(np.abs(fp_saved), 1.0)
            if (fp_saved.shape != fp_now.shape
                    or np.max(np.abs(fp_saved - fp_now) / scale) > 1e-6):
                raise ValueError(
                    "resume called with a different RHS block than the "
                    "checkpointed solve: the stored beta projections belong "
                    "to the original b and mixing them with a new b stalls "
                    "or corrupts the solve — pass the same b")
        self.matvecs = int(meta.get("matvecs", self.matvecs))
        _, run_cont = self._loops()
        it_host = int(meta.get("iterations", int(st.it)))
        it_end = min(it_host + self.chunk_iters, self.max_iter)
        state = run_cont(st.v, st.w, st.mask, int(st.k), st.h, st.beta, self.operand,
                         self.diag, b_dev, b_norm, self.tol, it_host, it_end, st.best_err,
                         st.bx, st.berrs)
        return self._drive_lineq_chunks(state, it_host, b_dev, b_norm,
                                        checkpoint_path if keep_checkpointing else None,
                                        checkpoint_every)

    def _solve_device(self, x0, b_dev, b_norm, checkpoint_path=None,
                      checkpoint_every: int = 1):
        """rr="device": the whole loop on the device; between chunks the
        host reads small vectors only. Returns the best snapshot."""
        run_init, _ = self._loops()
        it_end = min(self.chunk_iters, self.max_iter)
        if self.n_p:
            _check_live_p_guess(self.p_dense, x0, self.nrhs, self.n_p,
                                "FusedNonSymLinearEquations")
            state = run_init(self._put_block(x0), self.operand, self.diag, b_dev, b_norm,
                             self.tol, it_end, *self._p_blocks())
            if self.p_action_rows is None:
                self.matvecs += self.n_p
        else:
            state = run_init(self._put_block(x0), self.operand, self.diag, b_dev, b_norm,
                             self.tol, it_end)
        self.matvecs += self.nrhs
        return self._drive_lineq_chunks(state, 0, b_dev, b_norm, checkpoint_path,
                                        checkpoint_every)

    def _drive_lineq_chunks(self, state, it_host, b_dev, b_norm, checkpoint_path,
                            checkpoint_every):
        nrhs = self.nrhs
        _, run_cont = self._loops()
        spikes = 0
        chunks_done = 0
        while True:
            (v, w, mask, k, h, beta, _x, errs_dev, it_now, best_err, bx, berrs,
             restarts) = state
            errors, be_h, berrs_h = _host_arrays(errs_dev, best_err, berrs)
            n_iters = it_now - it_host
            it_host = it_now
            self.iterations = it_host
            self.matvecs += n_iters * nrhs + restarts * nrhs
            chunks_done += 1
            if checkpoint_path is not None and chunks_done % max(1, checkpoint_every) == 0:
                from ..utils.checkpoint import save_fused_state

                save_fused_state(
                    LineqDeviceState(v, w, mask, k, h, beta, best_err, bx, berrs, it_host),
                    checkpoint_path, iterations=it_host, matvecs=self.matvecs,
                    tol=float(self.tol), nrhs=self.nrhs, n_p=self.n_p,
                    b_fp=getattr(self, "_b_fp", None))
            if np.all(errors <= self.tol) or it_host >= self.max_iter:
                break
            if errors.max() > 10.0 * float(be_h):
                spikes += 1
                if spikes >= 2:
                    break
            else:
                spikes = 0
            it_end = min(it_host + self.chunk_iters, self.max_iter)
            state = run_cont(v, w, mask, k, h, beta, self.operand, self.diag, b_dev, b_norm,
                             self.tol, it_host, it_end, best_err, bx, berrs)
        check_finite(berrs_h, "FusedNonSymLinearEquations")
        return bx, berrs_h, self.iterations
