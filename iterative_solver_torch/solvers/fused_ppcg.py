"""Fused projected-preconditioned-conjugate-gradient (PPCG) eigensolver in
PyTorch (port of iterative_solver_tpu/solvers/fused_ppcg.py).

Vecharynski, Yang & Knyazev's PPCG (arXiv:1407.7506): each root relaxes in
its own 3-dim subspace span{x_i, w_i, p_i}, r independent (3, 3)
Rayleigh-Ritz problems solved in packed component form, with a full r-dim
Rayleigh-Ritz only every ``rr_every`` iterations to re-couple and re-sort
the roots. There is no basis stack: the correction is projected against the
current X block only, and the P block carries the conjugacy. One action per
iteration: A·x and A·p are carried exactly through every linear update, the
action applies only to the fresh block W, plus one re-anchoring action of X
at each full Rayleigh-Ritz.

The solve's phases open spans (utils/profiler.py): ``ppcg.solve``,
``.upload``, ``.iteration``, ``.action``, ``.rr3`` (the per-root 3x3
Rayleigh-Ritz, the update and the Cholesky-QR), ``.full_rr`` (with its
re-anchoring ``.action`` inside) and ``.wait``, which record only while a
``torch.profiler`` session does.

On a CUDA device in float32 the per-root Rayleigh-Ritz runs as two
hand-written kernels (K8, ``ops/kernels/rr3.py``): the nine row dots in one
pass, then each root's coefficients and the four-block update in one
launch, with the eager chain's bits given the same dots. Everywhere else
(the CPU, float64) the step runs the eager chain: the row dots
(``_rr3_dots``), ``_rr3_coeffs`` (two packed 3x3 Jacobi eigensolves,
elementwise on (r,) vectors) and the update. The guess is copied to the
device at its own dtype and narrowed there.

Differences from the JAX package, each kept to the same semantics:

- the ``lax.while_loop`` is a host loop that reads the device once per
  iteration (the convergence test); ``it`` is a host int and the
  ``lax.cond`` of the full Rayleigh-Ritz a host ``if``;
- JAX casts a float constant to the working dtype and XLA's compiled code
  reads subnormal floats as zero; PyTorch keeps subnormals. The floors of
  the JAX package are therefore written as the values it applies in each
  dtype (``_floor``: float32(1e-300) is 0) and the norm that decides
  whether a direction is live is read with subnormals flushed
  (``_flush``), so a direction of subnormal size is dead in both packages;
- ``jnp.linalg.cholesky`` returns NaN on failure; ``_cholesky_nan`` keeps
  that contract without a host sync.

Sharding (``sharding=``, parallel/mesh.py) runs one process per shard of
the vector axis (SPMD), as FusedDavidson does: every (r, N) block is this
rank's slice, every dot and Gram over N is all-reduced (the nine dots of
the per-root 3x3 Rayleigh-Ritz in one all-reduce) and the max of the
diagonal too, so every rank takes the same branch; the solve returns
replicated eigenvalues and errors and the gathered Ritz vectors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..array.vector_ops import chol_jitter, to_device
from ..array.vector_ops import dots_rows as _rows_dot
from ..ops.kernels import rr3
from ..ops.kernels.chain import _cholesky_nan, lower_solve
from ..parallel.collectives import pmax, psum
from ..parallel.mesh import check_sharding
from ..utils.profiler import settle, span
from ._finite import check_finite

Tensor = torch.Tensor


class PPCGState(NamedTuple):
    x: Tensor        # (r, N) Ritz block, orthonormal rows
    ax: Tensor       # (r, N) A·x (carried exactly)
    p: Tensor        # (r, N) momentum block (row-normalised or zero)
    ap: Tensor       # (r, N) A·p (carried exactly)
    evals: Tensor    # (r,) Rayleigh quotients
    errors: Tensor   # (r,) residual norms
    it: int          # iteration counter (drives the periodic full RR)


def _floor(value: float, dtype) -> float:
    """A float64 constant as the JAX package applies it in ``dtype``:
    rounded to float32 for float32 (so 1e-300 becomes 0)."""
    return value if dtype == torch.float64 else float(np.float32(value))


def _flush(x: Tensor) -> Tensor:
    """``x`` with subnormal magnitudes read as zero, as XLA's compiled code
    reads them."""
    return torch.where(torch.abs(x) < torch.finfo(x.dtype).tiny, torch.zeros_like(x), x)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _act(matvec, x: Tensor, operand) -> Tensor:
    """``matvec(x, operand)``, the user's action, inside the span
    ``ppcg.action``."""
    with span("ppcg.action"):
        return matvec(x, operand)


def _jacobi3_packed(a00, a11, a22, a01, a02, a12, sweeps: int = 6):
    """Batched symmetric 3x3 Jacobi eigendecomposition in packed component
    form (fused_ppcg.py:56-111): every quantity is a (B,) vector and every
    update an elementwise chain, no (B, 3, 3) arrays.

    Returns ``(w0, w1, w2, V)``: w_i = a_ii after the sweeps (unsorted) and
    V[i][j] the i-th component of the j-th eigenvector."""
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    a = {(0, 0): a00, (1, 1): a11, (2, 2): a22,
         (0, 1): a01, (0, 2): a02, (1, 2): a12}
    small_floor = _floor(1e-36, a00.dtype)

    def off(i, j):
        return a[(i, j)] if i <= j else a[(j, i)]

    def set_off(i, j, val):
        a[(i, j) if i <= j else (j, i)] = val

    for _ in range(sweeps):
        for (p_, q_) in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[(p_, p_)], a[(q_, q_)], off(p_, q_)
            small = torch.abs(apq) <= small_floor
            apq_safe = torch.where(small, one, apq)
            tau = (aqq - app) / (2.0 * apq_safe)
            # stable angle (Golub & Van Loan); tau == 0 -> t = 1 (45 deg)
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, zero, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            r_ = 3 - p_ - q_
            arp, arq = off(r_, p_), off(r_, q_)
            set_off(r_, p_, c * arp - s * arq)
            set_off(r_, q_, s * arp + c * arq)
            # Jacobi shortcut: app' = app - t*apq, aqq' = aqq + t*apq
            a[(p_, p_)] = app - t * apq
            a[(q_, q_)] = aqq + t * apq
            set_off(p_, q_, zero)
            for i in range(3):
                vip, viq = v[i][p_], v[i][q_]
                v[i][p_] = c * vip - s * viq
                v[i][q_] = s * vip + c * viq
    return a[(0, 0)], a[(1, 1)], a[(2, 2)], v


def _batched_eigh3(a: Tensor, sweeps: int = 6):
    """(B, 3, 3) symmetric batched eigh through the packed Jacobi core:
    eigenvalues ascending, ``v[:, :, j]`` the j-th eigenvector (the
    ``torch.linalg.eigh`` contract)."""
    w0, w1, w2, v = _jacobi3_packed(
        a[:, 0, 0], a[:, 1, 1], a[:, 2, 2],
        a[:, 0, 1], a[:, 0, 2], a[:, 1, 2], sweeps=sweeps)
    w = torch.stack([w0, w1, w2], dim=-1)
    vm = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    vm = torch.take_along_dim(vm, order[:, None, :], dim=-1)
    return w, vm


def _batched_rr3(x, ax, w, aw, p, ap, live_w, live_p, nroots: int,
                 sharding=None) -> Tensor:
    """The JAX package's ``_batched_rr3``: ``_rr3_coeffs`` of ``_rr3_dots``
    (the step calls the two apart, with the all-reduce between them)."""
    return _rr3_coeffs(_rr3_dots(x, ax, w, aw, p, ap, sharding), live_w, live_p, nroots)


def _rr3_dots(x, ax, w, aw, p, ap, sharding=None) -> Tensor:
    """The nine row dots over N of the per-root Rayleigh-Ritz, a (9, r)
    block, in one all-reduce under sharding."""
    return psum(rr3.rr3_dots_plain(x, ax, w, aw, p, ap), sharding)


def _rr3_coeffs(dots: Tensor, live_w: Tensor, live_p: Tensor, nroots: int) -> Tensor:
    """Per-root (3, 3) Rayleigh-Ritz, batched over roots
    (fused_ppcg.py:130-195), from its row dots (``_rr3_dots``). Rows are
    unit-normalised or exactly zero, so the metric has a unit diagonal on
    live directions; dead directions are masked out of the whitening and
    their diagonal pushed above the live spectrum. Returns the (r, 3)
    coefficients of the lowest eigenpair. Every operation is elementwise on
    (r,) vectors, with no read back to the host."""
    dtype = dots.dtype
    one = torch.ones((nroots,), dtype=dtype, device=dots.device)
    lw = live_w.to(dtype)
    lp = live_p.to(dtype)
    xw, xp, wp, hxx, hxw, hxp, hww, hwp, hpp = dots.unbind(0)

    gw0, gw1, gw2, gu = _jacobi3_packed(one, lw, lp, xw, xp, wp)
    # dtype-aware whitening floor: admitting a direction with gw at the
    # dot-noise level amplifies it by 1/sqrt(gw) into the Ritz update
    eps_keep = 1e-10 if dtype == torch.float64 else _floor(1e-4, dtype)
    gws = (gw0, gw1, gw2)
    scale = []
    for gwj in gws:
        keepj = gwj > eps_keep
        scale.append(torch.where(
            keepj, 1.0 / torch.sqrt(torch.where(keepj, gwj, 1.0)), 0.0))
    # s_ij = gu_ij * scale_j (whitening transform, dead columns zeroed)
    s = [[gu[i][j] * scale[j] for j in range(3)] for i in range(3)]
    # hw = s^T h s, computed j <= l so it is exactly symmetric
    h = [[hxx, hxw, hxp], [hxw, hww, hwp], [hxp, hwp, hpp]]
    m = [[h[i][0] * s[0][j] + h[i][1] * s[1][j] + h[i][2] * s[2][j]
          for j in range(3)] for i in range(3)]
    hw = {}
    for j in range(3):
        for l in range(j, 3):
            hw[(j, l)] = (s[0][j] * m[0][l] + s[1][j] * m[1][l]
                          + s[2][j] * m[2][l])
    absmax = torch.zeros_like(hxx)
    for val in hw.values():
        absmax = torch.maximum(absmax, torch.abs(val))
    big = 4.0 * absmax + 1.0
    for j, gwj in enumerate(gws):
        dead = (gwj <= eps_keep).to(dtype)
        hw[(j, j)] = hw[(j, j)] + dead * big
    ew0, ew1, ew2, eu = _jacobi3_packed(
        hw[(0, 0)], hw[(1, 1)], hw[(2, 2)],
        hw[(0, 1)], hw[(0, 2)], hw[(1, 2)])
    # lowest eigenpair (packed argmin over the 3 diagonals)
    is0 = (ew0 <= ew1) & (ew0 <= ew2)
    is1 = (~is0) & (ew1 <= ew2)
    u = [torch.where(is0, eu[i][0], torch.where(is1, eu[i][1], eu[i][2]))
         for i in range(3)]
    return torch.stack([s[i][0] * u[0] + s[i][1] * u[1] + s[i][2] * u[2]
                        for i in range(3)], dim=-1)


def _step_body(matvec: Callable[..., Tensor], nroots: int, rr_every: int,
               sharding=None):
    """One PPCG iteration (fused_ppcg.py:198-290). ``sharding``: the blocks
    and the diagonal are this rank's slices of N. The per-root
    Rayleigh-Ritz and its update take K8's two launches where
    ``rr3.rr3_auto`` says so (float32 on CUDA), with the dots' all-reduce
    between them, and the eager chain elsewhere: launched one by one, the
    chain's ~1,970 small operations held the card idle behind the host."""
    sh = sharding

    def step(state: PPCGState, operand, diag: Tensor) -> PPCGState:
        x, ax, p, ap = state.x, state.ax, state.p, state.ap
        dtype = x.dtype
        tiny = _floor(1e-300, dtype)

        rho = _rows_dot(x, ax, sh)          # x rows orthonormal
        res = ax - rho[:, None] * x
        errors = torch.sqrt(torch.abs(_rows_dot(res, res, sh)))

        # Jacobi-preconditioned correction, projected against X only
        scale_est = pmax(torch.max(torch.abs(diag)), sh) + torch.max(torch.abs(rho))
        w = res / (diag[None, :] - rho[:, None] + 1e-15 * scale_est + tiny)
        w = w - torch.matmul(psum(torch.matmul(w, x.T), sh), x)
        cp = psum(torch.matmul(p, x.T), sh)
        p = p - torch.matmul(cp, x)
        ap = ap - torch.matmul(cp, ax)

        wn2 = _rows_dot(w, w, sh)
        live_w = _flush(wn2) > tiny
        sw = torch.where(live_w, 1.0 / torch.sqrt(torch.where(live_w, wn2, 1.0)), 0.0)
        w = w * sw[:, None]
        pn2 = _rows_dot(p, p, sh)
        # dtype-aware momentum floor: normalising a nearly cancelled p
        # amplifies the carried ap error by 1/|p|; drop the row instead
        eps_p = 1e-24 if dtype == torch.float64 else _floor(1e-6, dtype)
        live_p = pn2 > eps_p
        sp = torch.where(live_p, 1.0 / torch.sqrt(torch.where(live_p, pn2, 1.0)), 0.0)
        p = p * sp[:, None]      # sp is exactly 0 on dead rows: normalises
        ap = ap * sp[:, None]    # and masks in one multiply

        aw = _act(matvec, w, operand)   # the action of the iteration

        with span("ppcg.rr3"):
            if rr3.rr3_auto(x.device, dtype):
                # no name holds the dots or the coefficients past this
                # statement: they add nothing to the solve's peak memory
                x_new, ax_new, p_new, ap_new = rr3.rr3_update(
                    psum(rr3.rr3_dots(x, ax, w, aw, p, ap), sh), live_w, live_p,
                    x, ax, w, aw, p, ap)[:4]
            else:
                c = _rr3_coeffs(_rr3_dots(x, ax, w, aw, p, ap, sh), live_w, live_p, nroots)
                x_new, ax_new, p_new, ap_new = rr3.rr3_update_plain(c, x, ax, w, aw, p, ap)

            # Cholesky-QR keeps the block orthonormal; AX gets the same
            # transform. L^-1 is formed once against the small identity.
            g = psum(torch.matmul(x_new, x_new.T), sh)
            g = g + chol_jitter(dtype) * _eye(nroots, g)
            l = _cholesky_nan(g)
            li = torch.linalg.solve_triangular(l, _eye(nroots, g), upper=False)
            x_new = torch.matmul(li, x_new)
            ax_new = torch.matmul(li, ax_new)

        it = state.it + 1
        if it % rr_every == 0:
            # full RR: re-couple and re-sort the roots, and re-anchor AX
            # with an exact action (the carried block drifts); the
            # momentum block stays carried
            with span("ppcg.full_rr"):
                h = psum(torch.matmul(x_new, ax_new.T), sh)
                h = 0.5 * (h + h.T)
                _, cmat = torch.linalg.eigh(h)
                rot = cmat.T
                x_new = torch.matmul(rot, x_new)
                ax_new = _act(matvec, x_new, operand)
                p_new = torch.matmul(rot, p_new)
                ap_new = torch.matmul(rot, ap_new)
        return PPCGState(x_new, ax_new, p_new, ap_new, rho, errors, it)

    return step


def make_ppcg_init(matvec: Callable[..., Tensor], nroots: int, sharding=None):
    """Orthonormalise the guess, run its action, zero momentum
    (fused_ppcg.py:293-312)."""
    sh = sharding

    def init(v0: Tensor, operand) -> PPCGState:
        g = psum(torch.matmul(v0, v0.T), sh)
        # the jitter is calibrated for unit-scale rows: scale it to the guess
        scale = torch.clamp(torch.max(torch.abs(torch.diagonal(g))),
                            min=_floor(1e-300, g.dtype))
        l = _cholesky_nan(g + (chol_jitter(g.dtype) * scale) * _eye(nroots, g))
        x = lower_solve(l, v0)
        ax = _act(matvec, x, operand)
        rho = _rows_dot(x, ax, sh)
        res = ax - rho[:, None] * x
        errors = torch.sqrt(torch.abs(_rows_dot(res, res, sh)))
        return PPCGState(x, ax, torch.zeros_like(x), torch.zeros_like(x), rho, errors, 0)

    return init


def _not_converged(errors: Tensor, tol: float) -> bool:
    # one scalar sync; NaN > tol is False, so a NaN error ends the loop as
    # in the JAX package (run_on_device's check_finite then raises)
    with span("ppcg.wait"):
        out = bool(torch.max(errors) > tol)
    settle()
    return out


def make_ppcg_step(matvec, nroots: int, rr_every: int = 5, sharding=None):
    """Single iteration: ``step(state, operand, diag) -> state``."""
    return _step_body(matvec, nroots, rr_every, sharding)


def make_ppcg_solve(matvec, nroots: int, rr_every: int = 5, history: int = 0,
                    sharding=None):
    """The whole solve: step until the max error is <= tol or ``max_iter``
    (fused_ppcg.py:319-364). ``solve(state, operand, diag, tol, max_iter)
    -> (final, iterations)``; ``history > 0`` also returns a ``(history,)``
    buffer of each iteration's max residual norm (NaN beyond the run; a run
    longer than ``history`` overwrites the last slot)."""
    step = _step_body(matvec, nroots, rr_every, sharding)

    def solve(state: PPCGState, operand, diag: Tensor, tol_, max_iter_):
        hist = (torch.full((history,), float("nan"), dtype=state.errors.dtype,
                           device=state.errors.device) if history else None)
        s, it = state, 0
        while it < max_iter_ and _not_converged(s.errors, tol_):
            with span("ppcg.iteration"):
                s = step(s, operand, diag)
            if history:
                hist[min(it, history - 1)] = torch.max(s.errors)
            it += 1
        # the step stores the incoming iterate's Rayleigh data: refresh so
        # the returned evals/errors describe the returned x rows
        rho = _rows_dot(s.x, s.ax, sharding)
        res = s.ax - rho[:, None] * s.x
        final = s._replace(evals=rho,
                           errors=torch.sqrt(torch.abs(_rows_dot(res, res, sharding))))
        if history:
            return final, it, hist
        return final, it

    return solve


class FusedPPCG:
    """The PPCG solve on a device: the host only reads the max error between
    iterations.

    Same constructor shape as FusedDavidson without the basis-capacity
    knobs; ``rr_every`` sets the full-RR cadence. ``device=None`` means CUDA
    and raises where CUDA is absent; ``dtype=None`` is float32 on CUDA and
    float64 on the CPU.

    Caveat: a root whose guess is degenerate, or gets knocked off its
    target, has no expanding subspace to rediscover an interior eigenvalue
    and may converge to some other eigenpair. Supply linearly independent
    guesses when the lowest block matters.

    ``sharding`` (parallel/mesh.py): every rank builds the solver with the
    same arguments and a matvec mapping its slice of x to its slice of y;
    ``diagonals`` is global and each rank keeps its slice."""

    def __init__(
        self,
        matvec: Callable[..., Tensor],
        diagonals,
        n: int,
        nroots: int = 1,
        rr_every: int = 5,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 1000,
        operand=None,
        check_symmetric: bool = True,
        device=None,
    ):
        if rr_every < 1:
            raise ValueError("rr_every must be >= 1")
        self.sharding = check_sharding(sharding)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.matvec = matvec
        self.n = n
        self.nroots = nroots
        self.rr_every = rr_every
        self.dtype = dtype
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.operand = operand
        self.diag = to_device(np.array(diagonals), dtype, self.device, self.sharding)
        self._init = make_ppcg_init(matvec, nroots, self.sharding)
        self._solve = make_ppcg_solve(matvec, nroots, rr_every, sharding=self.sharding)
        self.n_orig = n
        self.check_symmetric = check_symmetric
        self._symmetry_checked = False

    @classmethod
    def from_dense_symmetric(cls, matrix, nroots: int = 1, tier: Optional[str] = None,
                             b: Optional[int] = None, device=None,
                             **kwargs) -> "FusedPPCG":
        """Packed-triangle symmetric operator entry: the tiers and tile rule
        of FusedDavidson.from_dense_symmetric."""
        from .fused_davidson import FusedDavidson

        proto = FusedDavidson.from_dense_symmetric(
            np.asarray(matrix, dtype=np.float64), nroots=nroots, tier=tier, b=b,
            device=device, sharding=kwargs.get("sharding"))
        solver = cls(proto.matvec, proto._global(proto.diag).cpu().numpy(), proto.n, nroots,
                     operand=proto.operand, dtype=proto.dtype, device=proto.device,
                     **kwargs)
        solver.n_orig = proto.n_orig
        return solver

    def unpad(self, x) -> np.ndarray:
        """Strip the tile padding from a returned (rows, n_pad) block."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x)[..., : self.n_orig]

    def init_state(self, v0) -> PPCGState:
        with span("ppcg.upload"):
            v0 = v0 if isinstance(v0, torch.Tensor) else torch.as_tensor(np.asarray(v0))
            if self.n_orig != self.n and v0.shape[-1] == self.n_orig:
                pad = torch.zeros(v0.shape[:-1] + (self.n - self.n_orig,),
                                  dtype=v0.dtype, device=v0.device)
                v0 = torch.cat([v0, pad], dim=-1)
            # the guess crosses at its own dtype and narrows on the device:
            # converted on the host first, a (64, 131072) float64 guess took
            # twice as long as the copy of its 8-byte entries to an H100
            v0 = to_device(v0, None, self.device, self.sharding).to(self.dtype).contiguous()
        if self.check_symmetric and not self._symmetry_checked:
            from ._symmetry import check_symmetric_operator

            check_symmetric_operator(
                self.matvec, self.operand, (v0.shape[0], self.n), self.dtype,
                "FusedPPCG",
                "solvers.linear_eigensystem.LinearEigensystemDavidson"
                "(hermitian=False)",
                device=self.device,
                sharding=self.sharding,
            )
            self._symmetry_checked = True
        return self._init(v0, self.operand)

    def run_on_device(self, v0):
        """The whole solve. Returns ``(evals, x, errors, iters)`` with the
        eigenvalues and rows sorted ascending (the periodic RR sorts; the
        final state may be mid-window, so sort on exit). ``x`` stays a
        tensor on the solver's device (gathered under sharding)."""
        with span("ppcg.solve"):
            state = self.init_state(v0)
            final, iters = self._solve(state, self.operand, self.diag, self.tol,
                                       self.max_iter)
            with span("ppcg.wait"):
                evals = final.evals.cpu().numpy()
                errors = final.errors.cpu().numpy()
            settle()
            order = np.argsort(evals)
            x = final.x[torch.as_tensor(order, device=final.x.device)]
            if self.sharding is not None:
                x = self.sharding.gather(x, self.n)
            check_finite(errors, "FusedPPCG")
        return evals[order], x, errors[order], int(iters)

    run = run_on_device
