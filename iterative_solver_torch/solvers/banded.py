"""Band-by-band eigensolver: many lowest roots through a bounded device
footprint (port of iterative_solver_tpu/solvers/banded.py).

The fused families hold (m_max, N) stacks on the device; asking for many
roots multiplies that footprint. This driver solves ``nroots`` lowest
eigenpairs in bands of ``band`` roots, locking each converged band out of
the search space, so the device holds one band's stacks while the locked
history spills to the offload tier.

Two deflation modes:

- ``deflate="device"`` (default, exact): the locked block X_l stays on the
  device and each band solves the spectrally deflated operator
      A' = P A P + sigma (I - P),     P = I - X_l^T X_l,
  which moves every locked root to ``sigma`` (above the search window):
  hard locking, standard Davidson deflation. Right whenever the locked
  block fits the device (it is nroots x N, far smaller than the stacks).
- ``deflate="streamed"``: the locked vectors live in the offload store
  (``StreamedOffloadStore``: disk -> pinned host -> device block streaming)
  and only the last ``band`` of them stay on the device. Each band runs in
  short sweeps; after every sweep the working rows are re-orthogonalised
  against the streamed history (soft locking with a periodic purge). The
  locked history may exceed device memory.

Reference relation: the reference reaches large root counts by growing its
Q space on disk through BufferManager-paged gemms (gemm.h:100-152); this
driver restructures that as fixed-shape fused solves per band with the
history spilled, streamed only at band and sweep boundaries.

``device=None`` is the CUDA device; pass ``device="cpu"`` for the host.
``dtype=None`` is float32 on CUDA and float64 on the CPU (the JAX package
reads ``jax_enable_x64``). The deflation's four thin products are
``torch.matmul`` in full float32 or float64 (TF32 is off, config.py).

``sharding=`` (parallel/mesh.py, e.g. ``block_sharding(mesh)``) runs every
band's fused solve one process per shard of the vector axis: the matvec
maps a rank's slice of x to its slice of y, the locked block on the device
is the rank's slice (its three projections all-reduced), the streamed
mode's store keeps each rank's slice of each locked row in the rank's own
file, and the host's guesses, purges and f64 checks see whole rows
(gathered), the same on every rank. ``solve`` returns whole vectors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import config
from ..array.offload_store import StreamedOffloadStore, _host64
from ..array.vector_ops import to_device
from ..parallel.collectives import psum
from ..parallel.mesh import check_sharding
from .fused_davidson import FusedDavidson

Tensor = torch.Tensor


def make_deflated_davidson_matvec(matvec, sigma: float, sharding=None):
    """A' = P A P + sigma (I - P) with operand = (inner_operand, x_locked).

    x_locked is (L, N) orthonormal; L may be 0 (no-op). Symmetric, the same
    spectrum as A on span(X_l)^perp, the locked roots moved to sigma. Zero
    rows of x_locked are exact no-ops. ``sharding``: v and x_locked are
    this rank's slices and the projections are all-reduced."""

    def wrapped(v, packed):
        op, xl = packed
        if xl.shape[0] == 0:
            return matvec(v, op)
        coef = psum(torch.matmul(v, xl.T), sharding)
        pv = v - torch.matmul(coef, xl)
        av = matvec(pv, op)
        pav = av - torch.matmul(psum(torch.matmul(av, xl.T), sharding), xl)
        return pav + sigma * torch.matmul(coef, xl)

    return wrapped


class BandedEigensolver:
    def __init__(
        self,
        matvec,
        diagonals,
        n: int,
        band: int = 16,
        m_max: Optional[int] = None,
        dtype=None,
        sharding=None,
        convergence_threshold: float = 1e-8,
        max_iter: int = 200,
        operand=None,
        rr: str = "full",
        deflate: str = "device",
        store=None,
        sigma: Optional[float] = None,
        store_block_rows: int = 64,
        device=None,
    ):
        self.sharding = check_sharding(sharding)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        if deflate not in ("device", "streamed"):
            raise ValueError("deflate must be 'device' or 'streamed'")
        self.matvec = matvec
        self.n = n
        self.band = int(band)
        self.m_max = m_max if m_max is not None else max(4 * band, min(n, 24))
        self.dtype = dtype
        self.tol = convergence_threshold
        self.max_iter = max_iter
        self.operand = operand
        self.rr = rr
        self.deflate = deflate
        self.diag = np.asarray(diagonals, dtype=np.float64)
        # sigma: where locked roots land; must clear the sought window
        self.sigma = sigma if sigma is not None else float(
            2.0 * np.max(np.abs(self.diag)) + 1.0)
        if store is None and deflate == "streamed":
            store = StreamedOffloadStore(
                capacity=max(2 * self.band, 8), n=n, dtype=dtype, sharding=self.sharding,
                name="locked", block_rows=store_block_rows, device=self.device)
        self.store = store
        self._locked_slots: list = []
        self._locked_dense = np.zeros((0, n))
        # the streamed mode's last ``band`` locked rows (the device window)
        # and its fused solvers, keyed on (active rows, inner depth)
        self._recent: list = []
        self._stream_solvers: dict = {}
        # (rows, iterations) of every fused solve, in order: a band each in
        # the device mode, a sweep each in the streamed mode
        self.runs: list = []

    # -- locked history -------------------------------------------------
    @property
    def n_locked(self) -> int:
        return len(self._locked_slots)

    def locked_rows(self) -> np.ndarray:
        if not self._locked_slots:
            return np.zeros((0, self.n))
        if self.store is not None:
            return _host64(self._global(self.store.rows(self._locked_slots)))
        return self._locked_dense

    def _lock(self, x: np.ndarray) -> None:
        if self.store is not None:
            for row in x:
                self._locked_slots.append(self.store.append(self._rank_slice(row)))
        else:
            self._locked_dense = np.concatenate([self._locked_dense, x], axis=0)
            self._locked_slots = list(range(self._locked_dense.shape[0]))

    def _device(self, x) -> Tensor:
        """A global (rows, N) host block on the device: this rank's slice
        under sharding."""
        return to_device(np.asarray(x), self.dtype, self.device, self.sharding)

    def _rank_slice(self, x):
        """A global host row or block as the store takes it: this rank's
        slice (float64, on the mesh's device) under sharding."""
        return x if self.sharding is None else self.sharding.shard(x)

    def _global(self, x: Tensor) -> Tensor:
        return x if self.sharding is None else self.sharding.gather(x, self.n)

    def _purge(self, x: np.ndarray) -> np.ndarray:
        """The rows of x projected off the stored locked history (one
        streamed sweep), whole on the host."""
        return _host64(self._global(self.store.mgs_sweep(
            self._rank_slice(x), self._locked_slots, np.ones(self.n_locked))))

    def _fused(self, r: int, max_iter: int, xl: Tensor) -> FusedDavidson:
        """A fused Davidson of ``r`` roots on the deflated operator with the
        locked block ``xl`` on the device."""
        return FusedDavidson(
            make_deflated_davidson_matvec(self.matvec, self.sigma, self.sharding),
            self.diag, self.n, r, m_max=self.m_max, dtype=self.dtype,
            sharding=self.sharding, convergence_threshold=self.tol, max_iter=max_iter,
            operand=(self.operand, xl), rr=self.rr,
            check_symmetric=False,  # the wrapper is symmetric by construction
            device=self.device,
        )

    # -- solve ----------------------------------------------------------
    def solve(self, nroots: int):
        """Returns (eigenvalues (nroots,), X (nroots, N), errors (nroots,))
        for the lowest ``nroots`` eigenpairs, ``band`` at a time, as host
        float64 arrays."""
        all_vals, all_vecs, all_errs = [], [], []
        used = set()
        nbands = (nroots + self.band - 1) // self.band
        for b in range(nbands):
            r = min(self.band, nroots - b * self.band)
            v0 = self._band_guess(r, used)
            if self.deflate == "device":
                evals, x, errs = self._solve_band_device(r, v0)
                self._lock(x)
            else:
                # the streamed mode locks rows into the store as they converge
                evals, x, errs = self._solve_band_streamed(r, v0)
            all_vals.append(evals)
            all_vecs.append(x)
            all_errs.append(errs)
        vals = np.concatenate(all_vals)[:nroots]
        vecs = np.concatenate(all_vecs, axis=0)[:nroots]
        errs = np.concatenate(all_errs)[:nroots]
        order = np.argsort(vals)
        return vals[order], vecs[order], errs[order]

    def _band_guess(self, r: int, used: set) -> np.ndarray:
        """Unit vectors at the lowest unused diagonal entries, orthogonal to
        the locked space (projected off the locked rows, streamed when the
        history lives in the store)."""
        order = [i for i in np.argsort(self.diag) if i not in used][:r]
        used.update(order)
        v0 = np.zeros((r, self.n))
        for row, i in enumerate(order):
            v0[row, i] = 1.0
        if self.n_locked:
            if self.deflate == "streamed":
                v0 = self._purge(v0)
            else:
                xl = self.locked_rows()
                v0 = v0 - (v0 @ xl.T) @ xl
        q, _ = np.linalg.qr(v0.T)
        return np.ascontiguousarray(q.T)

    def _solve_band_device(self, r: int, v0: np.ndarray):
        solver = self._fused(r, self.max_iter, self._device(self.locked_rows()))
        evals, x, errs, it = solver.run_on_device(v0)
        self.runs.append((r, int(it)))
        return np.asarray(evals), _host64(x), np.asarray(errs)

    def _solve_band_streamed(self, r: int, v0: np.ndarray):
        """Soft locking: short fused sweeps, streamed re-orthogonalisation of
        the working rows between sweeps (the locked vectors never enter the
        device whole: they stream block by block through mgs_sweep)."""
        # Four measured rules shape this loop (tests/test_banded.py):
        #
        # 1. SHORT inner solves. Without hard deflation the fused iteration
        #    slides toward the (lower) locked roots; a streamed purge every
        #    couple of iterations keeps the contamination below
        #    Ritz-visibility (~30x growth per iteration from rounding level).
        # 2. LOCK-AS-CONVERGED + shrink. A converged row's residual is pure
        #    noise; its preconditioned expansion direction has O(1) locked
        #    overlap and re-injects the locked space into the basis (the
        #    observed failure mode: three rows converge, the fourth chases a
        #    locked root forever). Rows that pass the f64 bar move into the
        #    store immediately and the active block shrinks, so converged
        #    rows never generate noise directions.
        # 3. FULL-DEPTH solve while nothing is soft-locked. With no history
        #    outside the window there is nothing to purge; restarting every
        #    2 iterations only throws the basis away (band 1 of an n=512
        #    gapped problem converges in one 6-iteration full-depth solve
        #    but burns its whole budget under inner=2). Once such history
        #    exists the depth goes back to 2: deepening between purges
        #    livelocks, since contamination grows ~30x/iteration.
        # 4. WINDOWED hard deflation. The last ``band`` locked vectors stay
        #    on the device inside the deflated matvec: a CONSTANT (band, N)
        #    footprint whatever the total history. Soft purge alone lets the
        #    last active row of a band wander to a wrong state once its
        #    seed's component is stripped (band 2 root 8 of an n=512 gapped
        #    problem converged into the upper cluster, eigenvalue off by
        #    3.7); the spectrally adjacent locked roots are the ones the
        #    preconditioned residual re-amplifies, and they are always
        #    inside the window. Older history keeps the streamed purge.
        W = self.band

        def recent_window() -> Tensor:
            xl = np.zeros((W, self.n))
            rows = self._recent[-W:]
            if rows:  # zero rows are exact no-ops in the wrapper
                xl[:len(rows)] = np.stack(rows)
            return self._device(xl)

        done_vals, done_vecs, done_res = [], [], []
        active = v0
        total_iter = 0
        while active.shape[0] and total_iter < self.max_iter:
            # full depth while every locked vector is hard-deflated by the
            # window (nothing for a purge to catch); shallow purge cycles
            # once soft-only history exists
            inner = self.max_iter if len(self._locked_slots) <= W else 2
            ra = active.shape[0]
            solver = self._stream_solvers.get((ra, inner))
            if solver is None:
                solver = self._fused(ra, inner, recent_window())
                self._stream_solvers[(ra, inner)] = solver
            solver.operand = (self.operand, recent_window())
            evals, x, errs, it = solver.run_on_device(active)
            self.runs.append((ra, int(it)))
            total_iter += max(int(it), 1)
            x = _host64(x)
            if self._locked_slots:
                x = self._purge(x)
            q, _ = np.linalg.qr(x.T)
            x = np.ascontiguousarray(q.T)
            # accept on the f64 residual of the PURGED rows against the real
            # operator: the inner solver's errors can belong to
            # locked-leaning states
            rq, res = self._f64_check(x)
            bar = max(self.tol * 10, 1e-12)
            keep = []
            for i in range(x.shape[0]):
                if res[i] <= bar:
                    done_vals.append(rq[i])
                    done_vecs.append(x[i])
                    done_res.append(res[i])
                    self._locked_slots.append(self.store.append(self._rank_slice(x[i])))
                    self._recent.append(x[i])
                else:
                    keep.append(i)
            # only the last W rows ever enter the deflation window: keep the
            # host copy bounded instead of duplicating the locked history
            self._recent = self._recent[-W:]
            active = x[keep]
        if active.shape[0]:
            # budget exhausted: return the leftovers as they are (the caller
            # sees the residuals) rather than pretending convergence
            rq, res = self._f64_check(active)
            for i in range(active.shape[0]):
                done_vals.append(rq[i])
                done_vecs.append(active[i])
                done_res.append(res[i])
                self._locked_slots.append(self.store.append(self._rank_slice(active[i])))
                self._recent.append(active[i])
            self._recent = self._recent[-W:]
        order = np.argsort(done_vals)
        return (np.asarray(done_vals)[order],
                np.asarray(done_vecs)[order],
                np.asarray(done_res)[order])

    def _f64_check(self, x: np.ndarray):
        """Rayleigh quotients and residual norms through the device matvec,
        read to the host (one action per sweep boundary)."""
        ax = _host64(self._global(self.matvec(self._device(x), self.operand)))
        rq = np.einsum("in,in->i", x, ax)
        res = np.linalg.norm(ax - rq[:, None] * x, axis=1)
        return rq, res
