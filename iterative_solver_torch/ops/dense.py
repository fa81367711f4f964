"""Dense subspace kernels, host tier (numpy copy of iterative_solver_tpu/ops/dense.py).

These are the small, replicated dense solves at the heart of every subspace
iterative method: the generalized eigenproblem with overlap-conditioning, the
linear-equation / augmented-Hessian solve, the DIIS extrapolation, and the
SVD-based null-space analysis used for subspace hygiene.

Subspace matrices are tiny (<= a few hundred squared), so — exactly like the
reference library, which runs LAPACK redundantly on every MPI rank
(reference: src/molpro/linalg/itsolv/helper-implementation.h) — we evaluate
them on the host in float64 while all O(N) vector work runs on the device.
Semantics (conditioning thresholds, sort order, phase fixing, complex-pair
handling) reproduce the reference:

- ``eigenproblem``          <- helper-implementation.h:318-543
- ``solve_linear_equations`` <- helper-implementation.h:553-617
- ``solve_diis``            <- helper-implementation.h:619-669
- ``svd_system``            <- helper-implementation.h:263-296
- ``eigensolver_descending`` <- helper-implementation.h:166-200
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = [
    "SVDSystem",
    "eigensolver_descending",
    "svd_system",
    "get_rank",
    "eigenproblem",
    "solve_linear_equations",
    "solve_diis",
]


@dataclasses.dataclass
class SVDSystem:
    """One (near-)singular mode of a matrix: its value and right-singular vector."""

    value: float
    v: np.ndarray


def eigensolver_descending(matrix: np.ndarray) -> List[SVDSystem]:
    """Symmetric eigendecomposition returned as descending-eigenvalue systems.

    Mirrors the reference's dsyev wrapper which flips LAPACK's ascending order
    (helper-implementation.h:190-196) so the list starts at the largest
    eigenvalue. Complex-hermitian input uses the same path (eigh); eigenvalues
    are real either way.
    """
    matrix = np.asarray(matrix)
    matrix = matrix.astype(np.complex128 if np.iscomplexobj(matrix) else np.float64)
    dim = matrix.shape[0]
    if dim == 0:
        return []
    evals, evecs = np.linalg.eigh(matrix)
    return [SVDSystem(float(evals[i]), evecs[:, i].copy()) for i in range(dim - 1, -1, -1)]


def svd_system(
    m: np.ndarray,
    threshold: float,
    hermitian: bool = False,
    reduce_to_rank: bool = False,
) -> List[SVDSystem]:
    """Return the (near-)null-space systems of ``m`` below ``threshold``.

    hermitian: eigendecomposition, keep eigenvalues <= threshold (descending
    order). Otherwise: SVD, keep singular values < threshold (ascending
    order). Mirrors helper-implementation.h:263-296 including the ordering of
    each branch, which downstream deletion heuristics depend on.

    Complex inputs are supported (the reference's std::complex<double>
    instantiation is an assert(false) stub, helper-implementation.h:298-303;
    here the same code path handles both, with conjugate-transpose
    semantics).
    """
    m = np.asarray(m)
    m = m.astype(np.complex128 if np.iscomplexobj(m) else np.float64)
    if m.size == 0:
        return []
    nrows, ncols = m.shape
    if hermitian:
        assert nrows == ncols
        systems = [s for s in eigensolver_descending(m) if s.value <= threshold]
    else:
        _, sv, vt = np.linalg.svd(m, full_matrices=True)
        systems = []
        for i in range(ncols - 1, -1, -1):
            value = float(sv[i]) if i < sv.size else 0.0
            if abs(value) < threshold:
                systems.append(SVDSystem(value, vt[i, :].copy()))
    if reduce_to_rank:
        rank = get_rank(systems, threshold)
        n_pop = ncols - rank
        for _ in range(min(n_pop, len(systems))):
            systems.pop()
    return systems


def get_rank(systems, threshold: float) -> int:
    """Count systems whose value exceeds ``threshold * max_value``.

    (helper-implementation.h:230-259; threshold is relative to the largest
    value present.)
    """
    if not systems:
        return 0
    if isinstance(systems[0], SVDSystem):
        values = [s.value for s in systems]
    else:
        values = list(systems)
    max_value = max(values)
    scaled = threshold * max_value
    return sum(1 for v in values if v > scaled)


def _rank_from_values(values: np.ndarray, threshold: float) -> int:
    """get_rank for a plain array, counting values >= threshold*max (helper-implementation.h:236-244)."""
    if values.size == 0:
        return 0
    scaled = threshold * float(values.max())
    return int(np.count_nonzero(values >= scaled))


def eigenproblem(
    h: np.ndarray,
    s: np.ndarray,
    hermitian: bool,
    svd_thresh: float,
    condone_complex: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized eigenproblem H c = e S c with overlap conditioning.

    Returns ``(eigenvalues, eigenvectors)`` where ``eigenvectors[i]`` is the
    subspace coefficient row-vector of solution ``i``; solutions are sorted by
    ascending real eigenvalue with the reference's sign convention (largest
    |component| made positive). The overlap is whitened through its
    eigen/SVD decomposition with near-null directions (< 1e-14) zeroed, so a
    rank-deficient subspace yields fewer solutions than its dimension.

    Port of helper-implementation.h:318-543 (semantics, not code).

    Complex-valued H/S are handled natively (hermitian: complex eigh with
    conjugate-transpose whitening; else complex eig) — the reference's
    std::complex<double> instantiation is an assert(false) stub
    (helper-implementation.h:311-316, IterativeSolver-complex-double.cpp),
    so this is a capability extension, returning complex eigenvectors with
    real eigenvalues (hermitian) or complex eigenvalues (non-hermitian).
    """
    if np.iscomplexobj(h) or np.iscomplexobj(s):
        return _eigenproblem_complex(h, s, hermitian, svd_thresh)
    h = np.asarray(h, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    dim = h.shape[0]
    if dim == 0:
        return np.zeros(0), np.zeros((0, 0))

    if hermitian:
        # Whiten with the eigendecomposition of S in DESCENDING order so a
        # rank-reduced subspace keeps the dominant directions. (The reference
        # takes head(rank) of LAPACK's ascending order,
        # helper-implementation.h:345-358 — harmless there because its S is
        # kept orthonormal, but wrong for genuinely rank-deficient overlaps;
        # this matches the non-hermitian SVD branch's convention.)
        sv, u = np.linalg.eigh(s)
        sv = sv[::-1]
        u = np.ascontiguousarray(u[:, ::-1])
        v = u
        rank = _rank_from_values(sv, svd_thresh)
        head = sv[:rank]
    else:
        # Whiten with the SVD of S (descending); Eigen's default rank rule.
        u, sv, vt = np.linalg.svd(s)
        v = vt.T
        eps = np.finfo(np.float64).eps
        rank = int(np.count_nonzero(sv > max(s.shape) * eps * (sv[0] if sv.size else 0.0)))
        head = sv[:rank]

    svmh = np.where(head > 1e-14, 1.0 / np.sqrt(np.where(head > 1e-14, head, 1.0)), 0.0)
    hbar = (svmh[:, None] * u[:, :rank].T) @ h @ (v[:, :rank] * svmh[None, :])

    evals_c, evecs_c = np.linalg.eig(hbar)
    evals = evals_c.astype(complex)
    evecs = evecs_c.astype(complex)

    if np.linalg.norm(evals.imag) < 1e-10:
        evals = evals.real.astype(complex)
        # Rotate consecutive complex-conjugate eigenvector pairs onto their
        # real/imag parts (helper-implementation.h:389-403).
        for i in range(evecs.shape[1]):
            if np.linalg.norm(evecs[:, i].imag) > 1e-10:
                j = i + 1
                if (
                    j < evecs.shape[1]
                    and abs(evals[i] - evals[j]) < 1e-10
                    and np.linalg.norm(evecs[:, j].imag) > 1e-10
                ):
                    im = evecs[:, i].imag
                    re = evecs[:, i].real
                    evecs[:, j] = im / np.linalg.norm(im)
                    evecs[:, i] = re / np.linalg.norm(re)
        evecs = (v[:, :rank] * svmh[None, :]) @ evecs
    else:
        evecs = (v[:, :rank] * svmh[None, :]) @ evecs

    # Sort ascending by real part (stable insertion scan, matching
    # helper-implementation.h:416-448) and fix phases.
    order = np.argsort(evals.real, kind="stable")
    evals = evals[order]
    evecs = evecs[:, order]
    for k in range(evecs.shape[1]):
        col = evecs[:, k]
        maxcomp = int(np.argmax(np.abs(col.real)))
        if col.real[maxcomp] < 0:
            evecs[:, k] = -col

    if not hermitian:
        # Normalise in the S metric and re-fix phases; repeated thrice as in
        # the reference (helper-implementation.h:457-517). A zero eigenvalue's
        # vector is rotated to a definite real direction.
        for _ in range(3):
            for k in range(evecs.shape[1]):
                if abs(evals[k]) < 1e-12:
                    evecs[:, k] = evecs[:, k].real + 0.3256897 * evecs[:, k].imag
                ovl = np.vdot(evecs[:, k], s @ evecs[:, k])
                evecs[:, k] = evecs[:, k] / np.sqrt(ovl.real)
                lmax = int(np.argmax(np.abs(evecs[:, k])))
                if evecs[lmax, k].real < 0:
                    evecs[:, k] = -evecs[:, k]

    if condone_complex:
        root = 0
        n = evecs.shape[1]
        while root < n:
            if evals[root].imag != 0 and root + 1 < n:
                re = evals[root].real
                evals[root] = re
                evals[root + 1] = re
                evecs[:, root] = evecs[:, root].real
                evecs[:, root + 1] = evecs[:, root + 1].imag
                root += 1
            root += 1

    if (
        np.linalg.norm(evecs - evecs.real) > 1e-10
        or np.linalg.norm(evals - evals.real) > 1e-10
    ):
        raise RuntimeError("unexpected complex solution found")

    return evals.real.copy(), np.ascontiguousarray(evecs.real.T)


def _eigenproblem_complex(
    h: np.ndarray,
    s: np.ndarray,
    hermitian: bool,
    svd_thresh: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Complex generalized eigenproblem (capability the reference stubs out).

    Same conditioning semantics as the real path: whiten through the overlap
    decomposition with near-null directions (< 1e-14) removed, solve the
    whitened problem, sort ascending by real part, and fix each vector's
    phase so its largest-magnitude component is real-positive (the complex
    generalisation of the reference's sign convention,
    helper-implementation.h:449-455)."""
    h = np.asarray(h, dtype=np.complex128)
    s = np.asarray(s, dtype=np.complex128)
    dim = h.shape[0]
    if dim == 0:
        return np.zeros(0), np.zeros((0, 0), dtype=np.complex128)

    if hermitian:
        sv, u = np.linalg.eigh(s)
        sv = sv[::-1].real
        u = np.ascontiguousarray(u[:, ::-1])
        v = u
        rank = _rank_from_values(sv, svd_thresh)
        head = sv[:rank]
    else:
        u, sv, vh = np.linalg.svd(s)
        v = vh.conj().T
        eps = np.finfo(np.float64).eps
        rank = int(np.count_nonzero(sv > max(s.shape) * eps * (sv[0] if sv.size else 0.0)))
        head = sv[:rank]

    svmh = np.where(head > 1e-14, 1.0 / np.sqrt(np.where(head > 1e-14, head, 1.0)), 0.0)
    hbar = (svmh[:, None] * u[:, :rank].conj().T) @ h @ (v[:, :rank] * svmh[None, :])

    if hermitian:
        evals, evecs = np.linalg.eigh(0.5 * (hbar + hbar.conj().T))
        evals = evals.astype(np.complex128)
    else:
        evals, evecs = np.linalg.eig(hbar)
    evecs = (v[:, :rank] * svmh[None, :]) @ evecs

    order = np.argsort(evals.real, kind="stable")
    evals = evals[order]
    evecs = evecs[:, order]
    for k in range(evecs.shape[1]):
        col = evecs[:, k]
        lmax = int(np.argmax(np.abs(col)))
        phase = col[lmax]
        if abs(phase) > 0:
            evecs[:, k] = col * (abs(phase) / phase)
    if hermitian:
        evals = evals.real.copy()
    return evals, np.ascontiguousarray(evecs.T)


def solve_linear_equations(
    h: np.ndarray,
    s: np.ndarray,
    rhs: np.ndarray,
    augmented_hessian: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the subspace linear equations H x = rhs (one column per root).

    With ``augmented_hessian > 0`` each root is solved through the bordered
    (nX+1) generalized eigenproblem whose lowest eigenvector yields the level-
    shifted solution (helper-implementation.h:558-594); otherwise a direct
    dense solve (householder-QR equivalent) is used.

    ``rhs`` has shape (nX, nroot). Returns ``(solutions, eigenvalues)`` with
    ``solutions[root]`` the coefficient row.

    Complex H/rhs take the direct-solve path natively (the reference stubs
    complex entirely, helper-implementation.h:545-551); the augmented-Hessian
    branch remains real-only like the reference.
    """
    import scipy.linalg

    if np.iscomplexobj(h) or np.iscomplexobj(rhs):
        if augmented_hessian > 0:
            raise NotImplementedError("augmented Hessian is real-only (as in the reference)")
        h = np.asarray(h, dtype=np.complex128)
        n_x = h.shape[0]
        rhs = np.asarray(rhs, dtype=np.complex128).reshape(n_x, -1)
        return np.linalg.solve(h, rhs).T, np.zeros(rhs.shape[1])
    h = np.asarray(h, dtype=np.float64)
    rhs = np.asarray(rhs, dtype=np.float64)
    n_x = h.shape[0]
    nroot = rhs.shape[1] if rhs.ndim == 2 else 1
    rhs = rhs.reshape(n_x, nroot)
    eigenvalues = np.zeros(nroot)
    solutions = np.zeros((nroot, n_x))
    if augmented_hessian > 0:
        s = np.asarray(s, dtype=np.float64)
        for root in range(nroot):
            a = np.zeros((n_x + 1, n_x + 1))
            b = np.zeros((n_x + 1, n_x + 1))
            a[:n_x, :n_x] = h
            b[:n_x, :n_x] = s
            a[:n_x, n_x] = a[n_x, :n_x] = -augmented_hessian * rhs[:, root]
            b[n_x, n_x] = 1.0
            evals, evecs = scipy.linalg.eig(a, b)
            imax = int(np.argmin(evals.real))
            eigenvalues[root] = evals[imax].real
            vec = evecs[:, imax].real
            solutions[root] = vec[:n_x] / (augmented_hessian * vec[n_x])
    else:
        solutions = np.linalg.solve(h, rhs).T
    return solutions, eigenvalues


def gram_schmidt_transform(s: np.ndarray, norm_thresh: float = 0.0) -> np.ndarray:
    """Lower-triangular transformation L (unit diagonal) such that the rows of
    L·V are mutually orthogonal, computed purely from the overlap S = V V^T.

    Port of subspace/gram_schmidt.h:38-69: row i projects out all previous
    transformed rows; rows whose transformed norm² falls below ``norm_thresh``
    contribute no further projections.
    """
    s = np.asarray(s, dtype=np.float64)
    n = s.shape[0]
    l = np.eye(n)
    norms2 = np.zeros(n)
    for i in range(n):
        for j in range(i):
            if norms2[j] > norm_thresh:
                # <v_i, w_j> = row_i(S) . l_j
                ov = float(s[i] @ l[j])
                l[i] -= (ov / norms2[j]) * l[j]
        norms2[i] = float(l[i] @ s @ l[i])
    return l


def solve_diis(b: np.ndarray) -> np.ndarray:
    """DIIS extrapolation coefficients from the residual-overlap matrix ``b``.

    Solves the bordered system [[B, -1], [-1, 0]] c = [0, ..., 0, -1] by SVD
    pseudo-inverse. The reference multiplies its SVD cutoff by zero
    (helper-implementation.h:648), i.e. plain least-squares — so no threshold
    parameter is exposed here.
    """
    b = np.asarray(b, dtype=np.float64)
    dim = b.shape[0]
    baug = np.zeros((dim + 1, dim + 1))
    baug[:dim, :dim] = b
    baug[dim, :dim] = -1.0
    baug[:dim, dim] = -1.0
    rhs = np.zeros(dim + 1)
    rhs[dim] = -1.0
    coeffs, *_ = np.linalg.lstsq(baug, rhs, rcond=None)
    if np.any(np.isnan(coeffs)):
        raise OverflowError("NaN detected in DIIS submatrix solution")
    return coeffs[:dim]
