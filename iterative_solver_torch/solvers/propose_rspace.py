"""Davidson subspace hygiene: Q-size limiting, D-space compression, and
orthonormalisation of new expansion vectors (port of
iterative_solver_tpu/solvers/propose_rspace.py).

The semantics of the reference's propose_rspace.h (:553-624 main flow,
:310-512 helpers) and DSpaceResetter.h. All decision logic runs on the host
over the tiny subspace matrices; the only device work is

- building the new D vectors (one ``combine`` per store),
- the overlap rows of the new residuals (one gram per store),
- the modified-Gram-Schmidt sweep (``BasisStore.mgs_sweep``).

Functions return new blocks and leave the caller's ``parameters`` alone,
as the JAX package's do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import vector_ops as vops
from ..array.basis_store import _host
from ..ops import dense
from ..parallel.collectives import psum
from ..subspace.dimensions import Dimensions
from ..subspace.xspace import XSpace
from ..utils import Logger

Tensor = torch.Tensor


def _take(block: Tensor, keep: List[int]) -> Tensor:
    """The rows ``keep`` of ``block`` (no rows when ``keep`` is empty)."""
    return block[torch.as_tensor(keep, dtype=torch.long, device=block.device)]


# ---------------------------------------------------------------------------
def limit_qspace_size(
    dims: Dimensions, max_size_qspace: int, solutions: np.ndarray, logger: Optional[Logger] = None
) -> List[int]:
    """Q indices to delete: repeatedly drop the Q vector whose largest
    contribution to any solution is smallest (propose_rspace.h:310-336)."""
    q_delete: List[int] = []
    q_indices = list(range(dims.nQ))
    nsol = solutions.shape[0]
    while len(q_indices) > max_size_qspace:
        contrib = [
            max(abs(solutions[j, dims.oQ + i]) for j in range(nsol)) if nsol else 0.0
            for i in q_indices
        ]
        imin = int(np.argmin(contrib))
        q_delete.append(q_indices.pop(imin))
    return q_delete


# ---------------------------------------------------------------------------
def construct_projected_solution(
    solutions: np.ndarray, dims: Dimensions, remove_qspace: Sequence[int]
) -> np.ndarray:
    """Solution coefficients restricted to [Q_deleted, D] (propose_rspace.h:40-58)."""
    nqd = len(remove_qspace)
    nsol = solutions.shape[0]
    proj = np.zeros((nsol, nqd + dims.nD))
    for j, iq in enumerate(remove_qspace):
        proj[:, j] = solutions[:, dims.oQ + iq]
    proj[:, nqd:] = solutions[:, dims.oD : dims.oD + dims.nD]
    return proj


def _proj_subspace_indices(dims: Dimensions, remove_qspace: Sequence[int]) -> List[int]:
    return [dims.oQ + i for i in remove_qspace] + [dims.oD + j for j in range(dims.nD)]


def construct_projected_solutions_overlap(
    solutions_proj: np.ndarray, overlap: np.ndarray, dims: Dimensions, remove_qspace: Sequence[int]
) -> np.ndarray:
    """Overlap of the projected solutions, C S_sub C^T (propose_rspace.h:75-110)."""
    idx = _proj_subspace_indices(dims, remove_qspace)
    s_sub = overlap[np.ix_(idx, idx)]
    ov = solutions_proj @ s_sub @ solutions_proj.T
    return 0.5 * (ov + ov.T)


def remove_null_norm_and_normalise(
    parameters: np.ndarray, overlap: np.ndarray, norm_thresh: float, logger: Optional[Logger] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop rows with norm below threshold, normalise the rest
    (propose_rspace.h:117-146)."""
    norms = np.sqrt(np.abs(np.diag(overlap)))
    keep = norms > norm_thresh
    parameters = parameters[keep] / norms[keep][:, None]
    overlap = overlap[np.ix_(keep, keep)] / np.outer(norms[keep], norms[keep])
    return parameters, overlap


def remove_null_projected_solutions(
    solutions_proj: np.ndarray, overlap_proj: np.ndarray, svd_thresh: float
) -> np.ndarray:
    """Rotate onto the stable eigenvectors of the projected overlap, smallest
    first (propose_rspace.h:152-183: keep eigenvalue >= svd_thresh, ascending)."""
    systems = dense.svd_system(overlap_proj, threshold=np.inf, hermitian=True)
    systems = [s for s in systems if s.value >= svd_thresh]
    systems.sort(key=lambda s: s.value)
    if not systems:
        return np.zeros((0, solutions_proj.shape[1]))
    rot = np.stack([s.v for s in systems], axis=0)  # (nD, nProj)
    return rot @ solutions_proj


def construct_full_subspace_overlap(
    solutions_proj: np.ndarray,
    dims: Dimensions,
    remove_qspace: Sequence[int],
    overlap: np.ndarray,
) -> np.ndarray:
    """Overlap of [P, Q_kept, D_new] where D_new are the projected solutions
    (propose_rspace.h:189-256 with nR=0)."""
    nd_new = solutions_proj.shape[0]
    keep_q = [i for i in range(dims.nQ) if i not in set(remove_qspace)]
    keep_idx = [dims.oP + j for j in range(dims.nP)] + [dims.oQ + i for i in keep_q]
    proj_idx = _proj_subspace_indices(dims, remove_qspace)
    o_new = len(keep_idx)
    ov = np.zeros((o_new + nd_new, o_new + nd_new))
    ov[:o_new, :o_new] = overlap[np.ix_(keep_idx, keep_idx)]
    cross = solutions_proj @ overlap[np.ix_(proj_idx, keep_idx)]
    ov[o_new:, :o_new] = cross
    ov[:o_new, o_new:] = cross.T
    dd = solutions_proj @ overlap[np.ix_(proj_idx, proj_idx)] @ solutions_proj.T
    ov[o_new:, o_new:] = 0.5 * (dd + dd.T)
    return ov


# ---------------------------------------------------------------------------
def construct_dspace(
    solutions: np.ndarray,
    xspace: XSpace,
    q_delete: Sequence[int],
    norm_thresh: float,
    svd_thresh: float,
    logger: Optional[Logger] = None,
) -> Tuple[Tensor, Tensor]:
    """Build the new D space from solutions projected on deleted-Q + old-D
    (propose_rspace.h:349-403). Returns device blocks (nD, N) x2."""
    dims = xspace.dimensions
    overlap = xspace.s
    proj = construct_projected_solution(solutions, dims, q_delete)
    ov_proj = construct_projected_solutions_overlap(proj, overlap, dims, q_delete)
    proj, ov_proj = remove_null_norm_and_normalise(proj, ov_proj, norm_thresh, logger)
    proj = remove_null_projected_solutions(proj, ov_proj, svd_thresh)
    ov_proj = construct_projected_solutions_overlap(proj, overlap, dims, q_delete)
    proj, ov_proj = remove_null_norm_and_normalise(proj, ov_proj, norm_thresh, logger)

    nd = proj.shape[0]
    if nd == 0:
        empty = torch.zeros((0, xspace.width), dtype=xspace.dtype, device=xspace.device)
        return empty, empty

    # device: one combine per store over [deleted-Q, old-D] vectors
    v_slots = [xspace.q_slots[i][0] for i in q_delete] + [s[0] for s in xspace.d_slots]
    a_slots = [xspace.q_slots[i][1] for i in q_delete] + [s[1] for s in xspace.d_slots]
    dparams = xspace.store_v.combine(proj, v_slots)
    dactions = xspace.store_a.combine(proj, a_slots)
    norms = _host(vops.norms_rows(dparams, xspace.sharding)).astype(float)
    inv = vops.to_device(1.0 / norms, xspace.dtype, xspace.device)
    dparams = vops.scale_rows(inv, dparams)
    dactions = vops.scale_rows(inv, dactions)
    return dparams, dactions


# ---------------------------------------------------------------------------
def append_overlap_with_r(xspace: XSpace, rparams: Tensor) -> np.ndarray:
    """Overlap of [P, Q, D, R]: existing S plus one gram of the R block
    against the parameter stack (propose_rspace.h:271-300)."""
    dims = xspace.dimensions
    nr = rparams.shape[0]
    nx = dims.nX
    ov = np.zeros((nx + nr, nx + nr))
    ov[:nx, :nx] = xspace.s
    gv = xspace.store_v.gram_block(rparams)
    slots = (
        list(xspace.p_slots)
        + [s[0] for s in xspace.q_slots]
        + [s[0] for s in xspace.d_slots]
    )
    cross = gv[:, slots] if slots else np.zeros((nr, 0))
    ov[nx:, :nx] = cross
    ov[:nx, nx:] = cross.T
    ov[nx:, nx:] = _host(vops.gram_sym(rparams, xspace.sharding))
    return ov


def redundant_parameters(
    overlap: np.ndarray, o_r: int, n_r: int, svd_thresh: float, logger: Optional[Logger] = None
) -> List[int]:
    """For each near-null singular system of the overlap, mark the R parameter
    with the largest contribution as redundant (propose_rspace.h:481-512)."""
    redundant: List[int] = []
    rspace_indices = list(range(n_r))
    systems = dense.svd_system(overlap, svd_thresh, hermitian=True, reduce_to_rank=True)
    for system in systems:
        if not rspace_indices:
            break
        contrib = [abs(system.v[o_r + i]) for i in rspace_indices]
        imax = int(np.argmax(contrib))
        redundant.append(rspace_indices.pop(imax))
    return redundant


# ---------------------------------------------------------------------------
def modified_gram_schmidt(
    rparams: Tensor,
    xspace: XSpace,
    norm_thresh: float,
) -> Tuple[Tensor, List[int]]:
    """Orthogonalise R against P+Q+D (one fused device sweep) then among
    themselves; rows whose remaining norm falls below ``norm_thresh`` are
    null (propose_rspace.h:421-466). Returns the updated block and null
    indices."""
    dims = xspace.dimensions
    slots = (
        list(xspace.p_slots)
        + [s[0] for s in xspace.q_slots]
        + [s[0] for s in xspace.d_slots]
    )
    diag = np.abs(np.diag(xspace.s))
    inv_norms = np.asarray(
        [1.0 / diag[i] if diag[i] != 0 else 0.0 for i in range(len(slots))]
    )
    rparams = xspace.store_v.mgs_sweep(rparams, slots, inv_norms)

    # pairwise orthonormalisation among the R rows (host loop, tiny count)
    null_params: List[int] = []
    nr = rparams.shape[0]
    rparams = rparams.clone()  # updated row by row below
    for i in range(nr):
        norm = float(torch.sqrt(torch.abs(psum(torch.dot(rparams[i], rparams[i]),
                                               xspace.sharding))))
        if norm > norm_thresh:
            rparams[i] = rparams[i] / norm
            if i + 1 < nr:
                dots = vops.gram(rparams[i + 1:], rparams[i: i + 1],
                                 xspace.sharding)  # (nr-i-1, 1)
                rparams[i + 1:] = rparams[i + 1:] + (-dots * rparams[i][None, :])
        else:
            null_params.append(i)
    return rparams, null_params


def normalise_block(rparams: Tensor, thresh: float = 1.0e-14, sharding=None) -> Tensor:
    """Normalise rows unless their norm is below ``thresh`` (propose_rspace.h:18-28)."""
    normed, _ = vops.normalize_rows(rparams, thresh, sharding)
    return normed


# ---------------------------------------------------------------------------
def propose_rspace(
    solver,
    parameters: Tensor,
    residuals: Tensor,
    xspace: XSpace,
    subspace_solver,
    logger: Logger,
    svd_thresh: float,
    norm_thresh: float,
    max_size_qspace: int,
) -> Tuple[List[int], Tensor]:
    """Propose new orthonormal expansion vectors from preconditioned residuals
    (propose_rspace.h:553-624). Returns (new_working_set, parameters) with the
    proposals in the leading rows of ``parameters``."""
    solutions = subspace_solver.solutions
    q_delete = limit_qspace_size(xspace.dimensions, max_size_qspace, solutions, logger)
    if q_delete:
        dparams, dactions = construct_dspace(
            solutions, xspace, q_delete, norm_thresh, svd_thresh, logger
        )
        for iq in sorted(q_delete, reverse=True):
            xspace.eraseq(iq)
        xspace.update_dspace(dparams, dactions)
        eigenvalues_ref = np.asarray(subspace_solver.eigenvalues)
        subspace_solver.solve(xspace, solutions.shape[0])
        eigval_error = np.abs(
            eigenvalues_ref[: len(subspace_solver.eigenvalues)]
            - np.asarray(subspace_solver.eigenvalues)[: len(eigenvalues_ref)]
        )
        logger.msg_values("eigenvalue error due to new D space = ", eigval_error.tolist(), level=5)

    nw = len(solver.working_set)
    wresidual = residuals[:nw]
    surviving = list(range(nw))

    wresidual = normalise_block(wresidual, sharding=xspace.sharding)
    full_overlap = append_overlap_with_r(xspace, wresidual)
    redundant = redundant_parameters(
        full_overlap, xspace.dimensions.nX, nw, svd_thresh, logger
    )
    if redundant:
        keep = [i for i in range(wresidual.shape[0]) if i not in set(redundant)]
        wresidual = _take(wresidual, keep)
        surviving = [surviving[i] for i in keep]

    if wresidual.shape[0]:
        wresidual, null_indices = modified_gram_schmidt(wresidual, xspace, norm_thresh)
        if null_indices:
            keep = [i for i in range(wresidual.shape[0]) if i not in set(null_indices)]
            wresidual = _take(wresidual, keep)
            surviving = [surviving[i] for i in keep]
        wresidual = normalise_block(wresidual, sharding=xspace.sharding)

    k = wresidual.shape[0]
    if k:
        parameters = torch.cat([wresidual, parameters[k:]], dim=0)
    new_working_set = [solver.working_set[i] for i in surviving]
    return new_working_set, parameters


# ---------------------------------------------------------------------------
class DSpaceResetter:
    """Periodically promote full solutions into the Q space and clear D
    (reference: DSpaceResetter.h:69-146)."""

    def __init__(self, nreset: int = np.iinfo(np.int32).max, max_qsize: int = np.iinfo(np.int32).max):
        self.nreset = nreset
        self.max_qsize_after_reset = max_qsize
        self.solution_params: List[Tensor] = []

    def do_reset(self, iteration: int, dims: Dimensions) -> bool:
        return ((iteration + 1) % self.nreset == 0 and dims.nD > 0) or bool(self.solution_params)

    def run(
        self,
        parameters: Tensor,
        xspace: XSpace,
        solutions: np.ndarray,
        norm_thresh: float,
        svd_thresh: float,
        logger: Logger,
    ) -> Tuple[List[int], Tensor]:
        dims = xspace.dimensions
        nrows = parameters.shape[0]
        if not self.solution_params and nrows:
            q_indices = list(range(dims.nQ))
            proj = construct_projected_solution(solutions, dims, q_indices)
            ov = construct_projected_solutions_overlap(proj, xspace.s, dims, q_indices)
            proj, ov = remove_null_norm_and_normalise(proj, ov, norm_thresh, logger)
            proj = remove_null_projected_solutions(proj, ov, svd_thresh)
            ov = construct_projected_solutions_overlap(proj, xspace.s, dims, q_indices)
            proj, ov = remove_null_norm_and_normalise(proj, ov, norm_thresh, logger)
            v_slots = [s[0] for s in xspace.q_slots] + [s[0] for s in xspace.d_slots]
            block = xspace.store_v.combine(proj, v_slots)
            self.solution_params = [block[i] for i in range(proj.shape[0])]
            empty = torch.zeros((0, xspace.width), dtype=xspace.dtype, device=xspace.device)
            xspace.update_dspace(empty, empty)

        nr = min(nrows, len(self.solution_params))
        if nr:
            parameters = parameters.clone()
        for i in range(nr):
            parameters[i] = self.solution_params.pop(0)

        # delete Q vectors with maximum overlap to the new R rows
        # (max_overlap_with_R, DSpaceResetter.h:32-54)
        if nr and xspace.q_slots:
            rblock = parameters[:nr]
            q_slots = [s[0] for s in xspace.q_slots]
            overlap = xspace.store_v.gram(rblock, q_slots)
            q_indices = list(range(len(q_slots)))
            q_max_overlap: List[int] = []
            for i in range(nr):
                if not q_indices:
                    break
                ov = [abs(overlap[i, j]) for j in q_indices]
                imax = int(np.argmax(ov))
                q_max_overlap.append(q_indices.pop(imax))
            for iq in sorted(q_max_overlap, reverse=True):
                xspace.eraseq(iq)

        if xspace.dimensions.nQ + nr > self.max_qsize_after_reset:
            limit = self.max_qsize_after_reset - nr if self.max_qsize_after_reset > nr else 0
            q_delete = limit_qspace_size(xspace.dimensions, limit, solutions, logger)
            for iq in sorted(q_delete, reverse=True):
                xspace.eraseq(iq)

        return list(range(nr)), parameters
