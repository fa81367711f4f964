"""The X = [P, Q, D] subspace container (port of
iterative_solver_tpu/subspace/xspace.py; reference: subspace/XSpace.h,
QSpace.h, DSpace.h, PSpace.h).

Design split, as in the JAX package:

- The O(N) basis vectors live in two device ``BasisStore`` stacks — one for
  parameters (also holding dense P vectors and RHS vectors) and one for
  actions.  Every overlap/H block needed by ``update_qspace`` comes from at
  most four static-shape matmuls of the new row-block against those stacks
  (one fused device pass per stack instead of the reference's per-block
  gemm_inner calls, XSpace.h:31-83).
- The subspace equation data H, S, rhs, value are tiny host numpy matrices;
  insertions/erasures are exact row/col surgery like the reference's
  Matrix shuffles (QSpace.h:76-116) but cost nothing compared to device work.

Q-space ordering is newest-first (QSpace.h:80-85); new vectors are inserted
at offset oQ. Hermitian mode fills symmetric H blocks by transposition
(XSpace.h:51-64); ``action_dot_action`` mode (DIIS) builds H from residual
overlaps (XSpace.h:46-50).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as _config
from ..array import vector_ops as vops
from ..array.basis_store import BasisStore, _host
from ..utils import Logger, Statistics
from .dimensions import Dimensions

Tensor = torch.Tensor


def _insert_block(mat: np.ndarray, at: int, m: int) -> np.ndarray:
    """Insert m zero rows and columns at index ``at`` of square matrix."""
    n = mat.shape[0]
    out = np.zeros((n + m, n + m))
    out[:at, :at] = mat[:at, :at]
    out[:at, at + m:] = mat[:at, at:]
    out[at + m:, :at] = mat[at:, :at]
    out[at + m:, at + m:] = mat[at:, at:]
    return out


class XSpace:
    def __init__(
        self,
        n: int,
        dtype=torch.float64,
        sharding=None,
        capacity: int = 16,
        logger: Optional[Logger] = None,
        stats: Optional[Statistics] = None,
        store_factory=None,
        device=None,
    ):
        self.n = int(n)
        self.dtype = dtype
        self.device = _config.resolve_device(device)
        self.logger = logger or Logger()
        self.stats = stats or Statistics()
        # store_factory swaps the basis backend: the device BasisStore by
        # default, an offload store (array/offload_store.py) for the
        # host/disk spill tier; it is called as BasisStore is
        factory = store_factory or BasisStore
        self.store_v = factory(capacity, n, dtype, sharding, name="params",
                               device=self.device)
        self.store_a = factory(capacity, n, dtype, sharding, name="actions",
                               device=self.device)
        # logical index lists; q newest-first
        self.p_slots: List[int] = []
        self.p_sparse: List[Dict[int, float]] = []
        self.q_slots: List[Tuple[int, int, int]] = []  # (vslot, aslot, unique_id)
        self.d_slots: List[Tuple[int, int]] = []
        self.rhs_slots: List[int] = []
        self.rhs_norm: List[float] = []
        self._unique_id = itertools.count()
        # equation data (host)
        self.s = np.zeros((0, 0))
        self.h = np.zeros((0, 0))
        self.rhs = np.zeros((0, 0))
        self.value = np.zeros((0, 1))
        self.hermitian = False
        self.action_dot_action = False

    # ------------------------------------------------------------------
    @property
    def dimensions(self) -> Dimensions:
        return Dimensions(len(self.p_slots), len(self.q_slots), len(self.d_slots), len(self.rhs_slots))

    @property
    def size(self) -> int:
        return self.dimensions.nX

    # -- vector accessors (device blocks in logical order) -------------
    def params_p(self) -> Tensor:
        return self.store_v.rows(self.p_slots)

    def params_q(self) -> Tensor:
        return self.store_v.rows([s[0] for s in self.q_slots])

    def actions_q(self) -> Tensor:
        return self.store_a.rows([s[1] for s in self.q_slots])

    def params_d(self) -> Tensor:
        return self.store_v.rows([s[0] for s in self.d_slots])

    def actions_d(self) -> Tensor:
        return self.store_a.rows([s[1] for s in self.d_slots])

    def rhs_vectors(self) -> Tensor:
        return self.store_v.rows(self.rhs_slots)

    # ------------------------------------------------------------------
    def update_qspace(self, params: Tensor, actions: Tensor) -> None:
        """Prepend new parameter/action pairs to the Q space and extend H/S/rhs.

        Semantics of XSpace.h:164-172 + QSpace.h:76-116 with the device work
        fused into four stack matmuls.
        """
        m = params.shape[0]
        if m == 0:
            return
        dims = self.dimensions
        nX = dims.nX

        # Device passes: overlaps of new params/actions with both stacks.
        gv_p = self.store_v.gram_block(params)  # params . all stored vectors
        ga_p = self.store_a.gram_block(params)  # params . all stored actions
        gv_a = self.store_v.gram_block(actions)  # actions . all stored vectors
        ga_a = self.store_a.gram_block(actions) if self.action_dot_action else None
        rr_s = _host(vops.gram_sym(params))
        if self.action_dot_action:
            rr_h = _host(vops.gram_sym(actions))
        else:
            rr_h = _host(vops.gram(params, actions))
        self.stats.gemm_inner_ops += 4

        pv = self.p_slots
        qv = [s[0] for s in self.q_slots]
        qa = [s[1] for s in self.q_slots]
        dv = [s[0] for s in self.d_slots]
        da = [s[1] for s in self.d_slots]

        # S blocks: new-vs-X
        s_new_x = np.zeros((m, nX))
        s_new_x[:, dims.oP : dims.oP + dims.nP] = gv_p[:, pv]
        s_new_x[:, dims.oQ : dims.oQ + dims.nQ] = gv_p[:, qv]
        s_new_x[:, dims.oD : dims.oD + dims.nD] = gv_p[:, dv]

        # H blocks
        h_new_x = np.zeros((m, nX))  # rows: new, cols: existing X
        h_x_new = np.zeros((nX, m))  # rows: existing X, cols: new
        left = ga_a if self.action_dot_action else ga_p
        h_new_x[:, dims.oQ : dims.oQ + dims.nQ] = left[:, qa]
        h_new_x[:, dims.oD : dims.oD + dims.nD] = left[:, da]
        if self.hermitian:
            h_x_new[dims.oP : dims.oP + dims.nP, :] = gv_a[:, pv].T  # <p, action_new>
            h_x_new[dims.oQ : dims.oQ + dims.nQ, :] = h_new_x[:, dims.oQ : dims.oQ + dims.nQ].T
            h_x_new[dims.oD : dims.oD + dims.nD, :] = h_new_x[:, dims.oD : dims.oD + dims.nD].T
            h_new_x[:, dims.oP : dims.oP + dims.nP] = gv_a[:, pv]
        else:
            h_x_new[dims.oQ : dims.oQ + dims.nQ, :] = gv_a[:, qv].T  # <q_param, action_new>
            h_x_new[dims.oD : dims.oD + dims.nD, :] = gv_a[:, dv].T

        rhs_new = gv_p[:, self.rhs_slots] if self.rhs_slots else np.zeros((m, 0))

        # Store the new vectors (device append; Q copy boundary of QSpace.h:80-85).
        new_entries = []
        for i in range(m):
            vslot = self.store_v.append(params[i])
            aslot = self.store_a.append(actions[i])
            new_entries.append((vslot, aslot, next(self._unique_id)))
        self.q_slots = new_entries + self.q_slots
        self.stats.q_creations += 2 * m

        # Host matrix surgery: insert m rows/cols at oQ.
        at = dims.oQ
        for name, new_x, x_new, qq in (
            ("s", s_new_x, s_new_x.T, rr_s),
            ("h", h_new_x, h_x_new, rr_h),
        ):
            mat = _insert_block(getattr(self, name), at, m)
            mat[at : at + m, :at] = new_x[:, :at]
            mat[at : at + m, at + m :] = new_x[:, at:]
            mat[at : at + m, at : at + m] = qq
            mat[:at, at : at + m] = x_new[:at, :]
            mat[at + m :, at : at + m] = x_new[at:, :]
            setattr(self, name, mat)
        if self.rhs.shape[1] or self.rhs_slots:
            nrhs = len(self.rhs_slots)
            rhs_mat = np.zeros((nX + m, nrhs))
            rhs_mat[:at, :] = self.rhs[:at, :] if self.rhs.size else 0.0
            rhs_mat[at : at + m, :] = rhs_new
            if self.rhs.size:
                rhs_mat[at + m :, :] = self.rhs[at:, :]
            self.rhs = rhs_mat
        if self.logger.data_dump:
            # subspace-matrix dump parity (XSpace.h:72-81)
            self.logger.msg(f"S = {np.array2string(self.s, precision=6)}", 4)
            self.logger.msg(f"H = {np.array2string(self.h, precision=6)}", 4)
        # NOTE: the value matrix is managed by the nonlinear solvers themselves
        # (OptimizeBFGS.h:59-64 resizes/shifts it before calling add_vector);
        # update_qspace leaves it alone, matching QSpace::update.

    # ------------------------------------------------------------------
    def update_dspace(self, dparams: Tensor, dactions: Tensor) -> None:
        """Replace the D space wholesale and rebuild its data blocks (XSpace.h:174-187)."""
        for vslot, aslot in self.d_slots:
            self.store_v.release(vslot)
            self.store_a.release(aslot)
        old_nd = len(self.d_slots)
        self.d_slots = []
        dims_no_d = self.dimensions  # after clearing
        # shrink matrices: remove old D rows/cols
        keep = list(range(dims_no_d.nX))  # P+Q indices (old D was at the end)
        self.s = self.s[np.ix_(keep, keep)]
        self.h = self.h[np.ix_(keep, keep)]
        if self.rhs.size:
            self.rhs = self.rhs[keep, :]

        nd = int(dparams.shape[0]) if dparams is not None else 0
        if nd == 0:
            return
        for i in range(nd):
            vslot = self.store_v.append(dparams[i])
            aslot = self.store_a.append(dactions[i])
            self.d_slots.append((vslot, aslot))
        self.stats.d_creations += nd

        dims = self.dimensions
        pv = self.p_slots
        qv = [s[0] for s in self.q_slots]
        qa = [s[1] for s in self.q_slots]

        gv_dp = self.store_v.gram_block(dparams)
        ga_dp = self.store_a.gram_block(dparams)
        gv_da = self.store_v.gram_block(dactions)
        s_dd = _host(vops.gram_sym(dparams))
        h_dd = _host(vops.gram(dparams, dactions))
        self.stats.gemm_inner_ops += 4

        nX = dims.nX
        s = np.zeros((nX, nX))
        h = np.zeros((nX, nX))
        old = dims.oD  # = nP + nQ
        s[:old, :old] = self.s
        h[:old, :old] = self.h
        oD = dims.oD
        # S blocks
        s[oD:, oD:] = s_dd
        s[oD:, : dims.nP] = gv_dp[:, pv]
        s[oD:, dims.oQ : dims.oQ + dims.nQ] = gv_dp[:, qv]
        s[: dims.nP, oD:] = gv_dp[:, pv].T
        s[dims.oQ : dims.oQ + dims.nQ, oD:] = gv_dp[:, qv].T
        # H blocks (update_dspace_action_data: Hdd = <dparam, daction>,
        # Hxd = <x_param, daction>, Hdx = <dparam, x_action>, HPd = Hdp^T)
        h[oD:, oD:] = h_dd
        h[dims.oQ : dims.oQ + dims.nQ, oD:] = gv_da[:, qv].T
        h[oD:, dims.oQ : dims.oQ + dims.nQ] = ga_dp[:, qa]
        if dims.nP:
            h[: dims.nP, oD:] = gv_da[:, pv].T
            h[oD:, : dims.nP] = gv_da[:, pv]  # transpose of Hxd P block
        self.s = s
        self.h = h
        if self.rhs_slots:
            rhs_mat = np.zeros((nX, len(self.rhs_slots)))
            rhs_mat[:old, :] = self.rhs
            rhs_mat[oD:, :] = gv_dp[:, self.rhs_slots]
            self.rhs = rhs_mat

    # ------------------------------------------------------------------
    def update_pspace(self, pvectors: Sequence[Dict[int, float]], pp_action_matrix: np.ndarray) -> None:
        """Install the P space (requires empty subspace + hermitian; XSpace.h:191-205)."""
        assert self.size == 0, "P space can only be set on an empty subspace"
        if not self.hermitian:
            raise RuntimeError("P space can only be used with hermitian kernels")
        nP = len(pvectors)
        if nP == 0:
            return
        dense = np.zeros((nP, self.n))
        for i, pvec in enumerate(pvectors):
            for idx, val in pvec.items():
                dense[i, int(idx)] = val
        block = vops.to_device(dense, self.dtype, self.device)
        for i in range(nP):
            self.p_slots.append(self.store_v.append(block[i]))
        self.p_sparse = [dict(p) for p in pvectors]
        s_pp = _host(vops.gram_sym(block))
        self.stats.gemm_inner_ops += 1
        self.s = s_pp
        self.h = np.asarray(pp_action_matrix, dtype=np.float64).reshape(nP, nP).copy()
        if self.rhs_slots:
            rhs_block = self.rhs_vectors()
            self.rhs = _host(vops.gram(block, rhs_block))
        else:
            self.rhs = np.zeros((nP, 0))

    # ------------------------------------------------------------------
    def add_rhs_equations(self, rhs_block: Tensor) -> None:
        """Store RHS vectors b for A x = b (XSpace.h:208-220)."""
        norms = _host(vops.norms_rows(rhs_block))
        for i in range(rhs_block.shape[0]):
            if norms[i] == 0:
                raise RuntimeError("RHS vector cannot be zero")
            self.rhs_slots.append(self.store_v.append(rhs_block[i]))
            self.rhs_norm.append(float(norms[i]))
        # project onto existing subspace rows
        dims = self.dimensions
        if dims.nX:
            x_block = torch.cat([self.params_p(), self.params_q(), self.params_d()], dim=0)
            self.rhs = _host(vops.gram(x_block, self.rhs_vectors()))
            self.stats.gemm_inner_ops += 1
        else:
            self.rhs = np.zeros((0, len(self.rhs_slots)))

    # ------------------------------------------------------------------
    def eraseq(self, i: int) -> None:
        dims = self.dimensions
        vslot, aslot, _ = self.q_slots.pop(i)
        self.store_v.release(vslot)
        self.store_a.release(aslot)
        self._remove_data(dims.oQ + i)
        self.stats.q_deletions += 1

    def erased(self, i: int) -> None:
        dims = self.dimensions
        vslot, aslot = self.d_slots.pop(i)
        self.store_v.release(vslot)
        self.store_a.release(aslot)
        self._remove_data(dims.oD + i)

    def erasep(self, i: int) -> None:
        dims = self.dimensions
        slot = self.p_slots.pop(i)
        self.p_sparse.pop(i)
        self.store_v.release(slot)
        self._remove_data(dims.oP + i)

    def _remove_data(self, i: int) -> None:
        keep = [j for j in range(self.s.shape[0]) if j != i]
        self.s = self.s[np.ix_(keep, keep)]
        self.h = self.h[np.ix_(keep, keep)]
        if self.rhs.size:
            self.rhs = self.rhs[keep, :]
        if self.value.size:
            self.value = self.value[keep, :]
