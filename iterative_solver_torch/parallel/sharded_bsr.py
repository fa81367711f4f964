"""Block-sparse action sharded over a mesh by block rows (port of
iterative_solver_tpu/parallel/sharded_bsr.py).

The reference's distributed SpMV keeps vector rows on their owning MPI
rank (SURVEY.md §2.5). The operator is partitioned by BLOCK ROWS: rank r
owns block rows [r rb, (r + 1) rb) of the operator padded to a multiple of
the mesh size, and with them its slice of x and y. Its blocks are split
into two groups:

- **local** blocks, whose column range lies in the rank's own slice of x:
  computed from ``x_local`` with no communication;
- **remote** (halo) blocks, which need other ranks' columns: computed from
  the all-gathered x.

Output rows are uniquely owned, so no reduction follows. Each rank's block
lists are padded to the largest rank's count with zero blocks aimed at
local row 0, as in the JAX package, so a rank's arrays are the JAX shard's
bytes. The per-rank body is a plain batched product plus ``index_add_``,
as JAX's is an ``einsum`` plus ``segment_sum``: there is no kernel here.

``ShardedBSRInt8`` is the quantized tier: the activation scale of a row is
the max over the WHOLE row, one ``all_reduce(max)`` of an (m,) vector, and
the halo exchange gathers the int8 activations (a quarter of the float
bytes); dequantization is linear in the exact int32 sums and the exact
diagonal applies once on the rank's own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.spmv import check_int8_accum_headroom
from . import collectives
from .mesh import Mesh

Tensor = torch.Tensor


def _host(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _rank_groups(row_idx, col_idx, ndev: int, rb_per_dev: int):
    """(local, remote) block indices of every rank: blocks of the rank's
    rows whose column block is (or is not) in the rank's range."""
    owners = row_idx // rb_per_dev
    col_owner = col_idx // rb_per_dev
    loc, rem = [], []
    for d in range(ndev):
        mine = owners == d
        loc.append(np.nonzero(mine & (col_owner == d))[0])
        rem.append(np.nonzero(mine & (col_owner != d))[0])
    return loc, rem


def _rank_arrays(groups, values, col_idx, row_idx, rank: int, rb_per_dev: int):
    """This rank's block list padded to the largest rank's count (at least
    one) with zero blocks scattered into local row 0: (values, col, row)."""
    max_b = max((len(g) for g in groups), default=1) or 1
    idx = groups[rank]
    k = len(idx)
    v = np.zeros((max_b,) + values.shape[1:], dtype=values.dtype)
    c = np.zeros(max_b, dtype=np.int32)
    r = np.zeros(max_b, dtype=np.int32)
    if k:
        v[:k] = values[idx]
        c[:k] = col_idx[idx]
        r[:k] = row_idx[idx] - rank * rb_per_dev
    return v, c, r


def _partition(bsr, mesh: Mesh, values: np.ndarray):
    bm, bn = bsr.bm, bsr.bn
    if bm != bn:
        raise ValueError("square blocks required for the row/column partition to align")
    ndev, rank = mesh.size, mesh.rank
    n_rb = bsr.shape[0] // bm
    n_rb_pad = ((n_rb + ndev - 1) // ndev) * ndev
    rb_per_dev = n_rb_pad // ndev
    row_idx, col_idx = _host(bsr.row_idx), _host(bsr.col_idx)
    loc, rem = _rank_groups(row_idx, col_idx, ndev, rb_per_dev)
    lv, lc, lr = _rank_arrays(loc, values, col_idx, row_idx, rank, rb_per_dev)
    # local group: column ids inside the rank's own slice
    lc = np.maximum(lc - rank * rb_per_dev, 0).astype(np.int32)
    rv, rc, rr = _rank_arrays(rem, values, col_idx, row_idx, rank, rb_per_dev)
    return (lv, lc, lr, rv, rc, rr), rb_per_dev, n_rb_pad * bm


def _rank_vector(vec, n_pad: int, rank: int, width: int, fill: float, dtype, device):
    full = np.full(n_pad, fill)
    if vec is not None:
        v = _host(vec).astype(np.float64)
        full[: v.shape[0]] = v
    return torch.as_tensor(full[rank * width:(rank + 1) * width], dtype=dtype, device=device)


def _contract(x_tiles: Tensor, values: Tensor, col: Tensor, row: Tensor,
              rb_per_dev: int, dtype) -> Tensor:
    """(rb_per_dev, m, bm): sum over the blocks of x_tiles[col] valuesᵀ
    into their local block rows."""
    contrib = torch.einsum("kmn,kin->kmi", x_tiles[col.long()].to(dtype), values.to(dtype))
    y = torch.zeros((rb_per_dev,) + tuple(contrib.shape[1:]), dtype=dtype,
                    device=contrib.device)
    return y.index_add_(0, row.long(), contrib)


def _tiles(x: Tensor, bn: int) -> Tensor:
    return x.reshape(x.shape[0], -1, bn).transpose(0, 1)


@dataclasses.dataclass
class ShardedBSR:
    """This rank's block rows of a BSR operator, split into comm-free
    (local-column) and halo (remote-column) groups."""

    loc_values: Tensor  # (max_loc, bm, bn)
    loc_col: Tensor     # (max_loc,) column block id LOCAL to the rank's slice
    loc_row: Tensor     # (max_loc,) row block id local to the rank
    rem_values: Tensor  # (max_rem, bm, bn)
    rem_col: Tensor     # (max_rem,) GLOBAL column block id
    rem_row: Tensor     # (max_rem,)
    mesh: Mesh
    axis: str
    shape: Tuple[int, int]   # padded to whole block rows per rank
    bm: int
    bn: int
    rb_per_dev: int
    diagonal: Tensor    # (rb_per_dev * bm,) the rank's slice

    @property
    def n(self) -> int:
        return self.shape[0]

    @classmethod
    def from_bsr(cls, bsr, mesh: Mesh, axis: Optional[str] = None) -> "ShardedBSR":
        values = _host(bsr.values.to(torch.float64))
        (lv, lc, lr, rv, rc, rr), rb_per_dev, n_pad = _partition(bsr, mesh, values)
        dev, dtype = mesh.device, bsr.values.dtype

        def put(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=dev)

        return cls(loc_values=put(lv, dtype), loc_col=put(lc), loc_row=put(lr),
                   rem_values=put(rv, dtype), rem_col=put(rc), rem_row=put(rr),
                   mesh=mesh, axis=axis or mesh.axis, shape=(n_pad, n_pad), bm=bsr.bm,
                   bn=bsr.bn, rb_per_dev=rb_per_dev,
                   diagonal=_rank_vector(bsr.diagonal, n_pad, mesh.rank,
                                         rb_per_dev * bsr.bm, 0.0, dtype, dev))

    def matvec_fn(self):
        """``(matvec, operand)``: ``matvec(x, operand)`` maps this rank's
        (m, rb_per_dev bm) slice of x to its slice of y."""
        mesh, bn, bm, rb = self.mesh, self.bn, self.bm, self.rb_per_dev

        def matvec(x_local: Tensor, operand) -> Tensor:
            lv, lc, lr, rv, rc, rr = operand
            m = x_local.shape[0]
            dtype = torch.promote_types(x_local.dtype, lv.dtype)
            # the comm-free contribution from the rank's own slice of x,
            y = _contract(_tiles(x_local, bn), lv, lc, lr, rb, dtype)
            # then the halo blocks from the gathered x
            x = collectives.all_gather(x_local, mesh, dim=1)
            y = y + _contract(_tiles(x, bn), rv, rc, rr, rb, dtype)
            return y.transpose(0, 1).reshape(m, rb * bm)

        return matvec, (self.loc_values, self.loc_col, self.loc_row,
                        self.rem_values, self.rem_col, self.rem_row)


@dataclasses.dataclass
class ShardedBSRInt8:
    """The quantized tier of ShardedBSR: int8 blocks, the rank's slices of
    the row and column scales and of the exact diagonal."""

    loc_q: Tensor       # (max_loc, bm, bn) int8
    loc_col: Tensor
    loc_row: Tensor
    rem_q: Tensor       # (max_rem, bm, bn) int8
    rem_col: Tensor
    rem_row: Tensor
    rq: Tensor          # (rb_per_dev * bm,) f32 row dequant scales (rank's slice)
    cq: Tensor          # (rb_per_dev * bm,) f32 column scales (rank's slice)
    diagonal: Tensor    # (rb_per_dev * bm,) f32 EXACT diagonal (rank's slice)
    mesh: Mesh
    axis: str
    shape: Tuple[int, int]
    bm: int
    bn: int
    rb_per_dev: int

    @property
    def n(self) -> int:
        return self.shape[0]

    @classmethod
    def from_int8(cls, bsr_q, mesh: Mesh, axis: Optional[str] = None) -> "ShardedBSRInt8":
        """Shard a BSRMatrixInt8 (tensors on any device)."""
        # each rank accumulates a block row as the single-device path does:
        # the guard holds here too
        check_int8_accum_headroom(bsr_q.row_idx, bsr_q.bn, context="ShardedBSRInt8")
        q = _host(bsr_q.q)
        (lv, lc, lr, rv, rc, rr), rb_per_dev, n_pad = _partition(bsr_q, mesh, q)
        dev, width = mesh.device, rb_per_dev * bsr_q.bm

        def put(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=dev)

        def vec(v, fill):
            return _rank_vector(v, n_pad, mesh.rank, width, fill, torch.float32, dev)

        return cls(loc_q=put(lv, torch.int8), loc_col=put(lc), loc_row=put(lr),
                   rem_q=put(rv, torch.int8), rem_col=put(rc), rem_row=put(rr),
                   rq=vec(bsr_q.rq, 1.0), cq=vec(bsr_q.cq, 1.0),
                   diagonal=vec(bsr_q.diagonal, 0.0), mesh=mesh, axis=axis or mesh.axis,
                   shape=(n_pad, n_pad), bm=bsr_q.bm, bn=bsr_q.bn, rb_per_dev=rb_per_dev)

    def accumulate(self, x_local: Tensor, operand) -> Tuple[Tensor, Tensor]:
        """The rank's exact int32 accumulator (m, rb_per_dev bm) and the
        global row scales sx (m, 1) of the quantized action."""
        lq, lc, lr, rq_, rc, rr, _, cqv, _ = operand
        mesh, bn, bm, rb = self.mesh, self.bn, self.bm, self.rb_per_dev
        m = x_local.shape[0]
        xs = x_local.to(torch.float32) * cqv[None, :]
        # the row's scale is its max over the whole row: an (m,) max
        amax = collectives.all_reduce(torch.amax(torch.abs(xs), dim=1), mesh, "max")
        sx = (torch.where(amax > 0.0, amax, torch.ones_like(amax)) / 127.0)[:, None]
        qx_local = torch.clamp(torch.round(xs / sx), -127, 127).to(torch.int8)
        # int32 sums as exact float64 integers (no int32 batched product on
        # CUDA): the local blocks, then the int8 halo
        acc = _contract(_tiles(qx_local, bn), lq, lc, lr, rb, torch.float64)
        qx = collectives.all_gather(qx_local, mesh, dim=1)
        acc = acc + _contract(_tiles(qx, bn), rq_, rc, rr, rb, torch.float64)
        return acc.transpose(0, 1).reshape(m, rb * bm).to(torch.int32), sx

    def matvec_fn(self):
        def matvec(x_local: Tensor, operand) -> Tensor:
            acc, sx = self.accumulate(x_local, operand)
            rqv, dg = operand[6], operand[8]
            # dequantisation is linear in the exact sums; the exact diagonal
            # applies once, on the rank's own rows
            y = acc.to(torch.float32) * sx * rqv[None, :] + x_local.to(torch.float32) * dg[None, :]
            return y.to(x_local.dtype)

        return matvec, (self.loc_q, self.loc_col, self.loc_row,
                        self.rem_q, self.rem_col, self.rem_row,
                        self.rq, self.cq, self.diagonal)
