"""Packed-triangle symmetric action sharded over a mesh (port of
iterative_solver_tpu/parallel/sharded_symm.py).

The packed kernels (ops/kernels/symm.py, symm_int8.py) read only the lower
triangle and apply each tile to BOTH output block rows. Across ranks that
second contribution scatters: tile (i, j) writes block rows i and j, which
generally live on different ranks, so no rank owns an output row. The
layout is the JAX package's:

- tile PAIRS go round-robin over the ranks (rank r keeps pairs r, r + size,
  ...; each stored once, so the ranks together hold half a dense replica);
- each rank all-gathers the thin (m, N) x, contracts its own tiles into a
  partial (m, N) y, and
- a reduce-scatter over the vector axis returns each rank its slice of the
  sum, the packed analogue of gemm.h's MPI_Allreduce.

A rank keeps only its own pairs: the JAX package pads every device to the
same count with zero tiles aimed at block (0, 0) (static shard shapes);
torch needs none, so rank r's tiles, ``ii`` and ``jj`` are the JAX shard's
rows [r max_p, r max_p + k_r) and the kernels' walk lists are built from
the rank's own pairs.

The per-rank contraction is the kernel wrapper of the tier (the rank's
storage's ``kernel``) on the rank's pair list: K1 (``symm_matmat_kernel``,
f32 or bf16 tiles), K3 (``symm_matmat_split_kernel``), K4 / K5
(``symm_matmat_int8_kernel`` / ``_split_kernel``). On CUDA tensors they
launch the kernels; on CPU tensors they run their plain versions. Int8
tiers: x is quantized from the GATHERED x, so every rank has the same row
scales; ``gq`` is replicated; the exact diagonal is applied once, outside
the reduction, so each rank's kernel gets a zero diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.symm import (
    SymmetricBlocked,
    SymmetricBlockedSplit,
    square_sums,
    square_work,
)
from ..ops.kernels.symm_int8 import SymmetricBlockedInt8, SymmetricBlockedInt8Split
from . import collectives
from .mesh import Mesh

Tensor = torch.Tensor


def _host(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _rank_pairs(n_pairs: int, mesh: Mesh) -> Tuple[np.ndarray, int]:
    """This rank's pair indices (round robin) and the JAX package's padded
    count per device, max_p."""
    return np.arange(mesh.rank, n_pairs, mesh.size), -(-n_pairs // mesh.size)


def _check_divisible(n: int, mesh: Mesh, hint: str = "") -> None:
    if n % mesh.size != 0:
        raise ValueError(f"operator dimension {n} must divide over {mesh.size} devices{hint}")


def _rank_index(ij, idx: np.ndarray, dev) -> Tensor:
    """The rank's entries ``idx`` of a pair list (ii or jj), int32 on dev."""
    return torch.as_tensor(_host(ij)[idx], dtype=torch.int32, device=dev)


def _rank_diagonal(diag, n: int, mesh: Mesh, dtype) -> Tensor:
    full = np.zeros(n)
    if diag is not None:
        d = _host(diag).astype(np.float64)
        full[: d.shape[0]] = d
    c = n // mesh.size
    return torch.as_tensor(full[mesh.rank * c:(mesh.rank + 1) * c], dtype=dtype,
                           device=mesh.device)


def _with_walk(local):
    """``local`` with K1/K3's walk lists of the rank's own pairs built now:
    built on a matvec's first call instead, they would be rebuilt on every
    call, on the copy of the storage that takes the operand's tensors. A
    rank without pairs launches nothing."""
    if local.n_pairs:
        square_work(local)
        square_sums(local)
    return local


@dataclasses.dataclass
class ShardedSymmetric:
    """This rank's share of packed lower-triangle tiles interleaved over a
    1-D mesh."""

    # the rank's storage: its pairs' tiles (every plane), GLOBAL ii / jj
    # (jj <= ii), the replicated gq of the int8 tiers, and (int8) a zero
    # diagonal: the kernel adds no diagonal to a partial sum
    local: object
    mesh: Mesh
    axis: str
    pairs_per_dev: int  # the JAX package's padded count per device, max_p
    diagonal: Tensor    # (N / size,) the rank's slice of the diagonal; the
                        # int8 tiers apply it (EXACT) once, outside the reduction

    @property
    def shape(self) -> Tuple[int, int]:
        return self.local.shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def b(self) -> int:
        return self.local.b

    @property
    def n_local_pairs(self) -> int:
        return self.local.n_pairs

    @property
    def quantized(self) -> bool:
        """An int8 tier: x is quantized from the gathered x, the partial sum
        is float32 and the exact diagonal comes after the reduction."""
        return isinstance(self.local, (SymmetricBlockedInt8, SymmetricBlockedInt8Split))

    @classmethod
    def from_symmetric(cls, sym: SymmetricBlocked, mesh: Mesh,
                       axis: Optional[str] = None) -> "ShardedSymmetric":
        n = sym.shape[0]
        _check_divisible(n, mesh, "; pad the matrix (SymmetricBlocked.from_dense pads "
                         "to the block multiple — pick b so that n is also a mesh "
                         "multiple)")
        idx, max_p = _rank_pairs(sym.n_pairs, mesh)
        dev = mesh.device
        values = sym.values[torch.as_tensor(idx, device=sym.values.device)].to(dev)
        local = _with_walk(SymmetricBlocked(values=values, ii=_rank_index(sym.ii, idx, dev),
                                            jj=_rank_index(sym.jj, idx, dev),
                                            shape=sym.shape, b=sym.b))
        ddtype = torch.float32 if values.dtype == torch.bfloat16 else values.dtype
        return cls(local=local, mesh=mesh, axis=axis or mesh.axis, pairs_per_dev=max_p,
                   diagonal=_rank_diagonal(sym.diagonal, n, mesh, ddtype))

    @classmethod
    def from_split(cls, sym: SymmetricBlockedSplit, mesh: Mesh,
                   axis: Optional[str] = None) -> "ShardedSymmetric":
        """Shard the precise (split double-bf16) tier: hi and lo tiles carry
        the same pair layout."""
        n = sym.shape[0]
        _check_divisible(n, mesh)
        idx, max_p = _rank_pairs(sym.n_pairs, mesh)
        dev = mesh.device
        sel = torch.as_tensor(idx, device=sym.hi.device)
        local = _with_walk(SymmetricBlockedSplit(
            hi=sym.hi[sel].to(dev), lo=sym.lo[sel].to(dev), ii=_rank_index(sym.ii, idx, dev),
            jj=_rank_index(sym.jj, idx, dev), shape=sym.shape, b=sym.b))
        return cls(local=local, mesh=mesh, axis=axis or mesh.axis, pairs_per_dev=max_p,
                   diagonal=_rank_diagonal(sym.diagonal, n, mesh, torch.float32))

    @classmethod
    def from_int8(cls, sym, mesh: Mesh, axis: Optional[str] = None) -> "ShardedSymmetric":
        """Shard the quantized tiers: a SymmetricBlockedInt8 (one plane) or
        SymmetricBlockedInt8Split (two planes). The planes go round-robin
        like the float tiers; ``gq`` is replicated and the exact diagonal
        split over the vector axis."""
        n = sym.shape[0]
        _check_divisible(n, mesh)
        ii_all, jj_all = _host(sym.ii), _host(sym.jj)
        two_plane = isinstance(sym, SymmetricBlockedInt8Split)
        ndev = mesh.size
        # per-device exact-int32 headroom over the ACTUAL interleave: an
        # off-diagonal pair (i, j) adds one int8 dot (two for the split lo
        # plane) into accumulator rows i AND j, a diagonal tile only into
        # row i, each bounded by 127^2 b; counted over the real pairs
        counts = np.zeros((ndev, n // sym.b), dtype=np.int64)
        dev_of = (np.arange(ii_all.size) % ndev).astype(np.int64)
        np.add.at(counts, (dev_of, ii_all), 1)
        off = ii_all != jj_all
        np.add.at(counts, (dev_of[off], jj_all[off]), 1)
        dots = 2 if two_plane else 1
        if dots * int(counts.max()) * 127 * 127 * sym.b >= 2 ** 31:
            raise ValueError(
                f"ShardedSymmetric.from_int8: a device accumulator row "
                f"receives {int(counts.max())} int8 tile dots of b={sym.b} "
                "— exceeds exact-int32 headroom even sharded over "
                f"{ndev} devices; use more devices or a float tier")
        idx, max_p = _rank_pairs(ii_all.size, mesh)
        dev = mesh.device
        sel = torch.as_tensor(idx, device=sym.ii.device)
        planes = {f: getattr(sym, f)[sel].to(dev) for f in (("q1", "q2") if two_plane else ("q",))}
        local = type(sym)(**planes, gq=sym.gq.to(device=dev, dtype=torch.float32),
                          ii=_rank_index(ii_all, idx, dev), jj=_rank_index(jj_all, idx, dev),
                          shape=sym.shape, b=sym.b,
                          diagonal=torch.zeros(n, dtype=torch.float32, device=dev))
        return cls(local=local, mesh=mesh, axis=axis or mesh.axis, pairs_per_dev=max_p,
                   diagonal=_rank_diagonal(sym.diagonal, n, mesh, torch.float32))

    @classmethod
    def from_storage(cls, sym, mesh: Mesh, axis: Optional[str] = None) -> "ShardedSymmetric":
        """``from_symmetric``, ``from_split`` or ``from_int8``, by the
        storage class of ``sym``."""
        if isinstance(sym, (SymmetricBlockedInt8, SymmetricBlockedInt8Split)):
            return cls.from_int8(sym, mesh, axis)
        if isinstance(sym, SymmetricBlockedSplit):
            return cls.from_split(sym, mesh, axis)
        return cls.from_symmetric(sym, mesh, axis)

    def partial(self, x: Tensor, op) -> Tensor:
        """The rank's partial (m, N) action on the gathered x, before the
        reduction: the tier's kernel wrapper on the rank's pairs (one
        launch on CUDA tensors). ``op`` is the matvec's operand; an int8
        tier's diagonal (its last entry) is not applied here, and its
        partial is float32 whatever the dtype of x, as the JAX package's."""
        if self.quantized:
            x = x.to(torch.float32)
        if self.n_local_pairs == 0:
            return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        local = dataclasses.replace(self.local, **dict(zip(self.local.OPERAND, op)))
        return local.kernel(x).to(x.dtype)

    def matvec_fn(self):
        """``(matvec, operand)``: ``matvec(x, operand)`` maps this rank's
        (m, N / size) slice of x to its slice of y. The operand is the rank's
        storage's (its ``OPERAND`` tensors), then, for the int8 tiers, the
        rank's slice of the exact diagonal."""
        mesh = self.mesh

        def action(x_local: Tensor, op) -> Tensor:
            # halo: the packed layout needs every column block (a tile's i
            # or j can be anywhere), so gather the thin row block
            x = collectives.all_gather(x_local, mesh, dim=1)
            return collectives.reduce_scatter(self.partial(x, op), mesh, dim=1)

        operand = tuple(getattr(self.local, f) for f in self.local.OPERAND)
        if not self.quantized:
            return action, operand

        def matvec_int8(x_local: Tensor, operand) -> Tensor:
            # the exact diagonal applies once, on this rank's slice, outside
            # the partial-sum reduction
            y = action(x_local, operand)
            return (y + x_local.to(torch.float32) * operand[-1][None, :]).to(x_local.dtype)

        return matvec_int8, operand + (self.diagonal,)
