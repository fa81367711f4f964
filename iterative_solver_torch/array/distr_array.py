"""DistrArray — the reference's distributed-vector contract over PyTorch
(port of iterative_solver_tpu/array/distr_array.py; reference:
array/DistrArray.h:90-300).

A 1-D vector partitioned contiguously over the ranks of a mesh
(``parallel/mesh.py``), one process per rank. Rank r holds its
``spread_remainder`` range (the reference's DistrArrayDefaultRange, the C
bindings' ranges) at the head of a local tensor of ceil(dimension / size)
entries: the storage is padded to a multiple of the mesh size, as in the
JAX package (distr_array.py:52-55), and the padding is kept at zero (by
``fill``, ``recip`` and ``divide``), so it never enters a collective.

Every rank calls every method (SPMD). Local linear algebra touches only the
rank's own entries; one-sided reads (``at``, ``get``, ``gather``) and the
reductions are collectives every rank calls with the same arguments;
writes (``set``, ``put``, ``acc``, ``scatter``) take the same global
arguments on every rank and each rank applies the part it owns. ``dot`` and
``norm`` all-reduce; ``gather_all`` all-gathers; the selections run a local
top-n and merge the ranks' candidates. Without a mesh the array is one
rank's and nothing communicates.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as _config
from .distribution import Distribution, spread_remainder

Tensor = torch.Tensor


class DistrArray:
    def __init__(self, dimension: int, mesh=None, data=None, dtype=None, device=None):
        self.dimension = int(dimension)
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device
            n_ranks, self.rank = mesh.size, mesh.rank
        else:
            self.device = _config.resolve_device(device)
            n_ranks, self.rank = 1, 0
        self.dtype = dtype if dtype is not None else _config.default_dtype(self.device)
        self._distribution = spread_remainder(self.dimension, n_ranks)
        self._storage_n = ((self.dimension + n_ranks - 1) // n_ranks) * n_ranks
        self._local_n = self._storage_n // n_ranks
        self.lo, self.hi = self._distribution.range(self.rank)
        local = np.zeros(self._local_n)
        if data is not None:
            local[: self.hi - self.lo] = np.asarray(data, dtype=np.float64)[self.lo:self.hi]
        self.data = torch.as_tensor(local, dtype=self.dtype, device=self.device)

    # -- structure -------------------------------------------------------
    @property
    def size(self) -> int:
        return self.dimension

    @property
    def count(self) -> int:
        """Entries this rank owns."""
        return self.hi - self.lo

    def distribution(self) -> Distribution:
        return self._distribution

    def compatible(self, other: "DistrArray") -> bool:
        return self.dimension == other.dimension and self._distribution.compatible(
            other._distribution)

    def _sum(self, t: Tensor) -> Tensor:
        if self.mesh is None:
            return t
        from ..parallel.collectives import all_reduce

        return all_reduce(t, self.mesh)

    def local_buffer(self, rank: Optional[int] = None) -> np.ndarray:
        """Copy of the contiguous range owned by ``rank`` (DistrArray.h:117-143).

        ``rank=None`` is the caller's own range and communicates nothing.
        An explicit rank is a collective: every rank calls it with the same
        rank (the owner too) and gets that range."""
        if rank is None:
            return self.data[: self.count].cpu().numpy()
        lo, hi = self._distribution.range(rank)
        return self.get(lo, hi)

    def clone(self) -> "DistrArray":
        out = DistrArray.__new__(DistrArray)
        out.__dict__.update(self.__dict__)
        out.data = self.data.clone()
        return out

    # -- one-sided access (RMA equivalents, DistrArray.h:145-181) --------
    def _mine(self, lo: int, hi: int) -> Tuple[int, int]:
        """The overlap of [lo, hi) with this rank's range (may be empty)."""
        return max(lo, self.lo), min(hi, self.hi)

    def get(self, lo: int, hi: int) -> np.ndarray:
        out = torch.zeros(hi - lo, dtype=self.dtype, device=self.device)
        a, b = self._mine(lo, hi)
        if a < b:
            out[a - lo:b - lo] = self.data[a - self.lo:b - self.lo]
        return self._sum(out).cpu().numpy()

    def at(self, index: int) -> float:
        return float(self.get(index, index + 1)[0])

    def set(self, index: int, value: float) -> None:
        if self.lo <= index < self.hi:
            self.data[index - self.lo] = value

    def put(self, lo: int, values) -> None:
        values = np.asarray(values, dtype=np.float64)
        a, b = self._mine(lo, lo + values.shape[0])
        if a < b:
            self.data[a - self.lo:b - self.lo] = torch.as_tensor(
                values[a - lo:b - lo], dtype=self.dtype, device=self.device)

    def acc(self, lo: int, values) -> None:
        values = np.asarray(values, dtype=np.float64)
        a, b = self._mine(lo, lo + values.shape[0])
        if a < b:
            self.data[a - self.lo:b - self.lo] += torch.as_tensor(
                values[a - lo:b - lo], dtype=self.dtype, device=self.device)

    def _owned(self, indices: Sequence[int]):
        idx = np.asarray(list(indices), dtype=np.int64)
        own = (idx >= self.lo) & (idx < self.hi)
        return idx, own

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        idx, own = self._owned(indices)
        out = torch.zeros(idx.size, dtype=self.dtype, device=self.device)
        if own.any():
            local = torch.as_tensor(idx[own] - self.lo, device=self.device)
            out[torch.as_tensor(np.nonzero(own)[0], device=self.device)] = self.data[local]
        return self._sum(out).cpu().numpy()

    def _scatter(self, indices, values, accumulate: bool) -> None:
        idx, own = self._owned(indices)
        if not own.any():
            return
        vals = torch.as_tensor(np.asarray(values, dtype=np.float64)[own], dtype=self.dtype,
                               device=self.device)
        local = torch.as_tensor(idx[own] - self.lo, device=self.device)
        if accumulate:
            self.data.index_put_((local,), vals, accumulate=True)
        else:
            self.data[local] = vals

    def scatter(self, indices: Sequence[int], values) -> None:
        self._scatter(indices, values, False)

    def scatter_acc(self, indices: Sequence[int], values) -> None:
        self._scatter(indices, values, True)

    def gather_all(self) -> np.ndarray:
        """Full replicated copy (util/gather_all.h, MPI_Allgatherv): the
        ranks' local tensors gathered, each cut to its range."""
        if self.mesh is None:
            return self.data[: self.count].cpu().numpy()
        from ..parallel.collectives import all_gather

        parts = all_gather(self.data, self.mesh, dim=0).cpu().numpy()
        c = self._local_n
        return np.concatenate([
            parts[r * c: r * c + (hi - lo)]
            for r, (lo, hi) in enumerate(zip(self._distribution.chunk_borders[:-1],
                                              self._distribution.chunk_borders[1:]))])

    # -- local linear algebra (DistrArray.h:183-221) ---------------------
    def _live(self) -> Tensor:
        return torch.arange(self._local_n, device=self.device) < self.count

    def fill(self, value: float) -> None:
        self.data = torch.where(self._live(), torch.full_like(self.data, value),
                                torch.zeros_like(self.data))

    def copy_from(self, other: "DistrArray") -> None:
        self.data = other.data.clone()

    def axpy(self, alpha: float, x: "DistrArray") -> None:
        self.data = self.data + alpha * x.data

    def scal(self, alpha: float) -> None:
        self.data = self.data * alpha

    def add(self, other: "DistrArray") -> None:
        self.data = self.data + other.data

    def sub(self, other: "DistrArray") -> None:
        self.data = self.data - other.data

    def recip(self) -> None:
        live = self._live()
        self.data = torch.where(live, 1.0 / torch.where(live, self.data,
                                                        torch.ones_like(self.data)),
                                torch.zeros_like(self.data))

    def times(self, other: "DistrArray") -> None:
        self.data = self.data * other.data

    def divide(self, a: "DistrArray", b: "DistrArray", shift: float = 0.0,
               append: bool = False, negative: bool = False) -> None:
        """this = (+/-) a / (b + shift), optionally accumulated
        (DistrArray.h:231-243); the padding's denominator is 1, so it
        stays zero."""
        denom = torch.where(self._live(), b.data + shift, torch.ones_like(b.data))
        val = a.data / denom
        if negative:
            val = -val
        self.data = self.data + val if append else val

    # -- collectives -----------------------------------------------------
    def dot(self, other: "DistrArray") -> float:
        """Global dot: local partial, then an all-reduce
        (DistrArray.cpp:126-136's MPI_Allreduce)."""
        return float(self._sum(torch.dot(self.data, other.data)))

    def norm(self) -> float:
        return float(np.sqrt(abs(self.dot(self))))

    # -- reductions / selections (DistrArray.h:245-283) ------------------
    def _top_pairs(self, keys: Tensor, n: int, largest: bool,
                   values: Optional[Tensor] = None) -> List[Tuple[int, float]]:
        """The n entries with the largest (or smallest) ``keys``, ties to
        the lower index, as (global index, value) pairs; ``values``
        defaults to the data. Each rank takes its local top n, the ranks'
        candidates are gathered and merged."""
        n = min(n, self.dimension)
        values = self.data if values is None else values
        k = min(n, self.count)
        sign = 1.0 if largest else -1.0
        key = torch.full((n,), -float("inf"), dtype=torch.float64, device=self.device)
        idx = torch.full((n,), -1, dtype=torch.float64, device=self.device)
        val = torch.zeros(n, dtype=torch.float64, device=self.device)
        if k:
            own = sign * keys[: self.count].to(torch.float64)
            top, pos = torch.topk(own, k, sorted=True)
            key[:k], idx[:k] = top, (pos + self.lo).to(torch.float64)
            val[:k] = values[pos].to(torch.float64)
        cand = torch.stack([key, idx, val])
        if self.mesh is not None:
            from ..parallel.collectives import all_gather

            cand = all_gather(cand, self.mesh, dim=1)
        cand = cand.cpu().numpy()
        cand = cand[:, cand[1] >= 0]
        order = np.lexsort((cand[1], -cand[0]))[:n]
        return [(int(cand[1, j]), float(cand[2, j])) for j in order]

    def max_n(self, n: int) -> List[Tuple[int, float]]:
        return self._top_pairs(self.data, n, True)

    def min_n(self, n: int) -> List[Tuple[int, float]]:
        return self._top_pairs(self.data, n, False)

    def max_abs_n(self, n: int) -> List[Tuple[int, float]]:
        return self._top_pairs(torch.abs(self.data), n, True)

    def min_abs_n(self, n: int) -> List[Tuple[int, float]]:
        return self._top_pairs(torch.abs(self.data), n, False)

    def min_loc_n(self, n: int) -> List[int]:
        return [i for i, _ in self.min_n(n)]

    def select(self, n: int, max_select: bool = False, ignore_sign: bool = False):
        """Top-n elements as {index: value} (handler select semantics)."""
        keys = torch.abs(self.data) if ignore_sign else self.data
        return dict(self._top_pairs(keys, n, max_select))

    def select_max_dot(self, n: int, other: "DistrArray"):
        """n largest |this_i * other_i| contributions (util/select_max_dot.h)."""
        prod = self.data * other.data
        return dict(self._top_pairs(torch.abs(prod), n, True, values=prod))
