"""Fixed-capacity device basis stacks, the Q/D/P vector store (port of
iterative_solver_tpu/array/basis_store.py).

The reference keeps its Q-space history as individually allocated (often
disk-backed) vectors streamed through BufferManager pages
(array/DistrArrayFile.*, array/util/BufferManager.h:136-173). Here, as in
the JAX package, one preallocated ``(capacity, N)`` tensor per store holds
the rows, and the slots are managed on the host:

- appending a vector writes its row in place (no copy of the history; the
  JAX package donates the buffer for the same effect);
- every Gram block and reconstruction is one product against the whole
  stack, and the host indexes its small result by the logical slot lists;
- erasure frees a slot with no device traffic.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import config as _config
from . import vector_ops as vops

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6)"


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BasisStore:
    """Slot-managed ``(capacity, N)`` stack of basis vectors on ``device``
    (``None``: the CUDA device, raising without it)."""

    def __init__(self, capacity: int, n: int, dtype=torch.float64, sharding=None,
                 name: str = "basis", device=None):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        self.capacity = int(capacity)
        self.n = int(n)
        self.dtype = dtype
        self.device = _config.resolve_device(device)
        self.name = name
        self.data = torch.zeros((self.capacity, self.n), dtype=dtype, device=self.device)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))

    # -- slot management -------------------------------------------------
    @property
    def n_used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def _grow(self) -> None:
        new_capacity = max(2 * self.capacity, 4)
        pad = torch.zeros((new_capacity - self.capacity, self.n), dtype=self.dtype,
                          device=self.device)
        self.data = torch.cat([self.data, pad], dim=0)
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self.capacity = new_capacity

    # -- row access ------------------------------------------------------
    def _row(self, vec) -> Tensor:
        return vops.to_device(vec, self.dtype, self.device)

    def put(self, slot: int, vec) -> None:
        self.data[slot] = self._row(vec)

    def append(self, vec) -> int:
        slot = self.alloc()
        self.put(slot, vec)
        return slot

    def get(self, slot: int) -> Tensor:
        """A copy of one row (the stack is updated in place)."""
        return self.data[slot].clone()

    def fill(self, slot: int, value: float) -> None:
        self.data[slot] = value

    def axpy(self, slot: int, alpha: float, vec) -> None:
        self.data[slot] += alpha * self._row(vec)

    def scale(self, slot: int, alpha: float) -> None:
        self.data[slot] *= alpha

    def rows(self, slots: Sequence[int]) -> Tensor:
        """Gather logical rows as a dense (len(slots), N) block."""
        if len(slots) == 0:
            return torch.zeros((0, self.n), dtype=self.dtype, device=self.device)
        return self.data[torch.as_tensor(list(slots), dtype=torch.long, device=self.device)]

    # -- block numerics --------------------------------------------------
    def gram_block(self, x: Tensor) -> np.ndarray:
        """<x_i, basis_slot> for EVERY physical slot: (m, capacity) host array.
        One product; callers index the small result by their logical slot
        lists (unused slots give columns that are never read)."""
        return _host(torch.matmul(x, self.data.T))

    def mgs_sweep(self, r: Tensor, slots: Sequence[int], inv_norms) -> Tensor:
        """Sequential modified Gram-Schmidt of the rows of ``r`` against the
        logical rows ``slots`` in order, each projection scaled by
        ``inv_norms`` (1/<x,x>); padded to the capacity with zero scales, as
        the JAX package's fixed-shape loop is."""
        idx = np.zeros(self.capacity, dtype=np.int64)
        inv = np.zeros(self.capacity)
        for logical, slot in enumerate(slots):
            idx[logical] = slot
            inv[logical] = inv_norms[logical]
        xblock = self.data[torch.as_tensor(idx, device=self.device)]
        return vops.mgs_project(r, xblock, vops.to_device(inv, self.dtype, self.device))

    def gram(self, x: Tensor, slots: Sequence[int]) -> np.ndarray:
        """<x_i, basis_j> for the logical rows ``slots``: (m, k) host array."""
        if len(slots) == 0:
            return np.zeros((x.shape[0], 0))
        return self.gram_block(x)[:, list(slots)]

    def _coeff_full(self, coeff: np.ndarray, slots: Sequence[int]) -> Tensor:
        coeff = np.asarray(coeff, dtype=np.float64)
        full = np.zeros((coeff.shape[0], self.capacity))
        if len(slots):
            full[:, list(slots)] = coeff
        return vops.to_device(full, self.dtype, self.device)

    def combine(self, coeff: np.ndarray, slots: Sequence[int]) -> Tensor:
        """Rows of ``coeff @ basis[slots]`` as a device block (nsol, N)."""
        return torch.matmul(self._coeff_full(coeff, slots), self.data)

    def combine_add(self, out: Tensor, coeff: np.ndarray, slots: Sequence[int]) -> Tensor:
        if len(slots) == 0:
            return out
        return out + torch.matmul(self._coeff_full(coeff, slots), self.data)
