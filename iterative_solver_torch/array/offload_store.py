"""Host/disk-offloaded basis stores, the spill tier for basis histories (port
of iterative_solver_tpu/array/offload_store.py).

Drop-in replacements for the device ``BasisStore``, backed by the native
file store (``native/vecstore.cpp`` through the port's ``native/vecstore.py``):
the basis rows live outside device memory, in float64 in a file, as the
reference's DistrArrayFile-as-Qvector configuration keeps them
(IterativeSolverCMPI.cpp:48).

- ``OffloadBasisStore``: the block numerics (inner products, combinations,
  the MGS sweep) run on the host in float64 against the native streamed
  pipeline; tensors cross to the device only at put/get/combine edges.
- ``StreamedOffloadStore``: every block numeric is a run of
  ``(rows, B) x (B, N)`` products on the device over blocks of
  ``block_rows`` rows streamed THROUGH it, so at most two blocks of
  history occupy device memory at once, however long the history is.

``sharding=`` raises ``NotImplementedError``: the sharded store waits
for ROADMAP.md Queue 1, item 6c.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Sequence

import numpy as np
import torch

from .. import config as _config
from ..native import VecStore

Tensor = torch.Tensor

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6c)"


def _host64(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a float64 host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


class OffloadBasisStore:
    """The host-f64 tier: rows in the native file store, block numerics on
    the host in float64, results as tensors on ``device`` in ``dtype``
    (``None``: the CUDA device, raising without it; float32 there, float64
    on the CPU)."""

    def __init__(self, capacity: int, n: int, dtype=None, sharding=None,
                 name: str = "offload", device=None):
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        self.capacity = int(capacity)
        self.n = int(n)
        self.device = _config.resolve_device(device)
        self.dtype = dtype if dtype is not None else _config.default_dtype(self.device)
        self.sharding = None
        self.name = name
        self._store = VecStore(self.capacity, self.n)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        # host-side validity mask: released slots are left out of
        # whole-capacity grams instead of paying an O(N) zero-write per erase
        self._valid: set = set()

    # -- slot management -------------------------------------------------
    @property
    def n_used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def release(self, slot: int) -> None:
        # no data movement: the slot leaves the validity mask, so
        # whole-capacity grams see a zero column without an O(N) write
        self._valid.discard(slot)
        self._free.append(slot)

    def _grow(self) -> None:
        new_capacity = max(2 * self.capacity, 4)
        new_store = VecStore(new_capacity, self.n)
        for slot in sorted(self._valid):  # only live rows move
            new_store.put(slot, self._store.get(slot))
        self._store.close()
        self._store = new_store
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self.capacity = new_capacity

    # -- row access ------------------------------------------------------
    def put(self, slot: int, vec) -> None:
        self._store.put(slot, _host64(vec))
        self._valid.add(slot)

    def append(self, vec) -> int:
        slot = self.alloc()
        self.put(slot, vec)
        return slot

    def get(self, slot: int) -> Tensor:
        return self._to_device(self._store.get(slot))

    def fill(self, slot: int, value: float) -> None:
        self._store.put(slot, np.full(self.n, float(value)))
        self._valid.add(slot)

    def axpy(self, slot: int, alpha: float, vec) -> None:
        self._store.axpy(slot, float(alpha), _host64(vec))

    def scale(self, slot: int, alpha: float) -> None:
        self._store.scale(slot, float(alpha))

    def rows(self, slots: Sequence[int]) -> Tensor:
        if len(slots) == 0:
            return torch.zeros((0, self.n), dtype=self.dtype, device=self.device)
        return self._to_device(np.stack([self._store.get(s) for s in slots]))

    # -- block numerics (streamed on the host) ---------------------------
    def gram_block(self, x) -> np.ndarray:
        """<x_i, row_slot> for every physical slot: (m, capacity) host array,
        zero in the columns of released and never-written slots."""
        xh = _host64(x)
        live = sorted(self._valid)
        out = np.zeros((xh.shape[0], self.capacity))
        if live:
            out[:, live] = self._store.gram(xh, live)
        return out

    def gram(self, x, slots: Sequence[int]) -> np.ndarray:
        if len(slots) == 0:
            return np.zeros((x.shape[0], 0))
        return self._store.gram(_host64(x), list(slots))

    def combine(self, coeff: np.ndarray, slots: Sequence[int]) -> Tensor:
        coeff = np.atleast_2d(np.asarray(coeff, dtype=np.float64))
        return self._to_device(self._store.combine(coeff, list(slots)))

    def combine_add(self, out: Tensor, coeff: np.ndarray, slots: Sequence[int]) -> Tensor:
        return out + self.combine(coeff, slots)

    def mgs_sweep(self, r, slots: Sequence[int], inv_norms) -> Tensor:
        """Sequential MGS of the rows of ``r`` against the stored rows
        ``slots`` in order, on the host in float64 (the reference's
        BufferManager-paged Gram-Schmidt)."""
        rh = np.array(_host64(r))  # writable copy
        for logical, slot in enumerate(slots):
            xrow = self._store.get(slot)
            dots = rh @ xrow
            rh -= np.outer(dots * inv_norms[logical], xrow)
        return self._to_device(rh)

    # ------------------------------------------------------------------
    def _to_device(self, arr) -> Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    def close(self) -> None:
        self._store.close()


class StreamedOffloadStore(OffloadBasisStore):
    """The BufferManager analogue (array/util/BufferManager.h:136-173,
    consumed in gemm.h:100-152): the history streamed through the device
    instead of computed on the host. Three stages overlap on CUDA:

        disk read of block k+1 into a pinned staging buffer (reader thread)
          || H2D copy of block k (copy stream, from the other pinned buffer)
             || product on block k-1 (compute stream)

    - The reader thread ``pread``s rows straight into one of two pinned
      host buffers (``VecStore.get_into``; ctypes releases the GIL). It
      refills a buffer only after the event recorded behind that buffer's
      last H2D copy has completed: otherwise rows would change under an
      in-flight copy.
    - The copy stream copies the buffer to a fresh device block
      (``non_blocking``; pinned memory makes it a true asynchronous DMA)
      and records the buffer's event; the compute stream waits on that
      event, and ``record_stream`` keeps the block alive until its product
      has run.
    - The store holds float64 on disk. The staging buffers and the copy
      are float64, as read; the cast to ``dtype`` runs on the device. (A
      host cast to float32 halves the PCIe bytes but lands on the reader's
      thread, the bound stage, and measured slower: PERF.md.)

    ``mgs_sweep`` is block-classical Gram-Schmidt (one gram and one combine
    per block, in order across blocks): equal to row-sequential MGS
    whenever the stored history is orthonormal, which the solvers keep.
    Only ``gram`` and ``gram_block`` return host arrays; ``combine`` and
    ``mgs_sweep`` return tensors on the device, with no host read.

    Computation is in ``dtype``: float32 on CUDA, float64 on the CPU. On
    the CPU the same pipeline runs with host buffers and no streams (there
    is nothing to pin or to copy to), the plain version of the CUDA path.
    ``prefetch=False`` serialises the three stages (each block read,
    copied and multiplied before the next read starts): the same products
    in the same order, so the same bits, used to measure the overlap.
    """

    def __init__(self, capacity: int, n: int, dtype=None, sharding=None,
                 name: str = "offload", block_rows: int = 64, device=None):
        super().__init__(capacity, n, dtype=dtype, sharding=sharding, name=name,
                         device=device)
        self.block_rows = int(block_rows)
        self._staging = None  # (buffers, their numpy views, events, copy stream)

    def _stage(self):
        """Two host staging buffers of ``block_rows`` rows (pinned on CUDA),
        made at first use; on CUDA also their copy-done events and the copy
        stream."""
        if self._staging is None:
            cuda = self.device.type == "cuda"
            bufs = [torch.empty((self.block_rows, self.n), dtype=torch.float64,
                                pin_memory=cuda) for _ in range(2)]
            events = [torch.cuda.Event() for _ in range(2)] if cuda else None
            copy = torch.cuda.Stream(self.device) if cuda else None
            self._staging = (bufs, [b.numpy() for b in bufs], events, copy)
        return self._staging

    def _stream(self, slots: Sequence[int], prefetch: bool = True):
        """Yield ``(block_index, column_slice, device_block)`` over the rows
        ``slots`` in blocks of ``block_rows``, through the staging pipeline
        (the class note)."""
        slots = list(slots)
        br = self.block_rows
        nblk = -(-len(slots) // br)
        if nblk == 0:
            return
        bufs, views, events, copy = self._stage()
        compute = torch.cuda.current_stream(self.device) if copy is not None else None

        def read(k: int) -> int:
            b = k % 2
            if events is not None:
                events[b].synchronize()  # this buffer's last H2D copy is done
            chunk = slots[k * br:(k + 1) * br]
            for i, slot in enumerate(chunk):
                self._store.get_into(slot, views[b][i])
            return len(chunk)

        def upload(k: int, rows: int) -> Tensor:
            host = bufs[k % 2][:rows]
            if copy is None:
                return host.to(self.dtype, copy=True)
            with torch.cuda.stream(copy):
                dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
                events[k % 2].record(copy)
            compute.wait_event(events[k % 2])
            dev.record_stream(compute)
            return dev.to(self.dtype)

        def cols(k: int, rows: int) -> slice:
            return slice(k * br, k * br + rows)

        if not prefetch:
            for k in range(nblk):
                if compute is not None:
                    compute.synchronize()  # the previous block's product has run
                rows = read(k)
                dev = upload(k, rows)
                if events is not None:
                    events[k % 2].synchronize()
                yield k, cols(k, rows), dev
            return

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(read, 0)
            for k in range(nblk):
                rows = fut.result()
                dev = upload(k, rows)
                if k + 1 < nblk:
                    fut = ex.submit(read, k + 1)  # overlaps this copy and the products
                yield k, cols(k, rows), dev

    # -- streamed block numerics ----------------------------------------
    def gram(self, x, slots: Sequence[int], prefetch: bool = True) -> np.ndarray:
        if len(slots) == 0:
            return np.zeros((x.shape[0], 0))
        xd = self._to_device(x)
        parts = [torch.matmul(xd, blk.T) for _, _, blk in self._stream(slots, prefetch)]
        return _host64(torch.cat(parts, dim=1))

    def gram_block(self, x) -> np.ndarray:
        live = sorted(self._valid)
        out = np.zeros((x.shape[0], self.capacity))
        if live:
            out[:, live] = self.gram(x, live)
        return out

    def combine(self, coeff: np.ndarray, slots: Sequence[int],
                prefetch: bool = True) -> Tensor:
        coeff = np.atleast_2d(np.asarray(coeff, dtype=np.float64))
        acc = torch.zeros((coeff.shape[0], self.n), dtype=self.dtype, device=self.device)
        cdev = self._to_device(coeff)
        for _, sl, blk in self._stream(slots, prefetch):
            acc = acc + torch.matmul(cdev[:, sl], blk)
        return acc

    def mgs_sweep(self, r, slots: Sequence[int], inv_norms) -> Tensor:
        rd = self._to_device(r)
        w = self._to_device(np.asarray(inv_norms, dtype=np.float64))
        for _, sl, blk in self._stream(slots):
            rd = rd - torch.matmul(torch.matmul(rd, blk.T) * w[None, sl], blk)
        return rd
