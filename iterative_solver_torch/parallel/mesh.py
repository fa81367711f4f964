"""Process-group mesh and sharding descriptors (port of
iterative_solver_tpu/parallel/mesh.py) — the replacement for the
reference's MPI communicator + Distribution plumbing (SURVEY.md §2.5).

The JAX package runs one controller over a device mesh and lets GSPMD
insert the collectives. PyTorch has no partitioner for plain tensors, so
the port runs the reference's own model: one process per shard (SPMD), each
rank holding a contiguous slice of the vector axis N, and an explicit
collective (``parallel/collectives.py``) wherever GSPMD inserts a psum.

- ``Mesh`` is a 1-D mesh: the ranks of a ``torch.distributed`` process
  group, with this rank's device and the group's backend;
- ``Sharding`` says which dimension of an array is split over the mesh
  (``spec``, as a PartitionSpec there: ``(None, "data")`` splits the last
  dimension of an (m, N) block). A split dimension of global length n is
  cut into chunks of ceil(n / size), rank r holding
  ``[r c, min((r + 1) c, n))``, the layout of a JAX NamedSharding;
- ``init_process_group`` takes the place of ``init_multi_host``: nothing
  tells a program of its cluster, so the caller gives the address, the
  world size and the rank. The backend follows the device: NCCL on CUDA
  where each rank has a card of its own, gloo otherwise, or whichever the
  caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config as _config

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a process group (``group=None``: the default group)."""

    group: Optional[object]
    axis: str
    size: int
    rank: int
    backend: str
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    def staged(self, t: torch.Tensor) -> bool:
        """True where a collective on ``t`` goes through host memory: the
        gloo backend with a CUDA tensor."""
        return self.backend == "gloo" and t.is_cuda


def _rank_device(device) -> torch.device:
    device = _config.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(group=None, axis: str = DATA_AXIS, device=None) -> Mesh:
    """1-D mesh over the ranks of ``group`` (the default group when None);
    ``device=None`` is this rank's CUDA device (raises without CUDA)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised: call "
                           "parallel.mesh.init_process_group first")
    return Mesh(group=group, axis=axis, size=dist.get_world_size(group),
                rank=dist.get_rank(group), backend=str(dist.get_backend(group)),
                device=_rank_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Which dimension of an array is split over ``mesh``: ``spec`` names
    the mesh axis at the split dimension and None elsewhere; () is
    replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def adapt(self, ndim: int) -> "Sharding":
        """The spec fitted to an array rank by its trailing axes, so a
        (rows, N) block spec applies to an (N,) vector as (N,)
        (vector_ops.py:180-196 of the JAX package)."""
        spec = tuple(self.spec)
        if len(spec) > ndim:
            spec = spec[len(spec) - ndim:]
        elif len(spec) < ndim:
            spec = (None,) * (ndim - len(spec)) + spec
        return Sharding(self.mesh, spec)

    def split_dim(self, ndim: int) -> Optional[int]:
        spec = self.adapt(ndim).spec
        return spec.index(self.mesh.axis) if self.mesh.axis in spec else None

    def local_range(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of a split dimension of length n."""
        return local_range(n, self.mesh.size, self.mesh.rank)

    def shard(self, x, dtype=None) -> torch.Tensor:
        """This rank's slice of the global array ``x`` (numpy or tensor), on
        the mesh's device."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        dim = self.split_dim(t.dim())
        if dim is not None:
            lo, hi = self.local_range(t.shape[dim])
            t = t.narrow(dim, lo, hi - lo)
        return t.to(device=self.mesh.device, dtype=dtype).contiguous()

    def gather(self, x_local: torch.Tensor, n: int) -> torch.Tensor:
        """The global array of which ``x_local`` is this rank's slice, on
        every rank (an all-gather along the split dimension)."""
        from .collectives import all_gather

        dim = self.split_dim(x_local.dim())
        if dim is None:
            return x_local
        return all_gather(x_local, self.mesh, dim=dim, n=n)


def check_sharding(sharding, ndim: int = 2) -> Optional[Sharding]:
    """``sharding`` fitted to ``ndim`` (None stays None); anything but a
    ``Sharding`` raises TypeError."""
    if sharding is None:
        return None
    if not isinstance(sharding, Sharding):
        raise TypeError(f"sharding must be a parallel.mesh.Sharding (e.g. "
                        f"block_sharding(mesh)), got {type(sharding).__name__}")
    return sharding.adapt(ndim)


def local_range(n: int, size: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``rank`` when n is cut into chunks of ceil(n/size)."""
    c = -(-n // size)
    lo = min(rank * c, n)
    return lo, min(lo + c, n)


def block_sharding(mesh: Mesh, axis: Optional[str] = None) -> Sharding:
    """(m, N) row blocks: rows replicated, the vector axis split."""
    return Sharding(mesh, (None, axis or mesh.axis))


def vector_sharding(mesh: Mesh, axis: Optional[str] = None) -> Sharding:
    """(N,) vectors, e.g. diagonals."""
    return Sharding(mesh, (axis or mesh.axis,))


def matrix_row_sharding(mesh: Mesh, axis: Optional[str] = None) -> Sharding:
    """An (N, N) operator partitioned by output rows."""
    return Sharding(mesh, (axis or mesh.axis, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def init_process_group(init_method: str, world_size: int, rank: int,
                       backend: Optional[str] = None, device=None,
                       axis: str = DATA_AXIS) -> Mesh:
    """Join this process to the group and return the global 1-D mesh.

    ``init_method`` is a ``tcp://host:port`` or ``file://path`` address.
    ``backend=None`` chooses NCCL when the device is CUDA and every rank can
    have a card of its own (``torch.cuda.device_count() >= world_size``),
    gloo otherwise; with NCCL rank r takes card r. ``device=None`` is the
    CUDA device (raises without CUDA)."""
    device = _config.resolve_device(device)
    if backend is None:
        own_card = device.type == "cuda" and torch.cuda.device_count() >= world_size
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return make_mesh(axis=axis, device=device)
