"""Explicit collectives of the distributed hot path (port of
iterative_solver_tpu/parallel/collectives.py).

The JAX package writes its Gram, dot and reconstruction with ``shard_map``
and one psum each, the reference's local gemm + MPI_Allreduce
(array/util/gemm.h:31-46). Here every rank runs the same program on its own
slice of the vector axis and calls these functions where GSPMD would insert
a collective:

- ``all_gather``     the halo of the packed action (every column block);
- ``reduce_scatter`` partial (m, N) results back to each rank's slice;
- ``all_reduce``     every contraction over N (sum) and every global max.

Each reduction adds the ranks' parts in rank order on every rank (an
all-gather or all-to-all, then a local sum), so the order of every sum is
fixed by the program and every rank gets the same bits; the backend's own
reduction algorithm never decides it.

Staging: a gloo group takes host tensors only. When the group's backend is
gloo and the tensor is on CUDA (``Mesh.staged``), a collective copies it
into one pinned host buffer, runs on the host, and copies the result back
from a second one; ``STAGED`` counts the calls, the bytes copied each way
and the host milliseconds of the whole staged collective. With NCCL the
tensors stay on the card. ``TRAFFIC`` counts every collective and the bytes
of its global operand (an all-gather's output, a reduce-scatter's input, an
all-reduce's tensor), and ``exchange_bytes``, the bytes a rank sends and
receives in all (what gloo with CUDA tensors stages, so a run on host
tensors predicts the staging of the same run on the card).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
import torch.distributed as dist

from .mesh import Mesh

Tensor = torch.Tensor

STAGED = {"calls": 0, "bytes": 0, "ms": 0.0}
TRAFFIC = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0, "bytes": 0,
           "exchange_bytes": 0}

# one pinned host buffer each way, grown on demand
_PINNED: Dict[tuple, Tensor] = {}


def reset_counters() -> None:
    STAGED.update(calls=0, bytes=0, ms=0.0)
    TRAFFIC.update(all_gather=0, reduce_scatter=0, all_reduce=0, bytes=0, exchange_bytes=0)


def _host_buffer(way: str, shape, dtype) -> Tensor:
    numel = 1
    for s in shape:
        numel *= int(s)
    buf = _PINNED.get((way, dtype))
    if buf is None or buf.numel() < numel:
        buf = torch.empty(max(numel, 1), dtype=dtype, pin_memory=True)
        _PINNED[(way, dtype)] = buf
    return buf[:numel].view(shape)


def _run(mesh: Mesh, send: Tensor, recv_shape, body: Callable[[Tensor, Tensor], None]) -> Tensor:
    """``body(send, recv)`` on tensors the backend takes: the device's own
    tensors, or (gloo with CUDA tensors) the pinned host buffers, with the
    result copied back to the device."""
    send = send.contiguous()
    numel = 1
    for d in recv_shape:
        numel *= int(d)
    TRAFFIC["exchange_bytes"] += (send.numel() + numel) * send.element_size()
    if not mesh.staged(send):
        recv = torch.empty(recv_shape, dtype=send.dtype, device=send.device)
        body(send, recv)
        return recv
    t0 = time.perf_counter()
    hs = _host_buffer("send", send.shape, send.dtype)
    hs.copy_(send)                      # waits for the stream
    hr = _host_buffer("recv", recv_shape, send.dtype)
    body(hs, hr)
    out = torch.empty(recv_shape, dtype=send.dtype, device=send.device)
    out.copy_(hr)                       # blocking: hr is reused by the next call
    STAGED["calls"] += 1
    STAGED["bytes"] += hs.numel() * hs.element_size() + hr.numel() * hr.element_size()
    STAGED["ms"] += 1e3 * (time.perf_counter() - t0)
    return out


def _gather_parts(t: Tensor, mesh: Mesh) -> Tensor:
    """(size, *t.shape): every rank's ``t``, in rank order, on every rank."""
    def body(send, recv):
        dist.all_gather(list(recv.unbind(0)), send, group=mesh.group)

    return _run(mesh, t, (mesh.size,) + tuple(t.shape), body)


def all_gather(t: Tensor, mesh: Mesh, dim: int = -1, n=None) -> Tensor:
    """The ranks' slices of ``t`` concatenated along ``dim`` in rank order.
    With ``n``, the dimension's global length, the slices are chunks of
    ceil(n / size), shorter or empty on the last ranks (``Sharding``'s
    layout): each is padded to the chunk, gathered, and the result cut to
    n."""
    dim = dim % t.dim()
    if n is not None:
        c = -(-n // mesh.size)
        if t.shape[dim] < c:
            pad = list(t.shape)
            pad[dim] = c - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = _gather_parts(t, mesh)
    TRAFFIC["all_gather"] += 1
    TRAFFIC["bytes"] += parts.numel() * parts.element_size()
    out = torch.cat(parts.unbind(0), dim=dim)
    return out if n is None else out.narrow(dim, 0, n)


def reduce_scatter(t: Tensor, mesh: Mesh, dim: int = -1) -> Tensor:
    """Sum of the ranks' ``t``, each rank keeping its chunk of ``dim``
    (t.shape[dim] must divide by the mesh size): an all-to-all of the
    chunks, then the sum of the received parts in rank order."""
    dim = dim % t.dim()
    if t.shape[dim] % mesh.size:
        raise ValueError(f"reduce_scatter: dimension {t.shape[dim]} does not divide "
                         f"over {mesh.size} ranks")
    send = torch.stack(t.chunk(mesh.size, dim=dim))

    def body(s, r):
        dist.all_to_all_single(r, s, group=mesh.group)

    parts = _run(mesh, send, tuple(send.shape), body)
    TRAFFIC["reduce_scatter"] += 1
    TRAFFIC["bytes"] += t.numel() * t.element_size()
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def all_reduce(t: Tensor, mesh: Mesh, op: str = "sum") -> Tensor:
    """``op`` ("sum" or "max") of the ranks' ``t``, the same bits on every
    rank: the parts are gathered and added in rank order."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")
    parts = _gather_parts(t, mesh)
    TRAFFIC["all_reduce"] += 1
    TRAFFIC["bytes"] += t.numel() * t.element_size()
    if op == "max":
        return torch.amax(parts, dim=0)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def barrier(mesh: Mesh) -> None:
    """Every rank waits here for the others (an all-reduce of one zero, so
    it needs nothing of the backend beyond the collectives above)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh)


def psum(t: Tensor, sharding) -> Tensor:
    """``all_reduce(t)`` over ``sharding``'s mesh; ``t`` itself unsharded."""
    return t if sharding is None else all_reduce(t, sharding.mesh)


def pmax(t: Tensor, sharding) -> Tensor:
    """The global max over ``sharding``'s mesh; ``t`` itself unsharded."""
    return t if sharding is None else all_reduce(t, sharding.mesh, "max")


def sharded_gram(mesh: Mesh):
    """``gram(x, y)``: (m, N) x (k, N) local slices -> the global (m, k)
    Gram, one all-reduce."""
    def gram(x: Tensor, y: Tensor) -> Tensor:
        return all_reduce(torch.matmul(x, y.T), mesh)

    return gram


def sharded_reconstruct(mesh: Mesh):
    """``reconstruct(coeff, basis)``: replicated (m, k) coefficients times a
    (k, N) local slice -> the (m, N) local slice; no communication."""
    def reconstruct(coeff: Tensor, basis: Tensor) -> Tensor:
        return torch.matmul(coeff, basis)

    return reconstruct


def sharded_dot(mesh: Mesh):
    """``dots(x, y)``: row-wise dots of local slices, one all-reduce."""
    def dots(x: Tensor, y: Tensor) -> Tensor:
        return all_reduce(torch.einsum("in,in->i", x, y), mesh)

    return dots


def row_sharded_matvec(mesh: Mesh):
    """``matvec(x, rows)``: a dense operator partitioned by output rows
    (``matrix_row_sharding``), ``rows`` this rank's (N_local, N) rows of A;
    x's slices are all-gathered and y's slice is ``x @ rows.T`` — the
    counterpart of ``x @ op.T`` on a row-sharded operator under GSPMD."""
    def matvec(x: Tensor, rows: Tensor) -> Tensor:
        return torch.matmul(all_gather(x, mesh, dim=1), rows.T)

    return matvec
