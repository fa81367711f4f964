"""PPCG's per-root 3x3 Rayleigh-Ritz as two kernel launches (K8).

The PPCG step (``solvers/fused_ppcg.py``) relaxes each root in
span{x_i, w_i, p_i}: nine row dots over N of the six (r, N) blocks x, ax,
w, aw, p, ap, a 3x3 eigenproblem per root from them (``_rr3_coeffs``, two
packed Jacobi eigensolves), and the update of x, ax, p, ap by the lowest
eigenvector's coefficients. Eagerly that is 9 row dots, ~1,970 elementwise
kernels on (r,) vectors and ~16 passes over the blocks. K8 is CUDA C++ for
sm_90a (``csrc/rr3.cu``), a hand-written counterpart of that eager chain
(no Pallas kernel: the JAX package leaves the step to XLA):

- ``rr3_dots``: one pass over the six blocks gives the (9, r) dots in
  ``RR3_PAIRS``' order, every sum in a fixed order (float64 inside, rounded
  once), so a card gives the same bits on every call;
  ``rr3_dots_emulated`` follows the kernel's column partition and order in
  plain PyTorch for the CPU tests, and ``rr3_dots_plain`` is the eager
  version (the row dots ``_rr3_dots`` takes).
- ``rr3_update``: one launch solves each root's 3x3 problem from the dots
  and the live masks, operation by operation as ``_rr3_coeffs`` does, then
  writes the four updated blocks; given the same dots it gives the eager
  chain's bits. Its plain version is ``_rr3_coeffs`` followed by
  ``rr3_update_plain``.

Both wrappers take float32 CUDA tensors only and raise on any other,
each launch counted in ``LAUNCHES``; off the card the step takes the plain
versions. ``rr3_auto`` is the step's choice: the kernels for float32 on
CUDA, the eager chain otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ... import config as _config  # noqa: F401  (precision pins)
from . import _build

Tensor = torch.Tensor

# launches of K8's two kernels, counted by the wrappers
LAUNCHES = {"rr3_dots": 0, "rr3_update": 0}

# the (9, r) dots: pairs of (x, ax, w, aw, p, ap), the row order of
# _rr3_dots: (x,w) (x,p) (w,p) (x,ax) (w,ax) (p,ax) (w,aw) (p,aw) (p,ap)
RR3_PAIRS = ((0, 2), (0, 4), (2, 4), (0, 1), (2, 1), (4, 1), (2, 3), (4, 3), (4, 5))

# K8's column partition and summation order (csrc/rr3.cu): steps of
# RR3_STEP columns, thread t of a CTA taking 4 columns of each step
RR3_THREADS = 256
RR3_STEP = 4 * RR3_THREADS
RR3_WARP = 32
# CTAs aimed at per launch (about four for each of the H100's 132 SMs)
RR3_TARGET_CTAS = 512


def rr3_auto(device, dtype) -> bool:
    """The step's policy: K8 for float32 on CUDA, the eager chain otherwise."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def rr3_chunks(nroots: int, n: int) -> int:
    """Column chunks of each row: CTA (c, i) takes row i and the steps c,
    c + chunks, ... of RR3_STEP columns. A function of r and N alone, so
    the sums' order does not depend on the card."""
    steps = -(-n // RR3_STEP)
    return max(1, min(steps, -(-RR3_TARGET_CTAS // nroots)))


def rr3_dots_plain(x, ax, w, aw, p, ap) -> Tensor:
    """The eager (9, r) row dots."""
    blocks = (x, ax, w, aw, p, ap)
    return torch.stack([torch.einsum("in,in->i", blocks[i], blocks[j]) for i, j in RR3_PAIRS])


def _halving_tree(x: Tensor) -> Tensor:
    """Lane 0's sum of a shuffle-down tree over the last dim (a power of
    2): x[i] += x[i + h] for h = half, ..., 1."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _in_order(x: Tensor) -> Tensor:
    """The sum over the last dim, first to last."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def rr3_dots_emulated(x, ax, w, aw, p, ap) -> Tensor:
    """Plain emulation of ``rr3_dots`` for the CPU tests: the kernel's
    column partition (``rr3_chunks``) and its order of every sum, in
    float64 (a float32 product is exact there), rounded once. Each thread
    adds its columns step by step, a warp adds its lanes by a shuffle-down
    tree, a CTA its warps in order and a row its CTAs in order."""
    r, n = x.shape
    chunks = rr3_chunks(r, n)
    total = -(-n // RR3_STEP)
    steps = -(-total // chunks)     # of the most a CTA takes; the others' last is past n
    step = (torch.arange(chunks)[:, None] + chunks * torch.arange(steps)[None, :])
    cols = (step[:, :, None, None] * RR3_STEP
            + 4 * torch.arange(RR3_THREADS)[None, None, :, None] + torch.arange(4))
    cols = torch.where(cols < n, cols, n)      # (chunks, steps, threads, 4); n reads zero
    padded = [torch.cat([b.to(torch.float64), b.new_zeros((r, 1), dtype=torch.float64)], 1)
              for b in (x, ax, w, aw, p, ap)]
    acc = torch.zeros((len(RR3_PAIRS), r, chunks, RR3_THREADS), dtype=torch.float64)
    for s in range(steps):
        for k in range(4):
            v = [b[:, cols[:, s, :, k]] for b in padded]
            acc = acc + torch.stack([v[i] * v[j] for i, j in RR3_PAIRS])
    warps = _halving_tree(acc.reshape(*acc.shape[:3], RR3_THREADS // RR3_WARP, RR3_WARP))
    return _in_order(_in_order(warps)).to(x.dtype)


def rr3_update_plain(c: Tensor, x, ax, w, aw, p, ap) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The eager four-block update by the (r, 3) coefficients:
    ``(x', ax', p', ap')``."""
    x_new = c[:, 0:1] * x + c[:, 1:2] * w + c[:, 2:3] * p
    ax_new = c[:, 0:1] * ax + c[:, 1:2] * aw + c[:, 2:3] * ap
    p_new = c[:, 1:2] * w + c[:, 2:3] * p
    ap_new = c[:, 1:2] * aw + c[:, 2:3] * ap
    return x_new, ax_new, p_new, ap_new


@functools.cache
def _rr3_lib():
    lib = _build.load("rr3")
    lib.rr3_dots_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rr3_dots_f32.restype = ctypes.c_int
    lib.rr3_update_f32.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rr3_update_f32.restype = ctypes.c_int
    return lib


def _blocks(blocks, shape, device):
    if device.type != "cuda":
        raise TypeError(f"K8 launches on CUDA tensors, got {device}")
    out = []
    for name, b in zip(("x", "ax", "w", "aw", "p", "ap"), blocks):
        if b.device != device or b.dtype != torch.float32:
            raise TypeError(f"K8 takes float32 tensors on {device}; {name} is {b.dtype} "
                            f"on {b.device}")
        if tuple(b.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(b.shape)}")
        out.append(b.contiguous())
    return out


def rr3_dots(x, ax, w, aw, p, ap) -> Tensor:
    """The (9, r) row dots of the per-root Rayleigh-Ritz, one launch (K8's
    first kernel). A CUDA tensor only: off the card the step takes
    ``rr3_dots_plain``."""
    nroots, n = x.shape
    blocks = _blocks((x, ax, w, aw, p, ap), (nroots, n), x.device)
    chunks = rr3_chunks(nroots, n)
    # one allocation for the call: the CTAs' float64 partials, then the
    # (9, r) result and the per-row counters; the result keeps it alive
    nparts = nroots * chunks * len(RR3_PAIRS)
    buf = torch.empty(nparts + -(-(len(RR3_PAIRS) + 1) * nroots // 2), dtype=torch.float64,
                      device=x.device)
    part, tail = buf[:nparts], buf[nparts:].view(torch.float32)
    out = tail[:len(RR3_PAIRS) * nroots].view(len(RR3_PAIRS), nroots)
    count = tail[len(RR3_PAIRS) * nroots:(len(RR3_PAIRS) + 1) * nroots]
    stream = _build.stream_handle(x.device)
    lib = _rr3_lib()
    err = lib.rr3_dots_f32(*(b.data_ptr() for b in blocks), out.data_ptr(), part.data_ptr(),
                           count.data_ptr(), nroots, n, chunks, stream)
    _build.check(lib, err, "rr3_dots_f32")
    LAUNCHES["rr3_dots"] += 1
    return out


def rr3_update(dots: Tensor, live_w: Tensor, live_p: Tensor, x, ax, w, aw, p, ap):
    """The coefficients of each root's lowest Ritz pair from its (9, r)
    ``dots`` and live masks, and the updated blocks, one launch (K8's second
    kernel). Returns ``(x', ax', p', ap', c)`` with c the (r, 3)
    coefficients. A CUDA tensor only: off the card the step takes
    ``_rr3_coeffs`` and ``rr3_update_plain``."""
    nroots, n = x.shape
    blocks = _blocks((x, ax, w, aw, p, ap), (nroots, n), x.device)
    if dots.device != x.device or dots.dtype != torch.float32 or \
            tuple(dots.shape) != (len(RR3_PAIRS), nroots):
        raise ValueError(f"dots must be float32 ({len(RR3_PAIRS)}, {nroots}) on {x.device}")
    for name, m in (("live_w", live_w), ("live_p", live_p)):
        if m.device != x.device or m.dtype != torch.bool or tuple(m.shape) != (nroots,):
            raise ValueError(f"{name} must be bool ({nroots},) on {x.device}")
    dots, live_w, live_p = dots.contiguous(), live_w.contiguous(), live_p.contiguous()
    new = [torch.empty_like(blocks[0]) for _ in range(4)]
    c = torch.empty((nroots, 3), dtype=torch.float32, device=x.device)
    stream = _build.stream_handle(x.device)
    lib = _rr3_lib()
    err = lib.rr3_update_f32(dots.data_ptr(), live_w.data_ptr(), live_p.data_ptr(),
                             *(b.data_ptr() for b in blocks), *(t.data_ptr() for t in new),
                             c.data_ptr(), nroots, n, rr3_chunks(nroots, n), stream)
    _build.check(lib, err, "rr3_update_f32")
    LAUNCHES["rr3_update"] += 1
    return (*new, c)
