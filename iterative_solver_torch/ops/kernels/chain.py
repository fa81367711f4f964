"""Fused expand chain of the Davidson step: precondition + Gram-Schmidt +
norms + Gram.

Counterpart of iterative_solver_tpu/ops/kernels/chain_pallas.py. The chain

    t = r / (diag - lambda)          (Jacobi, IterativeSolver.h:34-44)
    n0 = row_norms2(t)
    2 x [ proj = (t v^T) * mask ; t -= proj v ]    (classical GS, 2 passes)
    n2 = row_norms2(t)
    g  = t t^T                       (whitening Gram)

is ~10 small operations. ``fused_expand_chain`` runs it as one kernel call
(K2, CUDA C++ for sm_90a in ``csrc/chain.cu``, replacing ``_chain_impl`` /
``_chain_kernel_body``): a short sequence of launches over N-chunks on one
stream, because every product in the chain is a reduction over N that must
finish before the next step. For a CPU tensor the wrapper runs the plain
version ``expand_chain``. Only the O(r^2) whitening (Cholesky of g and a
triangular solve) stays outside, in ``whiten_after_chain``.

The TPU's auto policy ``fits_vmem`` guarded the grid-free kernel's VMEM
arena. The GPU design has no such arena to guard: ``chain_auto`` turns the
kernel on whenever the device is CUDA and the dtype float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ... import config as _config  # noqa: F401  (precision pins)
from ...array.vector_ops import chol_jitter
from . import _build

Tensor = torch.Tensor

# launches of the chain kernel, counted by the wrapper
LAUNCHES = {"chain": 0}


def chain_auto(device, dtype) -> bool:
    """The GPU auto policy for ``fuse_chain``: on for float32 on CUDA."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def expand_chain(r: Tensor, v: Tensor, mask: Tensor,
                 diag: Optional[Tensor] = None, evals: Optional[Tensor] = None,
                 gs_passes: int = 2) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K2 (chain_pallas.py:63-81)."""
    if diag is not None:
        scale = torch.max(torch.abs(diag)) + torch.max(torch.abs(evals))
        t = r / (diag[None, :] - evals[:, None] + 1e-15 * scale + 1e-300)
    else:
        t = r
    n0 = torch.sum(t * t, dim=1)
    for _ in range(gs_passes):
        proj = torch.matmul(t, v.T) * mask[None, :]
        t = t - torch.matmul(proj, v)
    n2 = torch.sum(t * t, dim=1)
    g = torch.matmul(t, t.T)
    return t, n0, n2, g


@functools.cache
def _chain_lib():
    lib = _build.load("chain")
    lib.chain_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.chain_f32.restype = ctypes.c_int
    return lib


def fused_expand_chain(r: Tensor, v: Tensor, mask: Tensor,
                       diag: Optional[Tensor] = None,
                       evals: Optional[Tensor] = None,
                       gs_passes: int = 2) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Run the expand chain as one kernel call (replaces
    ``chain_pallas.fused_expand_chain``).

    With ``diag``/``evals`` given, ``r`` is the residual block and the
    kernel applies the Jacobi preconditioner first; otherwise ``r`` is
    already the new-direction block (custom ``expand`` hooks).

    Returns ``(t, n0_2, n2, g)``: the block after ``gs_passes`` classical
    Gram-Schmidt passes against the masked basis ``v``, its pre/post-GS
    squared row norms ``(nroots,)``, and the unnormalised Gram ``t t^T``.
    """
    if r.device.type == "cpu":
        return expand_chain(r, v, mask, diag, evals, gs_passes)
    nroots, n = r.shape
    m_max = v.shape[0]
    jacobi = diag is not None
    operands = [("r", r, (nroots, n)), ("v", v, (m_max, n)), ("mask", mask, (m_max,))]
    if jacobi:
        operands += [("diag", diag, (n,)), ("evals", evals, (nroots,))]
    for name, arr, shape in operands:
        if arr.device != r.device or arr.dtype != torch.float32:
            raise TypeError(f"the CUDA chain kernel takes float32 tensors on "
                            f"{r.device}; {name} is {arr.dtype} on {arr.device}")
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(arr.shape)}")
    if gs_passes < 1:
        raise ValueError("the CUDA chain kernel runs at least one GS pass")
    r, v, mask = r.contiguous(), v.contiguous(), mask.contiguous()
    if jacobi:
        diag, evals = diag.contiguous(), evals.contiguous()
    t = torch.empty_like(r)
    # [2 absmax | gs_passes*R*M proj | R n0 | R n2 | R*R g], zeroed
    proj_len = gs_passes * nroots * m_max
    scratch = torch.zeros(2 + proj_len + 2 * nroots + nroots * nroots,
                          dtype=torch.float32, device=r.device)
    lib = _chain_lib()
    err = lib.chain_f32(
        r.data_ptr(), t.data_ptr(), v.data_ptr(), mask.data_ptr(),
        diag.data_ptr() if jacobi else None, evals.data_ptr() if jacobi else None,
        scratch.data_ptr(), nroots, m_max, n, gs_passes,
        _build.stream_handle(r.device))
    _build.check(lib, err, "chain_f32")
    LAUNCHES["chain"] += 1
    off = 2 + proj_len
    n0 = scratch[off:off + nroots]
    n2 = scratch[off + nroots:off + 2 * nroots]
    g = scratch[off + 2 * nroots:].view(nroots, nroots)
    return t, n0, n2, g


def _cholesky_nan(g: Tensor) -> Tensor:
    """Lower Cholesky factor, NaN-filled where the factorisation fails —
    ``jnp.linalg.cholesky``'s contract, which the solvers' non-finite
    checks rely on. ``cholesky_ex`` neither raises nor syncs the host."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def whiten_after_chain(t: Tensor, n0_2: Tensor, n2: Tensor, nroots: int,
                       null_thresh: float, g: Optional[Tensor] = None):
    """Null-drop + Cholesky whitening shared by the fused solver families
    (chain_pallas.py:123-168).

    Given a post-Gram-Schmidt block ``t`` with its pre/post-GS squared row
    norms, drop rows annihilated relative to their own magnitude and whiten
    the survivors so the appended basis rows are orthonormal. Two
    algebraically identical application forms, kept separate as in the JAX
    package:

    - ``g`` given (the chain kernel's UNnormalised Gram): rescale it to unit
      diagonal and apply L^{-1} diag(s) as ONE (r, r) @ (r, N) matmul;
    - ``g`` None: normalise rows, form the Gram, and run the triangular
      solve on the (r, N) block directly.

    Returns ``(t, keep)`` — the whitened block and the surviving-row mask.
    """
    keep = n2 > null_thresh**2 * torch.clamp(n0_2, min=1e-300)
    one = torch.ones_like(n2)
    s = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, n2, one)),
                    torch.zeros_like(n2))
    fused = g is not None
    if fused:
        g = s[:, None] * g * s[None, :]
    else:
        t = t * s[:, None]
        g = torch.matmul(t, t.T)
    g = torch.where(keep[:, None] & keep[None, :], g, torch.zeros_like(g))
    # dead rows get a unit diagonal so the Cholesky stays defined; live rows
    # a dtype-aware jitter ABOVE the Gram roundoff (two near-parallel
    # surviving rows otherwise give an indefinite f32 Gram)
    jit = torch.where(keep, torch.full_like(n2, chol_jitter(g.dtype)), one)
    g = g + torch.diag(jit)
    l = _cholesky_nan(g)
    if fused:
        ws = torch.linalg.solve_triangular(l, torch.diag(s), upper=False)
        ws = ws * keep[:, None].to(ws.dtype)
        return torch.matmul(ws, t), keep
    t = torch.linalg.solve_triangular(l, t, upper=False)
    return t * keep[:, None].to(t.dtype), keep
