"""Fused expand chain of the Davidson step: precondition + Gram-Schmidt +
norms + Gram.

Counterpart of iterative_solver_tpu/ops/kernels/chain_pallas.py. The chain

    t = r / (diag - lambda)          (Jacobi, IterativeSolver.h:34-44)
    n0 = row_norms2(t)
    2 x [ proj = (t v^T) * mask ; t -= proj v ]    (classical GS, 2 passes)
    n2 = row_norms2(t)
    g  = t t^T                       (whitening Gram)

is ~10 small operations. ``fused_expand_chain`` runs it as one kernel launch
(K2, CUDA C++ for sm_90a in ``csrc/chain.cu``, replacing ``_chain_impl`` /
``_chain_kernel_body``): a cooperative launch whose CTAs own fixed steps of
columns (``chain_steps``), with grid-wide barriers between the chain's
dependent steps, because every product in the chain is a reduction over N
that must finish before the next step uses it. Every partial sum is added
in a fixed order, so a card gives the same bits on every call;
``expand_chain_emulated`` follows that partition and order in plain
PyTorch for the CPU tests. For a CPU tensor the wrapper runs the plain
version ``expand_chain``. Only the O(r^2) whitening (Cholesky of g and a
triangular solve) stays outside, in ``whiten_after_chain``.

The TPU's auto policy ``fits_vmem`` guarded the grid-free kernel's VMEM
arena. The GPU design has no such arena to guard: ``chain_auto`` turns the
kernel on whenever the device is CUDA and the dtype float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

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


# K2's column partition and summation order (csrc/chain.cu): the columns
# are cut into steps of CHAIN_STEP, CTA b of G streams the steps b, b + G,
# ...; a thread's sums over its steps are added in groups of CHAIN_GROUP
CHAIN_STEP = 128
CHAIN_GROUP = 8
CHAIN_THREADS = 256
# the fast path's padded row counts of r (RP) and of v (MP)
CHAIN_FAST_ROWS = (16, 32)
CHAIN_FAST_BASIS = (64, 128)


def chain_fast_dims(nroots: int, m_max: int) -> Optional[Tuple[int, int]]:
    """``(RP, MP)`` of K2's fast path for r (nroots, n) and v (m_max, n), or
    None where the shape takes its second (scalar) path."""
    rp = next((p for p in CHAIN_FAST_ROWS if nroots <= p), None)
    mp = next((p for p in CHAIN_FAST_BASIS if m_max <= p), None)
    return None if rp is None or mp is None else (rp, mp)


def chain_steps(n: int, ctas: int):
    """K2's column partition: for each of ``ctas`` CTAs, the ``(c0, c1)``
    of its steps in the order it streams them. Every column lies in exactly
    one step of one CTA; the partition depends only on n and the CTA count,
    so one card gives the same bits on every call."""
    total = -(-n // CHAIN_STEP)
    return [[(s * CHAIN_STEP, min(n, (s + 1) * CHAIN_STEP)) for s in range(b, total, ctas)]
            for b in range(ctas)]


def chain_slot_floats(nroots: int, m_max: int) -> int:
    """Floats of one CTA's partial slot: the larger of a pass's partials,
    the projection (R M) or the Gram (R R), padded to 4. The row norms
    have a float64 slot of their own."""
    return -(-nroots * max(m_max, nroots) // 4) * 4


def chain_ctas(nroots: int, m_max: int, n: int, capacity: int) -> int:
    """K2's CTA count: one per step of columns, and enough that a CTA adds
    at most 64 entries of a pass's partials, but no more than the card
    holds at once (the launch is cooperative): 64 at n = 8192, the card's
    capacity at n = 2^20."""
    want = max(1, -(-n // CHAIN_STEP), -(-chain_slot_floats(nroots, m_max) // 64))
    return max(1, min(capacity, want))


def _chain_index(n: int, ctas: int) -> Tensor:
    """(ctas, steps * CHAIN_STEP) column of each CTA's steps, n past n."""
    plan = chain_steps(n, ctas)
    steps = max(1, max(len(p) for p in plan))
    idx = torch.full((ctas, steps, CHAIN_STEP), n, dtype=torch.long)
    for b, p in enumerate(plan):
        for s, (c0, c1) in enumerate(p):
            idx[b, s, :c1 - c0] = torch.arange(c0, c1)
    return idx.reshape(ctas, -1)


def _by_step(x: Tensor, idx: Tensor) -> Tensor:
    """(rows, n) -> (rows, ctas, steps, CHAIN_STEP), zero past n."""
    xp = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
    return xp[:, idx.to(x.device)].reshape(x.shape[0], idx.shape[0], -1, CHAIN_STEP)


def _over_steps(x: Tensor, dim: int) -> Tensor:
    """A thread's sum of its step sums (``dim`` of x): groups of CHAIN_GROUP
    steps in order, then the groups in order."""
    x = x.movedim(dim, 0)
    l2 = torch.zeros_like(x[0])
    l3 = torch.zeros_like(l2)
    for s in range(x.shape[0]):
        l2 = l2 + x[s]
        if (s + 1) % CHAIN_GROUP == 0:
            l3, l2 = l3 + l2, torch.zeros_like(l2)
    return l3 + l2


def _adjacent_tree(x: Tensor) -> Tensor:
    """Pairwise sum over the last dim (a power of 2): (x0 + x1) + (x2 + x3)..."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _halving_tree(x: Tensor) -> Tensor:
    """Lane 0's sum of a shuffle-down tree over the last dim (a power of
    2): x[i] += x[i + h] for h = half, ..., 1."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _slot_sum(x: Tensor) -> Tensor:
    """(..., ctas) partials -> (...): lane j of a warp adds slots j, j + 32,
    ... in order, then a shuffle tree (the row norms in float64 alike)."""
    g = x.shape[-1]
    k = -(-g // 32)
    x = torch.nn.functional.pad(x, (0, 32 * k - g)).reshape(*x.shape[:-1], k, 32)
    acc = x[..., 0, :]
    for j in range(1, k):
        acc = acc + x[..., j, :]
    return _halving_tree(acc)


def _cta_products(a: Tensor, b: Tensor, kg: int) -> Tensor:
    """(ra, ctas, steps, STEP) x (rb, ...) -> (ra, rb, ctas): each CTA's
    partial of a bᵀ. k-group j of ``kg`` takes the float4 columns j, j + kg,
    ... of a step; its step sums go through ``_over_steps``, and the
    k-groups are added pairwise."""
    def split(x):
        return x.reshape(*x.shape[:3], CHAIN_STEP // 4 // kg, kg, 4)
    step = torch.einsum("icsjgk,mcsjgk->imcsg", split(a), split(b))
    return _adjacent_tree(_over_steps(step, 3))


def _cta_norms(t: Tensor) -> Tensor:
    """(r, ctas, steps, STEP) -> (r, ctas) in float64: a thread squares and
    adds its 4 columns in order, the STEP / 4 lanes of a row add by a
    shuffle tree, then ``_over_steps``."""
    x = t.to(torch.float64).reshape(*t.shape[:3], CHAIN_STEP // 4, 4)
    s = x[..., 0] * x[..., 0]
    for k in range(1, 4):
        s = s + x[..., k] * x[..., k]
    return _over_steps(_halving_tree(s), 2)


def expand_chain_emulated(r: Tensor, v: Tensor, mask: Tensor,
                          diag: Optional[Tensor] = None, evals: Optional[Tensor] = None,
                          gs_passes: int = 2, ctas: int = 264):
    """Plain emulation of K2's fast path for the CPU tests: the same
    chain as ``expand_chain`` with the kernel's column partition over
    ``ctas`` CTAs and its order of every sum over columns (``_cta_products``,
    ``_cta_norms``, ``_slot_sum``; the row norms in float64 through
    ``_norm_slot_sum``, rounded once),
    and the subtraction t - (P mask) v with the basis rows cut into the
    kernel's groups, added pairwise. Only the order of the few products
    inside one thread's step (its einsum) and FMA rounding differ from the
    card."""
    nroots, n = r.shape
    m_max = v.shape[0]
    dims = chain_fast_dims(nroots, m_max)
    if dims is None:
        raise ValueError(f"K2's fast path takes at most {CHAIN_FAST_ROWS[-1]} rows and "
                         f"{CHAIN_FAST_BASIS[-1]} basis rows, got {nroots} and {m_max}")
    rp, mp = dims
    idx = _chain_index(n, ctas)
    if diag is not None:
        scale = torch.max(torch.abs(diag)) + torch.max(torch.abs(evals))
        t = r / ((diag[None, :] - evals[:, None]) + 1e-15 * scale)
    else:
        t = r.clone()
    sub_groups = CHAIN_THREADS // (rp * CHAIN_STEP // 16)
    per = mp // sub_groups
    n0 = _slot_sum(_cta_norms(_by_step(t, idx))).to(t.dtype)
    for _ in range(gs_passes):
        proj = _slot_sum(_cta_products(_by_step(t, idx), _by_step(v, idx),
                                       CHAIN_THREADS // ((rp // 4) * (mp // 4))))
        p = proj * mask[None, :]
        parts = [torch.matmul(p[:, j * per:(j + 1) * per], v[j * per:(j + 1) * per])
                 for j in range(sub_groups)]
        t = t - _adjacent_tree(torch.stack(parts, dim=-1))
    tg = _by_step(t, idx)
    n2 = _slot_sum(_cta_norms(tg)).to(t.dtype)
    g = _slot_sum(_cta_products(tg, tg, CHAIN_THREADS // (rp // 4) ** 2))
    return t, n0, n2, g


@functools.cache
def _chain_lib():
    lib = _build.load("chain")
    lib.chain_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.chain_f32.restype = ctypes.c_int
    lib.chain_capacity.argtypes = [ctypes.c_int] * 4
    lib.chain_capacity.restype = ctypes.c_int
    return lib


# the CTAs each card holds at once, per (device, kernel variant); the
# partials' scratch per (device, stream), grown as needed
_capacity: Dict[Tuple[int, Tuple], int] = {}
_scratch: Dict[Tuple[int, int], Tensor] = {}


def _aligned(*tensors: Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _chain_capacity(device, nroots: int, m_max: int, n: int, aligned: bool) -> int:
    dims = chain_fast_dims(nroots, m_max) if aligned and n % 4 == 0 else None
    # the second path's shared memory holds the (R, M) projection
    key = (device.index, dims or (nroots, m_max))
    cap = _capacity.get(key)
    if cap is None:
        with torch.cuda.device(device):
            cap = _chain_lib().chain_capacity(nroots, m_max, n, int(aligned))
        if cap < 1:
            raise RuntimeError(f"chain_capacity: CUDA error {-cap} (the chain kernel "
                               f"fits no CTA on this card)")
        cap = _capacity[key] = cap
    return cap


def _chain_scratch(device, stream: int, floats: int) -> Tensor:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < floats:
        buf = _scratch[key] = torch.empty(floats, dtype=torch.float32, device=device)
    return buf


def fused_expand_chain(r: Tensor, v: Tensor, mask: Tensor,
                       diag: Optional[Tensor] = None,
                       evals: Optional[Tensor] = None,
                       gs_passes: int = 2) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Run the expand chain as one kernel launch (replaces
    ``chain_pallas.fused_expand_chain``).

    With ``diag``/``evals`` given, ``r`` is the residual block and the
    kernel applies the Jacobi preconditioner first; otherwise ``r`` is
    already the new-direction block (custom ``expand`` hooks).

    Returns ``(t, n0_2, n2, g)``: the block after ``gs_passes`` classical
    Gram-Schmidt passes against the masked basis ``v``, its pre/post-GS
    squared row norms ``(nroots,)``, and the unnormalised Gram ``t t^T``.
    A CUDA tensor launches K2 (cooperatively, ``chain_ctas`` CTAs) or the
    wrapper raises; a CPU tensor takes the plain version.
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
    out = torch.empty(2 * nroots + nroots * nroots, dtype=torch.float32, device=r.device)
    aligned = _aligned(r, t, v)
    ctas = chain_ctas(nroots, m_max, n, _chain_capacity(r.device, nroots, m_max, n, aligned))
    stream = _build.stream_handle(r.device)
    # [absmax per CTA | published projection R*M | one partial slot per CTA |
    # float64 row norms per CTA]
    floats = -(-ctas // 4) * 4 + -(-nroots * m_max // 4) * 4 + \
        ctas * chain_slot_floats(nroots, m_max) + 2 * ctas * nroots
    scratch = _chain_scratch(r.device, stream.value, floats)
    lib = _chain_lib()
    err = lib.chain_f32(
        r.data_ptr(), t.data_ptr(), v.data_ptr(), mask.data_ptr(),
        diag.data_ptr() if jacobi else None, evals.data_ptr() if jacobi else None,
        out.data_ptr(), out[nroots:].data_ptr(), out[2 * nroots:].data_ptr(),
        scratch.data_ptr(), nroots, m_max, n, gs_passes, ctas, stream)
    _build.check(lib, err, "chain_f32")
    LAUNCHES["chain"] += 1
    return t, out[:nroots], out[nroots:2 * nroots], out[2 * nroots:].view(nroots, nroots)


def _cholesky_nan(g: Tensor) -> Tensor:
    """Lower Cholesky factor, NaN-filled where the factorisation fails —
    ``jnp.linalg.cholesky``'s contract, which the solvers' non-finite
    checks rely on. ``cholesky_ex`` neither raises nor syncs the host."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def lower_solve(l: Tensor, x: Tensor) -> Tensor:
    """L⁻¹ x for a small (r, r) lower factor and a wide (r, N) block. On
    CUDA, PyTorch's triangular solve with N right-hand sides slows to
    seconds at N near a million, so L⁻¹ is formed against the small
    identity and applied as one matmul (the form ``whiten_after_chain``
    uses)."""
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.matmul(torch.linalg.solve_triangular(l, eye, upper=False), x)


def whiten_after_chain(t: Tensor, n0_2: Tensor, n2: Tensor, nroots: int,
                       null_thresh: float, g: Optional[Tensor] = None, sharding=None):
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
    ``sharding``: ``t`` is this rank's slice of N (parallel/mesh.py) and its
    Gram is all-reduced.
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
        if sharding is not None:
            from ...parallel.collectives import psum

            g = psum(g, sharding)
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
