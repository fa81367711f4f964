"""Cheap symmetry probe for the fused solver families (port of
iterative_solver_tpu/solvers/_symmetry.py).

The fused solvers are symmetric-operator designs: their Rayleigh-Ritz
algebra assumes <u, Av> == <Au, v>. Feeding a non-symmetric operator used
to produce silently wrong answers; this probe makes it a loud, early error.

Mechanics: two random row-blocks U, V of the solver's own block shape (drawn
with ``np.random.default_rng(0)``, as in the JAX package, so both packages
probe with the same numbers), one action each, compared in host f64 against
a norm-based scale. The 1e-2 relative tolerance passes every legitimate
tier (bf16 asymmetry is O(sqrt(N)*eps_bf16); packed-triangle kernels are
symmetric by construction) while genuine asymmetry is O(1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as _config


def check_symmetric_operator(
    matvec,
    operand,
    block_shape,
    dtype,
    solver: str,
    parity_hint: str,
    device=None,
    rel_tol: float = 1e-2,
    sharding=None,
) -> None:
    """Raise ValueError if matvec is measurably non-symmetric. ``device=None``
    is the CUDA device (raises without it). With ``sharding`` the block
    shape is the global one, each rank probes with its slices of the global
    blocks, and the six sums are all-reduced, so every rank decides alike."""
    device = _config.resolve_device(device)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(block_shape)
    v = rng.standard_normal(block_shape)
    if sharding is not None:
        tu, tv = sharding.shard(u, dtype=dtype), sharding.shard(v, dtype=dtype)
    else:
        tu = torch.as_tensor(u, dtype=dtype, device=device)
        tv = torch.as_tensor(v, dtype=dtype, device=device)

    def host(a):
        return a.detach().to("cpu", torch.float64).numpy()

    wu = host(matvec(tu, operand))
    wv = host(matvec(tv, operand))
    uu = host(tu)
    vv = host(tv)
    sums = np.array([np.sum(uu * wv), np.sum(vv * wu), np.sum(uu * uu),
                     np.sum(wv * wv), np.sum(vv * vv), np.sum(wu * wu)])
    if sharding is not None:
        from ..parallel.collectives import psum

        sums = psum(torch.as_tensor(sums, device=device), sharding).cpu().numpy()
    s_uv, s_vu = float(sums[0]), float(sums[1])  # <u, Av>, <v, Au>
    scale = (
        np.sqrt(sums[2]) * np.sqrt(sums[3])
        + np.sqrt(sums[4]) * np.sqrt(sums[5])
    )
    if abs(s_uv - s_vu) > rel_tol * max(scale, 1e-300):
        raise ValueError(
            f"{solver} requires a symmetric (hermitian) operator: probe found "
            f"<u,Av>={s_uv:.6g} vs <Au,v>={s_vu:.6g} "
            f"(relative asymmetry {abs(s_uv - s_vu) / max(scale, 1e-300):.2e}). "
            f"The fused families are symmetric-only by design; for "
            f"non-hermitian problems use "
            f"solvers.fused_nonsym.FusedNonSymDavidson (the fused "
            f"non-hermitian path) or {parity_hint}, or pass "
            f"check_symmetric=False if the asymmetry is known rounding noise."
        )
