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
) -> None:
    """Raise ValueError if matvec is measurably non-symmetric. ``device=None``
    is the CUDA device (raises without it)."""
    device = _config.resolve_device(device)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(block_shape)
    v = rng.standard_normal(block_shape)
    tu = torch.as_tensor(u, dtype=dtype, device=device)
    tv = torch.as_tensor(v, dtype=dtype, device=device)

    def host(a):
        return a.detach().to("cpu", torch.float64).numpy()

    wu = host(matvec(tu, operand))
    wv = host(matvec(tv, operand))
    uu = host(tu)
    vv = host(tv)
    s_uv = float(np.sum(uu * wv))  # <u, Av>
    s_vu = float(np.sum(vv * wu))  # <v, Au>
    scale = (
        np.linalg.norm(uu) * np.linalg.norm(wv)
        + np.linalg.norm(vv) * np.linalg.norm(wu)
    )
    if abs(s_uv - s_vu) > rel_tol * max(scale, 1e-300):
        raise ValueError(
            f"{solver} requires a symmetric (hermitian) operator: probe found "
            f"<u,Av>={s_uv:.6g} vs <Au,v>={s_vu:.6g} "
            f"(relative asymmetry {abs(s_uv - s_vu) / max(scale, 1e-300):.2e}). "
            f"The fused families are symmetric-only by design; for "
            f"non-hermitian problems use {parity_hint} in the JAX package "
            f"(not yet ported), or pass check_symmetric=False if the "
            f"asymmetry is known rounding noise."
        )
