"""A dense CI Hamiltonian held as the port's one-plane packed int8 operator,
with the structure of the port's ``models/synthetic_fci.synthetic_packed_int8``,
generated on the card from the seed.

A = diag(d) + E, E[bi*b+u, bj*b+v] = gq^2 q_(bi,bj)[u, v]: every lower tile
pair (bi >= bj) present, q = rint(N(0, 1) * 127/4.5) clipped to +-127, the
tiles on the block diagonal symmetrised with a zero diagonal, and one
constant gq with sd(E) = coupling / sqrt(n). d = linspace(-2, 3, n_low)
then linspace(6, 50, n - n_low), the same for every seed.

The port's operand is ``SymmetricBlockedInt8`` over these very tiles, and
``int8_matvec`` (K4 on the card) over it.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# tiles drawn in float32 at a time
GEN_CHUNK = 128
SD_Q = 127.0 / 4.5


def diagonal(cfg: dict, device) -> torch.Tensor:
    """d: ``n_low`` entries over ``diag_low``, then the rest over
    ``diag_high``, in float64."""
    n, n_low = cfg["n"], cfg["n_low"]
    lo, hi = cfg["diag_low"], cfg["diag_high"]
    return torch.cat([torch.linspace(lo[0], lo[1], n_low, dtype=torch.float64),
                      torch.linspace(hi[0], hi[1], n - n_low, dtype=torch.float64)]).to(device)


def generate(cfg: dict, seed: int, device) -> dict:
    """The operator's parts on ``device``, its values drawn from the seed:
    the int8 tiles ``q`` (P, b, b) in ``torch.tril_indices`` order, their
    block rows ``ii`` and columns ``jj`` (int32), the scale ``gq`` (one
    float), the float64 diagonal ``diag`` and the ``sizes``."""
    n, b = cfg["n"], cfg["tile"]
    if n % b:
        raise ValueError(f"n = {n} is not a multiple of the tile {b}")
    nb = n // b
    ii, jj = torch.tril_indices(nb, nb, device=device)
    on_diag = ii == jj
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.empty((ii.numel(), b, b), dtype=torch.int8, device=device)
    for start in range(0, q.shape[0], GEN_CHUNK):
        sl = slice(start, min(start + GEN_CHUNK, q.shape[0]))
        blk = torch.randn((sl.stop - start, b, b), generator=gen, device=device)
        blk = blk.mul_(SD_Q).round_().clamp_(-127, 127).to(torch.int8)
        on = on_diag[sl]
        low = blk[on].tril(-1)
        blk[on] = low + low.transpose(1, 2)
        q[sl] = blk
    gq = float(np.sqrt(cfg["coupling"] / (np.sqrt(float(n)) * SD_Q)))
    return {"q": q, "ii": ii.to(torch.int32), "jj": jj.to(torch.int32), "gq": gq,
            "diag": diagonal(cfg, device),
            "sizes": {"n": n, "tile": b, "pairs": int(ii.numel()), "diag_pairs": nb}}


def build(gen: dict, cfg: dict, device) -> SimpleNamespace:
    """The port's operand: ``SymmetricBlockedInt8`` over the generated
    tiles, and ``int8_matvec`` over it. Returns (matvec, operand, diag as
    float64 numpy, n)."""
    from iterative_solver_torch.ops.kernels.symm_int8 import SymmetricBlockedInt8, int8_matvec

    n, b = gen["sizes"]["n"], gen["sizes"]["tile"]
    sym = SymmetricBlockedInt8(
        q=gen["q"], gq=torch.full((n,), gen["gq"], dtype=torch.float32, device=device),
        ii=gen["ii"], jj=gen["jj"], shape=(n, n), b=b,
        diagonal=gen["diag"].to(torch.float32))
    matvec, operand = int8_matvec(sym)
    return SimpleNamespace(matvec=matvec, operand=operand, n=n,
                           diag=gen["diag"].cpu().numpy())


def action_cost(sizes: dict, rows: int) -> tuple:
    """(bytes, operations, peak) of one action on ``rows`` rows as the
    configuration stores the operator: the int8 tiles, their two int32
    index lists, gq and the float32 diagonal, x read and y written in
    float32; two operations a multiply-add, each tile off the diagonal
    acting on both sides."""
    n, b, p, pd = sizes["n"], sizes["tile"], sizes["pairs"], sizes["diag_pairs"]
    nbytes = p * b * b + 2 * p * 4 + 2 * n * 4 + 2 * rows * n * 4
    return nbytes, 2.0 * rows * b * b * (2 * (p - pd) + pd), "int8"
