"""The plain action of the dense packed int8 operator, y = x A, from the
generator's own tiles (``operators/packed_int8.generate``):

    xs = gq x,  y_i += xs_j q_p^T,  y_j += xs_i q_p (pairs off the diagonal),
    y = gq y + x d

for every lower tile pair p = (i, j). Tiles are widened ``CHUNK`` at a
time.

``precision``: "float64", the reference; or "int4", the control: the tiles
and the rows of xs rounded to 4-bit integers (+-7, one scale a row of xs
and 127/7 for the tiles) and computed in float32, the nearest precision
below the int8 of the tiles and of the port's quantized rows of x.
"""

from __future__ import annotations

import torch

CHUNK = 64
INT4 = 7


def action(gen: dict, x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    int4 = {"float64": False, "int4": True}[precision]
    dtype = torch.float32 if int4 else torch.float64
    b = gen["sizes"]["tile"]
    m, n = x.shape
    xs = x.to(dtype) * gen["gq"]
    if int4:
        sx = xs.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / INT4
        xs = torch.clamp(torch.round(xs / sx), -INT4, INT4) * sx
    xt = xs.reshape(m, n // b, b).transpose(0, 1)                    # (nb, m, b)
    y = torch.zeros_like(xt)
    ii, jj = gen["ii"].long(), gen["jj"].long()
    for start in range(0, ii.numel(), CHUNK):
        sl = slice(start, start + CHUNK)
        q = gen["q"][sl].to(dtype)
        if int4:
            q = torch.clamp(torch.round(q * (INT4 / 127.0)), -INT4, INT4) * (127.0 / INT4)
        i, j = ii[sl], jj[sl]
        y.index_add_(0, i, torch.einsum("kmv,kuv->kmu", xt[j], q))
        back = torch.einsum("kmu,kuv->kmv", xt[i], q)
        back[i == j] = 0.0
        y.index_add_(0, j, back)
    return y.transpose(0, 1).reshape(m, n) * gen["gq"] + x.to(dtype) * gen["diag"].to(dtype)
