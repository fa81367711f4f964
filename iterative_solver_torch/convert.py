"""Carry state across from the JAX package.

The port never imports the JAX package; callers hand its objects over as
numpy arrays (``np.asarray`` of each field), and these functions return the
port's objects. Packed storage is byte-identical in both packages, so a
packed operator built once on the host feeds both.

bf16 arrays come out of JAX as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; they are carried bit for bit through a
``uint16`` -> ``int16`` view and ``.view(torch.bfloat16)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops.kernels.symm import SymmetricBlocked, SymmetricBlockedSplit
from .solvers.fused_davidson import DavidsonState


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor of ``a``; bf16 arrays (``ml_dtypes.bfloat16``, itemsize 2,
    dtype name "bfloat16") keep their bits."""
    a = np.array(a, copy=True, order="C")  # never alias a JAX buffer
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def symmetric_blocked(values, ii, jj, shape: Tuple[int, int], b: int,
                      diagonal=None, device="cpu") -> SymmetricBlocked:
    """The port's SymmetricBlocked from the JAX one's fields."""
    return SymmetricBlocked(
        values=tensor_from_numpy(values, device),
        ii=tensor_from_numpy(ii, device, torch.int32),
        jj=tensor_from_numpy(jj, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        b=int(b),
        diagonal=None if diagonal is None else tensor_from_numpy(diagonal, device),
    )


def symmetric_blocked_split(hi, lo, ii, jj, shape: Tuple[int, int], b: int,
                            diagonal=None, device="cpu") -> SymmetricBlockedSplit:
    """The port's SymmetricBlockedSplit from the JAX one's fields."""
    return SymmetricBlockedSplit(
        hi=tensor_from_numpy(hi, device),
        lo=tensor_from_numpy(lo, device),
        ii=tensor_from_numpy(ii, device, torch.int32),
        jj=tensor_from_numpy(jj, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        b=int(b),
        diagonal=None if diagonal is None else tensor_from_numpy(diagonal, device),
    )


def davidson_state(v, w, mask, k, evals, x, r, errors, c: Optional[np.ndarray] = None,
                   cm: Optional[np.ndarray] = None, device="cpu") -> DavidsonState:
    """The port's DavidsonState from the JAX one's fields (``k`` becomes a
    host int)."""
    def t(a):
        return None if a is None else tensor_from_numpy(a, device)

    return DavidsonState(t(v), t(w), t(mask), int(np.asarray(k)), t(evals), t(x),
                         t(r), t(errors), t(c), t(cm))
