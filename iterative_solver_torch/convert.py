"""Carry state across from the JAX package.

The port never imports the JAX package; callers hand its objects over as
numpy arrays (``np.asarray`` of each field), and these functions return the
port's objects. Packed storage is byte-identical in both packages, so a
packed or block-sparse operator built once on the host feeds both.

bf16 arrays come out of JAX as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; they are carried bit for bit through a
``uint16`` -> ``int16`` view and ``.view(torch.bfloat16)``.

Like every entry point of the port, each function puts its tensors on the
CUDA device unless ``device`` says otherwise, and raises where CUDA is
absent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import config
from .ops.kernels.spmv import BSRMatrix, BSRMatrixInt8
from .ops.kernels.symm import SymmetricBlocked, SymmetricBlockedSplit
from .ops.kernels.symm_int8 import SymmetricBlockedInt8, SymmetricBlockedInt8Split
from .solvers.fused_cg import CGState
from .solvers.fused_davidson import DavidsonState
from .solvers.fused_linear import LinearState
from .solvers.fused_ppcg import PPCGState


def tensor_from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """A tensor of ``a`` on ``device`` (``None``: the CUDA device, which
    raises without it); bf16 arrays (``ml_dtypes.bfloat16``, itemsize 2,
    dtype name "bfloat16") keep their bits."""
    device = config.resolve_device(device)
    a = np.array(a, copy=True, order="C")  # never alias a JAX buffer
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def symmetric_blocked(values, ii, jj, shape: Tuple[int, int], b: int,
                      diagonal=None, device=None) -> SymmetricBlocked:
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
                            diagonal=None, device=None) -> SymmetricBlockedSplit:
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


def symmetric_blocked_int8(q, gq, ii, jj, shape: Tuple[int, int], b: int,
                           diagonal=None, device=None) -> SymmetricBlockedInt8:
    """The port's SymmetricBlockedInt8 from the JAX one's fields."""
    return SymmetricBlockedInt8(
        q=tensor_from_numpy(q, device, torch.int8),
        gq=tensor_from_numpy(gq, device, torch.float32),
        ii=tensor_from_numpy(ii, device, torch.int32),
        jj=tensor_from_numpy(jj, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        b=int(b),
        diagonal=None if diagonal is None else tensor_from_numpy(diagonal, device),
    )


def symmetric_blocked_int8_split(q1, q2, gq, ii, jj, shape: Tuple[int, int], b: int,
                                 diagonal=None, device=None) -> SymmetricBlockedInt8Split:
    """The port's SymmetricBlockedInt8Split from the JAX one's fields."""
    return SymmetricBlockedInt8Split(
        q1=tensor_from_numpy(q1, device, torch.int8),
        q2=tensor_from_numpy(q2, device, torch.int8),
        gq=tensor_from_numpy(gq, device, torch.float32),
        ii=tensor_from_numpy(ii, device, torch.int32),
        jj=tensor_from_numpy(jj, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        b=int(b),
        diagonal=None if diagonal is None else tensor_from_numpy(diagonal, device),
    )


def bsr(values, col_idx, row_idx, row_ptr, shape: Tuple[int, int], bm: int, bn: int,
        diagonal=None, device=None) -> BSRMatrix:
    """The port's BSRMatrix from the JAX one's fields."""
    return BSRMatrix(
        values=tensor_from_numpy(values, device),
        col_idx=tensor_from_numpy(col_idx, device, torch.int32),
        row_idx=tensor_from_numpy(row_idx, device, torch.int32),
        row_ptr=tensor_from_numpy(row_ptr, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        bm=int(bm),
        bn=int(bn),
        diagonal=None if diagonal is None else tensor_from_numpy(diagonal, device),
    )


def bsr_int8(q, rq, cq, col_idx, row_idx, row_ptr, shape: Tuple[int, int], bm: int,
             bn: int, diagonal=None, device=None) -> BSRMatrixInt8:
    """The port's BSRMatrixInt8 from the JAX one's fields."""
    return BSRMatrixInt8(
        q=tensor_from_numpy(q, device, torch.int8),
        rq=tensor_from_numpy(rq, device, torch.float32),
        cq=tensor_from_numpy(cq, device, torch.float32),
        col_idx=tensor_from_numpy(col_idx, device, torch.int32),
        row_idx=tensor_from_numpy(row_idx, device, torch.int32),
        row_ptr=tensor_from_numpy(row_ptr, device, torch.int32),
        shape=tuple(int(s) for s in shape),
        bm=int(bm),
        bn=int(bn),
        diagonal=(None if diagonal is None
                  else tensor_from_numpy(diagonal, device, torch.float32)),
    )


def ppcg_state(x, ax, p, ap, evals, errors, it, device=None) -> PPCGState:
    """The port's PPCGState from the JAX one's fields (``it`` becomes a
    host int)."""
    def t(a):
        return tensor_from_numpy(a, device)

    return PPCGState(t(x), t(ax), t(p), t(ap), t(evals), t(errors), int(np.asarray(it)))


def davidson_state(v, w, mask, k, evals, x, r, errors, c: Optional[np.ndarray] = None,
                   cm: Optional[np.ndarray] = None, device=None) -> DavidsonState:
    """The port's DavidsonState from the JAX one's fields (``k`` becomes a
    host int)."""
    def t(a):
        return None if a is None else tensor_from_numpy(a, device)

    return DavidsonState(t(v), t(w), t(mask), int(np.asarray(k)), t(evals), t(x),
                         t(r), t(errors), t(c), t(cm))


def linear_state(v, w, mask, k, x, r, errors, device=None) -> LinearState:
    """The port's LinearState from the JAX one's fields (``k`` becomes a
    host int)."""
    def t(a):
        return tensor_from_numpy(a, device)

    return LinearState(t(v), t(w), t(mask), int(np.asarray(k)), t(x), t(r), t(errors))


def cg_state(x, r, p, rz, errors, device=None) -> CGState:
    """The port's CGState from the JAX one's fields."""
    def t(a):
        return tensor_from_numpy(a, device)

    return CGState(t(x), t(r), t(p), t(rz), t(errors))
