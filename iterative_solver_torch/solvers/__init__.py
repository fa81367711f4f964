"""Solvers of the port."""

from .fused_nonsym import (
    FusedNonSymDavidson,
    FusedNonSymLinearEquations,
    finalize_nonsym_batch,
    make_batched_nonsym_lineq_solve,
    make_batched_nonsym_solve,
)

__all__ = [
    "FusedNonSymDavidson",
    "FusedNonSymLinearEquations",
    "finalize_nonsym_batch",
    "make_batched_nonsym_solve",
    "make_batched_nonsym_lineq_solve",
]
