"""The ``FusedPPCG`` family: built once over an operator, then one
``run_on_device`` a solve from the guess a user passes."""

from __future__ import annotations

import numpy as np

from portbench.families import davidson

# the traffic keys this family reads, besides ``family``; a traffic file
# with any other key is refused (harness.load_cell)
KEYS = ("nroots", "rr_every", "tol", "max_iter", "guess")


def build(op, traffic: dict, device):
    """The solver over ``op`` (``operators/<kind>.build``) with the
    traffic's roots, full Rayleigh-Ritz cadence, tolerance and iteration
    cap, in the port's working precision on ``device``."""
    from iterative_solver_torch import FusedPPCG

    return FusedPPCG(op.matvec, op.diag, op.n, traffic["nroots"], rr_every=traffic["rr_every"],
                     convergence_threshold=traffic["tol"], max_iter=traffic["max_iter"],
                     operand=op.operand, device=device)


def guess(diag: np.ndarray, traffic: dict) -> np.ndarray:
    """The traffic's guess rule, as the ``davidson`` family reads it
    ("onehot_lowest_diagonal": a float64 numpy array, one unit entry a row
    on each of the ``nroots`` lowest diagonal entries)."""
    return davidson.guess(diag, traffic)


def solve(solver, v0):
    """(eigenvalues (numpy), eigenvectors (rows, on the device), residual
    norms (numpy), iterations) of one solve."""
    return solver.run_on_device(v0)
