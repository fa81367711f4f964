"""The ``FusedDavidson`` family: built once over an operator, then one
``run_on_device`` a solve from the guess a user passes."""

from __future__ import annotations

import numpy as np

# the traffic keys this family reads, besides ``family``; a traffic file
# with any other key is refused (harness.load_cell)
KEYS = ("nroots", "m_max", "rr", "tol", "max_iter", "guess")


def build(op, traffic: dict, device):
    """The solver over ``op`` (``operators/<kind>.build``) with the
    traffic's roots, basis size, Rayleigh-Ritz mode, tolerance and
    iteration cap, in the port's working precision on ``device``."""
    from iterative_solver_torch import FusedDavidson

    return FusedDavidson(op.matvec, op.diag, op.n, traffic["nroots"], m_max=traffic["m_max"],
                         rr=traffic["rr"], convergence_threshold=traffic["tol"],
                         max_iter=traffic["max_iter"], operand=op.operand, device=device)


def guess(diag: np.ndarray, traffic: dict) -> np.ndarray:
    """The traffic's guess rule; "onehot_lowest_diagonal": a numpy array of
    numpy's default float64, one unit entry a row on each of the
    ``nroots`` lowest diagonal entries."""
    if traffic["guess"] != "onehot_lowest_diagonal":
        raise ValueError(f"unknown guess rule {traffic['guess']!r}")
    nroots = traffic["nroots"]
    v0 = np.zeros((nroots, diag.shape[0]))
    v0[np.arange(nroots), np.argsort(diag, kind="stable")[:nroots]] = 1.0
    return v0


def solve(solver, v0):
    """(eigenvalues (numpy), eigenvectors (rows, on the device), residual
    norms (numpy), iterations) of one solve."""
    return solver.run_on_device(v0)
