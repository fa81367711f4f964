"""Simple eigensystem example (reference: examples/LinearEigensystemExample.cpp).

Finds the lowest eigenpair of the ExampleProblem matrix (diagonal i + 1,
off-diagonal 0.001 ((i + j) % n)) with the Molpro-style parity entry point,
in float64 on the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/linear_eigensystem.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import iterative_solver_torch as its  # noqa: E402
from examples_torch import _cli  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    n = 100
    problem = its.models.ExampleProblem(n, dtype=torch.float64, device=device)
    solver = its.create_linear_eigensystem(n, 1, "Davidson", dtype=torch.float64,
                                           device=device)
    solver.set_hermiticity(True)
    converged, x, r = solver.solve(np.zeros((1, n)), problem=problem,
                                   generate_initial_guess=True)
    value = float(solver.eigenvalues()[0])
    dense = float(np.linalg.eigvalsh(_cli.host(problem.matrix))[0])
    print("converged:", converged)
    print("lowest eigenvalue:", value)
    print("matvecs:", problem.n_actions, "iterations:", solver.stats.iterations)
    assert converged and abs(value - dense) < 1e-9, (value, dense)
    return _cli.report({"example": "linear_eigensystem", "device": device.type, "n": n,
                        "converged": converged, "eigenvalue": value, "reference": dense,
                        "matvecs": problem.n_actions, "iterations": solver.stats.iterations})


if __name__ == "__main__":
    main()
