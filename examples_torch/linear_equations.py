"""Linear equations A x = b with several right-hand sides
(reference: examples/LinearEquationsExample.cpp), in float64 on the card
or, with ``--device cpu``, on the host.

Run: python3 examples_torch/linear_equations.py [--device cpu]
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
    f64 = dict(dtype=torch.float64, device=device)
    n, nrhs = 50, 2
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * 0.05
    matrix = a + a.T + np.diag(np.arange(2.0, n + 2.0))
    rhs = rng.standard_normal((nrhs, n))
    solver = its.create_linear_equations(n, nrhs, **f64)
    solver.add_equations(rhs)
    converged, *_ = solver.solve(np.zeros((nrhs, n)),
                                 problem=its.models.MatrixProblem(matrix, **f64),
                                 generate_initial_guess=True)
    x = _cli.host(solver.solution_params(list(range(nrhs))))
    residual = float(np.abs(matrix @ x.T - rhs.T).max())
    error = float(np.abs(x - np.linalg.solve(matrix, rhs.T).T).max())
    print("converged:", converged, " max |Ax-b|:", residual)
    assert converged and residual < 1e-7 and error < 1e-8, (residual, error)
    return _cli.report({"example": "linear_equations", "device": device.type, "n": n,
                        "converged": converged, "iterations": solver.stats.iterations,
                        "max_residual": residual, "max_error": error, "x_norms":
                        np.linalg.norm(x, axis=1)})


if __name__ == "__main__":
    main()
