"""BFGS optimisation (reference: examples/OptimizeExample.cpp and
python/OptimizeExample.ipynb), in float64 on the card or, with
``--device cpu``, on the host.

Run: python3 examples_torch/optimize.py [--device cpu]
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
    n = 20
    hessian = np.diag(np.arange(1.0, n + 1.0))
    hessian[0, n - 1] = hessian[n - 1, 0] = 0.5
    problem = its.models.QuadraticOptimizeProblem(hessian, b=np.ones(n), dtype=torch.float64,
                                                  device=device)
    solver = its.create_optimize(n, "BFGS", "max_size_qspace=6", dtype=torch.float64,
                                 device=device)
    converged, x, _ = solver.solve(np.zeros((1, n)), problem=problem)
    error = float(np.abs(_cli.host(x)[0] - 1.0).max())
    print("converged:", converged, " value:", solver.value)
    print("solution error:", error)
    print(solver.stats)
    assert converged and error < 1e-8, error
    return _cli.report({"example": "optimize", "device": device.type, "n": n,
                        "converged": converged, "value": solver.value,
                        "solution_error": error, "iterations": solver.stats.iterations,
                        "stats": str(solver.stats)})


if __name__ == "__main__":
    main()
