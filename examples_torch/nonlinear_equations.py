"""DIIS nonlinear equations (reference: examples/NonLinearEquationsExample.cpp),
in float64 on the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/nonlinear_equations.py [--device cpu]
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
    n = 30
    problem = its.models.TrigNonlinearProblem(n, dtype=torch.float64, device=device)
    solver = its.create_nonlinear_equations(n, "DIIS", "max_size_qspace=8",
                                            dtype=torch.float64, device=device)
    converged, x, _ = solver.solve(np.zeros((1, n)), problem=problem)
    value, res = problem.residual(x[0])
    norm = float(np.linalg.norm(_cli.host(res)))
    print("converged:", converged, " |residual|:", norm)
    assert converged and norm < 1e-8, norm
    return _cli.report({"example": "nonlinear_equations", "device": device.type, "n": n,
                        "converged": converged, "iterations": solver.stats.iterations,
                        "residual_norm": norm, "x": x[0]})


if __name__ == "__main__":
    main()
