"""Multi-root Davidson with a P-space model (reference:
examples/LinearEigensystemMultirootExample.cpp and the P-space Fortran
examples).

By default the operator is a synthetic FCI-like matrix
(iterative_solver_torch/models/synthetic_fci.py); ``--hamiltonian PATH``
reads one of the reference's ``*.hamiltonian`` files instead. Float64, on
the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/linear_eigensystem_multiroot.py
     [--hamiltonian PATH] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import iterative_solver_torch as its  # noqa: E402
from examples_torch import _cli  # noqa: E402
from iterative_solver_torch.models import load_hamiltonian  # noqa: E402
from iterative_solver_torch.models.synthetic_fci import synthetic_fci_dense  # noqa: E402

SYNTHETIC_N = 1000


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--hamiltonian", default=None, metavar="PATH",
                    help="a *.hamiltonian file (the reference's examples/)")
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    matrix = (load_hamiltonian(args.hamiltonian) if args.hamiltonian
              else synthetic_fci_dense(SYNTHETIC_N, seed=0))
    n = matrix.shape[0]
    nroot = 4
    problem = its.models.MatrixProblem(matrix, dtype=torch.float64, device=device)
    solver = its.create_linear_eigensystem(n, nroot, "Davidson", "max_size_qspace=12,max_p=6",
                                           dtype=torch.float64, device=device)
    solver.set_hermiticity(True)
    converged, *_ = solver.solve(np.zeros((nroot, n)), problem=problem,
                                 generate_initial_guess=True)
    evals = np.asarray(solver.eigenvalues()[:nroot])
    dense = np.linalg.eigvalsh(matrix)[:nroot]
    err = float(np.max(np.abs(evals - dense)))
    print("converged:", converged)
    print("eigenvalues:", evals)
    print("P-space size:", solver.xspace.dimensions.nP)
    print(solver.stats)
    print(f"eigenvalue error vs dense f64: {err:.2e}")
    assert converged and err < 1e-9, err
    return _cli.report({"example": "linear_eigensystem_multiroot", "device": device.type,
                        "n": n, "converged": converged, "eigenvalues": evals,
                        "reference": dense, "eigenvalue_error": err,
                        "p_space": solver.xspace.dimensions.nP,
                        "iterations": solver.stats.iterations, "stats": str(solver.stats)})


if __name__ == "__main__":
    main()
