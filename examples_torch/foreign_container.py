"""Foreign-container integration: drive the solver with numpy/scipy-resident
data.

Mirrors the reference's examples/foreign-container/: there a user plugs
their own vector container into the C++ templates by supplying array
handlers, and the solver runs its whole Krylov machinery on the foreign
type. Here the integration seam is the ``Problem`` protocol: the solver
owns only the small (m, N) working blocks (torch tensors, on the card or,
with ``--device cpu``, on the host), and every heavy user-side operation
(the operator action, the diagonals, the preconditioner) runs in a foreign
numerics stack. Torch is this package's own, so the foreign stack is
numpy and scipy: the operator and all Problem math live in numpy arrays,
and tensors cross the call boundary only (to the host and back).

By default the operators are two synthetic FCI-like matrices
(iterative_solver_torch/models/synthetic_fci.py); ``--hamiltonian PATH``
(repeatable) reads the reference's ``*.hamiltonian`` files instead.

Run: python3 examples_torch/foreign_container.py [--hamiltonian PATH]...
     [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

import iterative_solver_torch as its  # noqa: E402
from examples_torch import _cli  # noqa: E402
from iterative_solver_torch.models.synthetic_fci import synthetic_fci_dense  # noqa: E402

SYNTHETIC = (("synthetic-512", 512, 0), ("synthetic-768", 768, 1))


class NumpyMatrixProblem(its.Problem):
    """A Problem whose state and math live entirely in numpy/scipy."""

    def __init__(self, matrix: np.ndarray, device):
        super().__init__()
        self.matrix = np.asarray(matrix, dtype=np.float64)
        self.dimension = self.matrix.shape[0]
        self.device = device

    def _back(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def action(self, parameters):
        x = parameters.detach().cpu().numpy()
        return self._back(scipy.linalg.blas.dgemm(1.0, x, self.matrix, trans_b=True))

    def diagonals(self):
        return self._back(np.diagonal(self.matrix).copy())

    def precondition(self, residual, shift=None, diagonals=None):
        r = residual.detach().cpu().numpy().copy()
        d = np.diagonal(self.matrix)
        if shift is None:
            shift = np.zeros(r.shape[0])
        for k, s in enumerate(np.asarray(shift, dtype=np.float64)):
            r[k] /= d - s + 1e-15
        return self._back(r)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--hamiltonian", action="append", default=None, metavar="PATH",
                    help="a *.hamiltonian file (the reference's examples/); repeatable")
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    if args.hamiltonian:
        operators = [(os.path.basename(p), its.models.load_hamiltonian(p))
                     for p in args.hamiltonian]
    else:
        operators = [(name, synthetic_fci_dense(n, seed=seed)) for name, n, seed in SYNTHETIC]
    runs = []
    for name, matrix in operators:
        n = matrix.shape[0]
        dense = np.linalg.eigvalsh(matrix)
        for nroot in (1, 2):
            problem = NumpyMatrixProblem(matrix, device)
            solver = its.create_linear_eigensystem(
                n, nroot, "Davidson", "max_size_qspace=10,convergence_threshold=1e-9",
                dtype=torch.float64, device=device)
            solver.set_hermiticity(True)
            conv, x, r = solver.solve(np.zeros((nroot, n)), problem=problem,
                                      generate_initial_guess=True)
            evals = np.asarray(solver.eigenvalues())
            err = float(np.max(np.abs(evals - dense[:nroot])))
            print(f"{name} nroot={nroot}: converged={conv} eigenvalues={evals} "
                  f"err_vs_dense={err:.2e}")
            assert conv, f"{name}/{nroot} did not converge"
            assert err < 2e-9, f"{name}/{nroot} eigenvalue error {err}"
            runs.append({"operator": name, "n": n, "nroots": nroot, "converged": conv,
                         "iterations": solver.stats.iterations, "eigenvalues": evals,
                         "reference": dense[:nroot], "eigenvalue_error": err})
    print("foreign-container (numpy/scipy) example OK")
    return _cli.report({"example": "foreign_container", "device": device.type,
                        "runs": runs})


if __name__ == "__main__":
    main()
