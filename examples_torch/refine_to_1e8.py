"""Reach the 1e-8 residual bar from a float32 card solve: the fused
Davidson on the split double-bf16 packed action to its f32 floor, then
mixed-precision refinement (EigenpairRefiner).

The reference converges its acceptance tests to convergence_threshold =
1.0e-8 in f64 LAPACK arithmetic. The f32 carrier floors f64 residuals near
3e-6; the refinement's outer loop (host-f64 Rayleigh-Ritz plus deflated,
projected correction solves on the card's operator tier) closes the
remaining digits.

The card's action is the split double-bf16 packed operator (tiles of 512):
the CUDA kernel K3, in the solve and in the refiner's block CG, with the
solve's expand chain in K2. With ``--device cpu`` the action is a dense
float32 matmul, as the JAX example's off the TPU; ``--action split`` runs
the card's operator there too, through the wrappers' plain versions.

Run: python3 examples_torch/refine_to_1e8.py [--n 8192] [--nroots 8]
     [--device cpu] [--action split|dense]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedDavidson  # noqa: E402
from iterative_solver_torch.ops.kernels.symm import SymmetricBlockedSplit, packed_matvec  # noqa: E402
from iterative_solver_torch.solvers.refine import EigenpairRefiner  # noqa: E402

B = 512                  # the split tier's tile on the main path
EIGENVALUE_LIMIT = 1e-9  # after refinement, against the dense f64 eigenvalues


def operator(n: int, r: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    d = np.concatenate([np.linspace(-2.0, 3.0, max(32, 2 * r)),
                        np.linspace(6.0, 50.0, n - max(32, 2 * r))])
    return a + a.T + np.diag(d)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nroots", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--action", choices=("split", "dense"), default=None,
                    help="the solve's operator (default: split on the card, dense on the CPU)")
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    action = args.action or ("split" if device.type == "cuda" else "dense")
    if action == "split" and args.n % B:
        ap.error(f"--n must be a multiple of {B} for the split action")
    n, r = args.n, args.nroots
    matrix = operator(n, r)
    diag = np.diag(matrix).copy()

    if action == "split":
        matvec, operand = packed_matvec(SymmetricBlockedSplit.from_dense(matrix, b=B,
                                                                         device=device))
    else:
        operand = torch.as_tensor(matrix, dtype=torch.float32, device=device)

        def matvec(x, op):
            return torch.matmul(x.to(torch.float32), op.T)
    solver = FusedDavidson(matvec, diag, n, r, m_max=4 * r, dtype=torch.float32,
                           operand=operand, convergence_threshold=1e-5, max_iter=100,
                           device=device)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(_cli.guess(diag, r))
    wall_solve = time.perf_counter() - t0

    refiner = EigenpairRefiner(lambda xx: xx @ matrix.T, matvec, operand, diag, n, r,
                               dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    out = refiner.refine(_cli.host(x), tol=args.tol)
    wall_ref = time.perf_counter() - t0

    print(f"device {device.type}  action {action}  n {n}  nroots {r}")
    print(f"fused solve: {iters} iters, {wall_solve:.3f} s, "
          f"f64 floor {out.history[0]:.3e}")
    print(f"refinement: {out.passes} passes, {wall_ref:.3f} s, "
          f"history {['%.2e' % h for h in out.history]}")
    print(f"REFINED max_residual_f64 {out.residual_norms.max():.3e} "
          f"converged {out.converged}")
    ref = _cli.lowest_eigenvalues(matrix, r, device)
    err = float(np.max(np.abs(np.sort(out.eigenvalues) - ref)))
    print(f"eigenvalue error vs dense f64: {err:.3e}")

    assert out.converged and out.residual_norms.max() <= args.tol, out.history
    assert err <= EIGENVALUE_LIMIT, err
    return _cli.report({
        "example": "refine_to_1e8", "device": device.type, "action": action, "n": n, "nroots": r,
        "m_max": solver.m_max, "iterations": iters, "errors": errors,
        "solve_seconds": wall_solve, "passes": out.passes, "history": out.history,
        "cg_iterations": refiner.cg_iterations, "converged": out.converged,
        "max_residual_f64": out.residual_norms.max(),
        "eigenvalues": np.sort(out.eigenvalues), "eigenvalue_error": err,
        "refine_seconds": wall_ref,
    })


if __name__ == "__main__":
    main()
