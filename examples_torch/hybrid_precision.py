"""Hybrid-precision pipeline: f32 card Davidson -> split-K precise matvec ->
pure-numpy f64 host refinement, reaching the 1e-8 residual band from a
float32 solve.

The double-float32 operator (``SplitOperator``: hi + lo sum to the f64
matrix, products in chunks of the contraction) runs as plain PyTorch
matmuls; on the card the solve's expand chain is the CUDA kernel K2.

Run: python3 examples_torch/hybrid_precision.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch.models.synthetic_fci import synthetic_fci_dense  # noqa: E402
from iterative_solver_torch.ops.precise import (  # noqa: E402
    SplitOperator,
    precise_matvec_fn,
    refine_on_host,
)
from iterative_solver_torch.solvers.fused_davidson import FusedDavidson  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    n, nroots = 1024, 3
    matrix = synthetic_fci_dense(n, seed=0)

    # phase 1: card solve with the double-f32 split-K operator
    op = SplitOperator.from_dense(matrix, n_chunks=32, device=device)
    solver = FusedDavidson(precise_matvec_fn(op), op.diagonal, n, nroots, m_max=20,
                           dtype=torch.float32, convergence_threshold=2e-5, max_iter=100,
                           operand=op.operand(), device=device)
    evals32, x32, errors32, iters32 = solver.run(_cli.guess(op.diagonal, nroots))
    print(f"accelerator phase: {iters32} iterations, f32 residuals {errors32}")

    # phase 2: warm-started f64 refinement on the host
    evals, vectors, info = refine_on_host(matrix, x32, nroots)
    ref = _cli.lowest_eigenvalues(matrix, nroots, device)
    err = float(np.abs(evals - ref).max())
    print(f"host refinement: {info.iterations} iterations, residuals {info.errors}")
    print("eigenvalue error vs dense:", err)
    assert np.max(errors32) <= 2e-5 and np.max(info.errors) <= 1e-8, (errors32, info.errors)
    assert err < 1e-9, err
    return _cli.report({
        "example": "hybrid_precision", "device": device.type, "n": n, "nroots": nroots,
        "iterations": iters32, "errors": errors32, "eigenvalues_f32": evals32,
        "refine_iterations": info.iterations, "refine_errors": info.errors,
        "eigenvalues": evals, "eigenvalue_error": err,
    })


if __name__ == "__main__":
    main()
