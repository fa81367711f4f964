"""Packed-triangle symmetric action: the flagship dense-operator path.

A symmetric operator's tile (i, j) carries both y_i += x_j A_ijᵀ and
y_j += x_i A_ij, so streaming only the lower triangle halves the memory
traffic of the matvec. Two of the storage tiers:

- f32 tiles: exact-f32 semantics (the kernel K1 with f32 tiles);
- split double-bf16 (hi + lo) tiles: a ~2^-16 operator at f32 bytes, every
  product a bf16 tensor-core product (the kernel K3).

On the card the wrappers launch the hand-written CUDA kernels
(iterative_solver_torch/ops/kernels/csrc/symm_packed.cu) and the fused
expand chain (chain.cu); with ``--device cpu`` they run their plain PyTorch
versions.

Run: python3 examples_torch/packed_symmetric_davidson.py [--n 8192 --b 512]
     [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedDavidson  # noqa: E402
from iterative_solver_torch.ops.kernels.symm import (  # noqa: E402
    SymmetricBlocked,
    SymmetricBlockedSplit,
    packed_matvec,
)

NROOTS = 4
TOL = 2e-4
EIGENVALUE_LIMIT = 1e-4   # both tiers, against the dense f64 eigenvalues
RESIDUAL_LIMIT = 1e-3     # the split tier's f64 residual


def operator(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(np.concatenate([
        np.linspace(-2.0, 1.0, 16), np.linspace(3.0, 40.0, n - 16)]))


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--b", type=int, default=64, help="tile edge; divides --n")
    args = ap.parse_args(argv)
    if args.n % args.b:
        ap.error("--b must divide --n")
    device = _cli.device(args.device)
    n, b = args.n, args.b
    matrix = operator(n)
    diag = np.diag(matrix)
    v0 = _cli.guess(diag, NROOTS)
    ref = _cli.lowest_eigenvalues(matrix, NROOTS, device)

    # ---- f32 packed tier (K1), 2r x 2r window Rayleigh-Ritz ----
    sym = SymmetricBlocked.from_dense(matrix, b=b, dtype=torch.float32, device=device)
    matvec, operand = packed_matvec(sym)
    solver = FusedDavidson(matvec, diag, n, NROOTS, m_max=4 * NROOTS, dtype=torch.float32,
                           convergence_threshold=TOL, max_iter=100, operand=operand,
                           rr="window", device=device)
    evals, x, errors, iters = solver.run_on_device(v0)
    err = float(np.abs(np.sort(evals) - ref).max())
    print(f"f32 packed + window RR: {iters} iterations, residuals {errors}")
    print("  eigenvalue error:", err)

    # ---- split double-bf16 tier (K3): f32 bytes, bf16 products ----
    syms = SymmetricBlockedSplit.from_dense(matrix, b=b, device=device)
    matvec2, operand2 = packed_matvec(syms)
    solver2 = FusedDavidson(matvec2, diag, n, NROOTS, m_max=4 * NROOTS, dtype=torch.float32,
                            convergence_threshold=TOL, max_iter=100, operand=operand2,
                            device=device)
    evals2, x2, errors2, iters2 = solver2.run_on_device(v0)
    res = float(_cli.f64_residuals(matrix, x2[:NROOTS]).max())
    err2 = float(np.abs(np.sort(evals2) - ref).max())
    print(f"split double-bf16: {iters2} iterations, true f64 residual {res:.2e}")
    print("  eigenvalue error:", err2)

    assert np.max(errors) <= TOL and np.max(errors2) <= TOL, (errors, errors2)
    assert err <= EIGENVALUE_LIMIT and err2 <= EIGENVALUE_LIMIT, (err, err2)
    assert res <= RESIDUAL_LIMIT, res
    return _cli.report({
        "example": "packed_symmetric_davidson", "device": device.type, "n": n, "b": b,
        "nroots": NROOTS, "m_max": solver.m_max,
        "f32": {"iterations": iters, "eigenvalues": np.sort(evals), "errors": errors,
                "eigenvalue_error": err},
        "split": {"iterations": iters2, "eigenvalues": np.sort(evals2), "errors": errors2,
                  "eigenvalue_error": err2, "f64_residual": res},
        "reference": ref,
    })


if __name__ == "__main__":
    main()
