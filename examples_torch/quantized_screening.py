"""Quantized screening + refinement: the int8 production pipeline.

Large eigenproblem runs often screen many states cheaply before polishing
the interesting ones. The int8 operator tiers
(iterative_solver_torch/ops/kernels/symm_int8.py) stream one quantized
plane at half the bf16 tier's bytes, and the exact diagonal keeps the
quantization error proportional to the couplings, so diagonally dominant
operators (FCI hamiltonians) screen accurately:

1. ``tier="int8"`` FusedDavidson to the quantization floor (~1e-3): ranks
   the states and pins the eigenvalues of a gapped spectrum to ~1e-5;
2. ``tier="int8_precise"`` (two planes, the split-bf16 accuracy class at
   half its bytes) re-converges the kept roots to ~1e-5 residuals;
3. ``EigenpairRefiner`` (host-f64 Rayleigh-Ritz plus deflated, projected
   corrections through the same card operator) closes the 1e-8 bar.

On the card the int8 tiers are the CUDA kernels K4 and K5
(csrc/symm_int8.cu) and the solves' expand chain is K2; with
``--device cpu`` they run their plain PyTorch versions.

Run: python3 examples_torch/quantized_screening.py [--n 8192] [--nroots 6]
     [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedDavidson  # noqa: E402
from iterative_solver_torch.solvers.refine import EigenpairRefiner  # noqa: E402

B = 256


def operator(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    dvals = np.concatenate([np.linspace(-2.0, 1.0, 24), np.linspace(3.0, 40.0, n - 24)])
    return a + a.T + np.diag(dvals)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--n", type=int, default=1024, help=f"a multiple of {B} (the tile)")
    ap.add_argument("--nroots", type=int, default=6)
    args = ap.parse_args(argv)
    if args.n % B:
        ap.error(f"--n must be a multiple of {B}")
    device = _cli.device(args.device)
    n, nroots = args.n, args.nroots
    matrix = operator(n)
    diag = np.diag(matrix)
    v0 = _cli.guess(diag, nroots)
    common = dict(b=B, dtype=torch.float32, max_iter=100, device=device)

    # 1. screening pass: one int8 plane, tolerance at the quantization floor
    t0 = time.perf_counter()
    screen = FusedDavidson.from_dense_symmetric(matrix, nroots, tier="int8",
                                                convergence_threshold=5e-3, **common)
    evals_s, x_s, err_s, it_s = screen.run_on_device(v0)
    screen_s = time.perf_counter() - t0
    print(f"screen  (int8):        {it_s:3d} iters, max residual "
          f"{err_s.max():.1e}, {screen_s:.2f}s")

    # 2. re-converge the kept roots on the two-plane tier
    t0 = time.perf_counter()
    polish = FusedDavidson.from_dense_symmetric(matrix, nroots, tier="int8_precise",
                                                convergence_threshold=1e-5, **common)
    evals_p, x_p, err_p, it_p = polish.run_on_device(screen.unpad(x_s))
    polish_s = time.perf_counter() - t0
    print(f"polish  (int8_precise):{it_p:3d} iters, max residual "
          f"{err_p.max():.1e}, {polish_s:.2f}s")

    # 3. refine to the 1e-8 bar with f64 outer iterations
    t0 = time.perf_counter()
    refiner = EigenpairRefiner(lambda x: x @ matrix.T, polish.matvec, polish.operand, diag,
                               polish.n, nroots, dtype=torch.float32, device=device)
    out = refiner.refine(polish.unpad(_cli.host(x_p)), tol=1e-8)
    refine_s = time.perf_counter() - t0
    print(f"refine  (f64 outer):   {out.passes:3d} passes, max residual "
          f"{out.residual_norms.max():.1e}, {refine_s:.2f}s")

    ref = _cli.lowest_eigenvalues(matrix, nroots, device)
    ev_err = float(np.abs(np.sort(out.eigenvalues) - ref).max())
    print(f"eigenvalue error vs dense f64: {ev_err:.1e}")
    assert out.converged and out.residual_norms.max() <= 1e-8
    assert ev_err < 1e-9
    print("OK")
    return _cli.report({
        "example": "quantized_screening", "device": device.type, "n": n, "nroots": nroots,
        "b": B, "m_max": screen.m_max,
        "screen": {"iterations": it_s, "errors": err_s, "eigenvalues": np.sort(evals_s),
                   "seconds": screen_s},
        "polish": {"iterations": it_p, "errors": err_p, "eigenvalues": np.sort(evals_p),
                   "seconds": polish_s},
        "refine": {"passes": out.passes, "history": out.history,
                   "cg_iterations": refiner.cg_iterations,
                   "max_residual_f64": out.residual_norms.max(), "seconds": refine_s},
        "eigenvalues": np.sort(out.eigenvalues), "eigenvalue_error": ev_err,
    })


if __name__ == "__main__":
    main()
