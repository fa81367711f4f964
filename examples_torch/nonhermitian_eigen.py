"""Non-hermitian eigenproblems.

The reference solves non-hermitian problems through its one Davidson
template (the hermiticity option). Here the fused path is
FusedNonSymDavidson with two RR modes:

- rr="host" (default, reference parity): one card chunk per block append,
  a host LAPACK ``eig`` between chunks, conjugate pairs in real arithmetic;
- rr="device": the whole solve as one loop on the card, simultaneous
  Rayleigh-shifted inverse iteration in place of the per-append host eig.

Shows a real-spectrum non-symmetric solve checked against dense eig (in
both modes), a genuinely complex lowest pair, and the multi-RHS linear
equations twin with its own projected solve. Dense float64 products, on
the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/nonhermitian_eigen.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedNonSymDavidson, FusedNonSymLinearEquations  # noqa: E402


def matvec(x, op):
    return torch.matmul(x, op.T)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    f64 = dict(dtype=torch.float64, device=device)

    # --- 1. real-spectrum non-symmetric operator (the lower triangle scaled
    # by 1 - strength) ------------------------------------------------------
    n, nroots = 512, 4
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    diag = np.concatenate([np.linspace(-2.0, 0.0, 8), np.linspace(2.0, 20.0, n - 8)])
    mat = a + a.T + np.diag(diag)
    mat[np.tril_indices(n, -1)] *= 0.8  # strength 0.2

    solver = FusedNonSymDavidson.from_dense(mat, nroots, m_max=16,
                                            convergence_threshold=1e-10, max_iter=80, **f64)
    v0 = _cli.guess(diag, nroots)
    evals, x, errs, it = solver.solve(v0)
    ref = np.sort(scipy.linalg.eigvals(mat).real)[:nroots]
    print(f"real spectrum: {it} iterations, max residual {errs.max():.2e}")
    print(f"  eigenvalues   {np.round(np.sort(evals.real), 8)}")
    print(f"  dense eig ref {np.round(ref, 8)}")
    err_host = float(np.abs(np.sort(evals.real) - ref).max())
    assert err_host < 1e-8

    # the same solve through the device-RR mode
    s_dev = FusedNonSymDavidson.from_dense(mat, nroots, m_max=16,
                                           convergence_threshold=1e-10, max_iter=120,
                                           rr="device", **f64)
    evals_d, _, errs_d, it_d = s_dev.solve(v0)
    err_dev = float(np.abs(np.sort(evals_d.real) - ref).max())
    print(f"device-RR:     {it_d} iterations, max residual {errs_d.max():.2e}")
    assert err_dev < 1e-8

    # --- 2. a complex conjugate pair as the lowest roots -------------------
    m2 = np.diag(np.linspace(5.0, 25.0, n)) + rng.standard_normal((n, n)) * 0.01
    m2[0, 0] = m2[1, 1] = 1.0
    m2[0, 1], m2[1, 0] = -1.5, 1.5      # eigenvalues 1 +- 1.5i
    m2[0, 2:] = m2[1, 2:] = m2[2:, 0] = m2[2:, 1] = 0.0
    s2 = FusedNonSymDavidson.from_dense(m2, 3, m_max=16, convergence_threshold=1e-9,
                                        max_iter=80, **f64)
    evals2, _, errs2, it2 = s2.solve(_cli.guess(np.diag(m2), 3))
    print(f"complex pair:  eigenvalues {np.round(evals2, 6)} "
          f"(max residual {errs2.max():.2e})")
    pair = sorted(evals2[:2], key=lambda z: -z.imag)[0]
    assert abs(pair - (1 + 1.5j)) < 1e-7

    # --- 3. multi-RHS linear equations with the same operator character ----
    b = rng.standard_normal((3, n))
    mat_pd = a + a.T + np.diag(np.linspace(1.0, 20.0, n))
    mat_pd[np.tril_indices(n, -1)] *= 0.9
    lin = FusedNonSymLinearEquations(matvec, np.diag(mat_pd), n, 3, m_max=18,
                                     convergence_threshold=1e-11, max_iter=120,
                                     operand=torch.as_tensor(mat_pd, **f64), **f64)
    xs, errs3, it3 = lin.solve(b)
    ref_x = np.linalg.solve(mat_pd, b.T).T
    rel = float(np.linalg.norm(_cli.host(xs) - ref_x) / np.linalg.norm(ref_x))
    print(f"linear eqs:    {it3} iterations, max rel residual {errs3.max():.2e}, "
          f"|x - dense| / |x| = {rel:.2e}")
    assert rel < 1e-9
    print("OK")
    return _cli.report({
        "example": "nonhermitian_eigen", "device": device.type, "n": n,
        "host_rr": {"iterations": it, "eigenvalues": np.sort(evals.real),
                    "max_error": errs.max(), "eigenvalue_error": err_host},
        "device_rr": {"iterations": it_d, "eigenvalues": np.sort(evals_d.real),
                      "max_error": errs_d.max(), "eigenvalue_error": err_dev},
        "complex_pair": {"iterations": it2, "eigenvalues": evals2, "max_error": errs2.max()},
        "linear": {"iterations": it3, "max_error": errs3.max(), "relative_error": rel},
    })


if __name__ == "__main__":
    main()
