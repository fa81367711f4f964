"""PPCG against the Davidson RR modes on a weakly diagonally dominant
operator.

The Davidson families' window RR modes are cheap per iteration but lean on
Jacobi preconditioning; on spectra with weak diagonal dominance they stall.
FusedPPCG (per-root 3x3 Rayleigh-Ritz, conjugate momentum and a periodic
full RR, arXiv:1407.7506) keeps the three-term recurrence of LOBPCG-grade
convergence with no per-step eigh. Every product here is a dense float64
``torch.matmul``, on the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/ppcg_hard_spectrum.py [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedPPCG  # noqa: E402
from iterative_solver_torch.solvers.fused_davidson import (  # noqa: E402
    make_davidson_init,
    make_davidson_solve,
)

RR_MODES = ("window", "window3", "full")


def matvec(x, op):
    return torch.matmul(x, op.T)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    n, nroots, tol = 768, 8, 1e-9
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.4 / np.sqrt(n))  # weak dominance
    mat = a + a.T + np.diag(np.linspace(0.0, 6.0, n))
    mt = torch.as_tensor(mat, dtype=torch.float64, device=device)
    ref = _cli.lowest_eigenvalues(mat, nroots, device)
    v0 = _cli.guess(np.diag(mat), nroots)

    t0 = time.perf_counter()
    ppcg = FusedPPCG(matvec, np.diag(mat), n, nroots, rr_every=5, dtype=torch.float64,
                     convergence_threshold=tol, max_iter=500, operand=mt, device=device)
    evals, x, errors, it_ppcg = ppcg.run(v0)
    ppcg_err = float(np.max(np.abs(evals - ref)))
    print(f"PPCG:            {it_ppcg:4d} iterations ({time.perf_counter()-t0:.2f} s), "
          f"eig err {ppcg_err:.1e}")
    assert ppcg_err < 1e-8

    davidson = {}
    v0_t = torch.as_tensor(v0, dtype=torch.float64, device=device)
    for rr in RR_MODES:
        init = make_davidson_init(matvec, nroots, 4 * nroots)
        solve = make_davidson_solve(matvec, nroots, 4 * nroots, rr=rr)
        t0 = time.perf_counter()
        final, iters = solve(init(v0_t, mt), mt, torch.diagonal(mt), tol, 500)
        resid = float(torch.max(final.errors))
        err = float(np.max(np.abs(np.sort(_cli.host(final.evals)) - ref)))
        print(f"Davidson {rr:8s}{int(iters):4d} iterations ({time.perf_counter()-t0:.2f} s), "
              f"max resid {resid:.1e}, eig err {err:.1e}")
        assert resid <= tol and err < 1e-8, (rr, resid, err)
        davidson[rr] = {"iterations": int(iters), "max_residual": resid,
                        "eigenvalues": np.sort(_cli.host(final.evals)), "eigenvalue_error": err}

    assert it_ppcg < 200
    print("PPCG hard-spectrum example OK")
    return _cli.report({
        "example": "ppcg_hard_spectrum", "device": device.type, "n": n, "nroots": nroots,
        "ppcg": {"iterations": it_ppcg, "eigenvalues": evals, "errors": errors,
                 "eigenvalue_error": ppcg_err},
        "davidson": davidson,
    })


if __name__ == "__main__":
    main()
