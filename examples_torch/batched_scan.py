"""Batched eigensolves: a whole parameter scan as one batched solve.

Quantum-chemistry workloads often sweep a geometry or a parameter and solve
the same-sized eigenproblem at every point. Here the entire scan runs
through ``torch.func.vmap`` of the Davidson step: every operation runs once
for the batch (batched matmuls and eighs), never a Python loop over the
points. Then the non-hermitian scan, through the device-RR iteration.
Dense float64 products, on the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/batched_scan.py [--n 1024 --points 8]
     [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch.solvers.fused_davidson import make_batched_davidson_solve  # noqa: E402
from iterative_solver_torch.solvers.fused_nonsym import (  # noqa: E402
    finalize_nonsym_batch,
    make_batched_nonsym_solve,
)

NROOTS, M_MAX = 3, 18


def matvec(x, op):
    return torch.matmul(x, op.T)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--points", type=int, default=6)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    n, npoints = args.n, args.points
    rng = np.random.default_rng(0)
    base = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    base = base + base.T

    # the "scan": a coupling strength lambda sweeping 0.2 .. 1.2
    lams = np.linspace(0.2, 1.2, npoints)
    mats = np.stack([lam * base + np.diag(np.linspace(0.0, 12.0, n)) for lam in lams])
    diags = np.stack([np.diag(m) for m in mats])
    v0 = np.stack([_cli.guess(d, NROOTS) for d in diags])

    def on(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    binit, bsolve = make_batched_davidson_solve(matvec, NROOTS, M_MAX)
    final, iters = bsolve(binit(on(v0), on(mats)), on(mats), on(diags), 1e-9, 800)
    evals = np.sort(_cli.host(final.evals), axis=1)
    errors = _cli.host(final.errors)
    iters = [int(i) for i in _cli.host(iters)]
    scan = []
    for p in range(npoints):
        ref = _cli.lowest_eigenvalues(mats[p], NROOTS, device)
        err = float(np.abs(evals[p] - ref).max())
        assert errors[p].max() < 1e-9, (p, "not converged")
        assert err < 1e-8, (p, err)
        print(f"lambda={lams[p]:.2f}: iters={iters[p]:3d} E0..E{NROOTS-1} = {evals[p]}")
        scan.append({"lambda": lams[p], "iterations": iters[p], "eigenvalues": evals[p],
                     "max_error": errors[p].max(), "eigenvalue_error": err})
    print("scan complete: every point converged in one batched solve")

    # --- the non-hermitian scan: only the device-RR iteration batches (the
    # host-eig chunked path cannot vmap its per-append LAPACK stage); the
    # per-element host eig runs once, in the batch finalize ---------------
    mats_ns = mats.copy()
    for p in range(npoints):
        mats_ns[p][np.tril_indices(n, -1)] *= 0.9  # strength-0.1 skew
    diags_ns = np.stack([np.diag(m) for m in mats_ns])

    binit_ns, bsolve_ns = make_batched_nonsym_solve(matvec, NROOTS, M_MAX)
    state = binit_ns(on(v0), on(mats_ns))
    _, _, _, bx, bG, bR, iters_ns = bsolve_ns(*state, on(mats_ns), on(diags_ns), 1e-9, 800)
    evals_ns, _, errors_ns = finalize_nonsym_batch(bx, bG, bR)
    iters_ns = [int(i) for i in _cli.host(iters_ns)]
    scan_ns = []
    for p in range(npoints):
        ref = np.sort(scipy.linalg.eigvals(mats_ns[p]).real)[:NROOTS]
        ev = np.sort(np.asarray(evals_ns[p]).real)
        err = float(np.abs(ev - ref[: len(ev)]).max())
        assert np.max(errors_ns[p]) < 1e-8, (p, "not converged")
        assert err < 1e-8, (p, err)
        print(f"lambda={lams[p]:.2f} (nonsym): iters={iters_ns[p]:3d} "
              f"Re E = {np.round(ev, 8)}")
        scan_ns.append({"lambda": lams[p], "iterations": iters_ns[p], "eigenvalues": ev,
                        "max_error": np.max(errors_ns[p]), "eigenvalue_error": err})
    print("non-hermitian scan: every point converged in one batched solve")
    return _cli.report({"example": "batched_scan", "device": device.type, "n": n,
                        "points": npoints, "nroots": NROOTS, "scan": scan,
                        "nonsym": scan_ns})


if __name__ == "__main__":
    main()
