"""Shifted response equations (A + sigma_k) x_k = b with block CG.

The static-polarizability / response-function shape: one SPD operator,
several spectral shifts, one right-hand-side family. FusedBlockCG solves
all shifted systems together: the shift lives in the matvec (a per-row
broadcast) and in the per-RHS (nrhs, N) diagonal the Jacobi preconditioner
accepts, so each system is preconditioned with its own shifted diagonal.
Then the non-symmetric twin: the batched non-symmetric linear solve shares
one operator across the shift batch (``operand_axes=(None, 0)``). Dense
float64 products, on the card or, with ``--device cpu``, on the host.

Run: python3 examples_torch/response_equations.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedBlockCG, make_batched_nonsym_lineq_solve  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    n = 512
    shifts = np.array([0.0, 0.5, 1.0, 2.0])
    nrhs = len(shifts)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    mat = a + a.T + np.diag(np.linspace(1.0, 9.0, n))   # SPD, spectrum > 0
    b_vec = rng.standard_normal(n)                       # one perturbation vector
    b = np.tile(b_vec, (nrhs, 1))

    def on(x):
        return torch.as_tensor(np.array(x), dtype=torch.float64, device=device)

    shifts_t = on(shifts)

    def shifted_matvec(x, op):
        # row k of the block sees A + shifts[k]
        return torch.matmul(x, op.T) + shifts_t[:, None] * x

    # per-RHS diagonals: each system preconditioned with its shifted diagonal
    diag_rows = np.diag(mat)[None, :] + shifts[:, None]
    solver = FusedBlockCG(shifted_matvec, diag_rows, n, nrhs, dtype=torch.float64,
                          convergence_threshold=1e-11, max_iter=500, operand=on(mat),
                          device=device)
    x, errors, iters = solver.solve(b)
    x = _cli.host(x)
    print(f"solved {nrhs} shifted systems in {iters} CG iterations, "
          f"max rel residual {np.max(errors):.2e}")
    symmetric = []
    for k, s in enumerate(shifts):
        ref = np.linalg.solve(mat + s * np.eye(n), b_vec)
        err = float(np.max(np.abs(x[k] - ref)))
        resp = float(b_vec @ x[k])   # the response function <b, (A+s)^-1 b>
        print(f"  sigma={s:4.1f}: response={resp:12.6f}  err_vs_direct={err:.2e}")
        assert err < 1e-8
        symmetric.append({"sigma": s, "response": resp, "error": err})
    print("response-equations example OK")

    # --- non-symmetric response: (A + sigma_k) x_k = b where A is not
    # symmetric; the batched non-symmetric solve shares one operator across
    # the shift batch and solves every shifted system together ----------
    mat_ns = mat.copy()
    mat_ns[np.tril_indices(n, -1)] *= 0.9  # 0.1-strength skew
    b2 = rng.standard_normal((2, n))
    nb = len(shifts)

    def mv_shift(x, op):
        a_, s_ = op
        return torch.matmul(x, a_.T) + s_ * x

    diag_b = on(np.stack([np.diag(mat_ns) + s for s in shifts]))
    b_b = on(np.broadcast_to(b2, (nb, 2, n)))
    b_norm = on(np.broadcast_to(np.linalg.norm(b2, axis=1), (nb, 2)))
    x0_b = on(np.stack([b2 / (np.diag(mat_ns)[None, :] + s) for s in shifts]))
    operand = (on(mat_ns), shifts_t)
    binit, bsolve = make_batched_nonsym_lineq_solve(mv_shift, 2, 12, operand_axes=(None, 0))
    state = binit(x0_b, operand, b_b)
    _, _, _, bxb, berrsb, itersb = bsolve(*state, operand, diag_b, b_b, b_norm, 1e-10, 200)
    bxb, berrsb, itersb = _cli.host(bxb), _cli.host(berrsb), _cli.host(itersb)
    print("non-symmetric shifted batch (one batched solve, shared operator):")
    nonsym = []
    for k, s in enumerate(shifts):
        ref = np.linalg.solve(mat_ns + s * np.eye(n), b2.T).T
        rel = float(np.linalg.norm(bxb[k] - ref) / np.linalg.norm(ref))
        print(f"  sigma={s:4.1f}: iters={int(itersb[k]):3d} "
              f"errs={berrsb[k].max():.2e} rel={rel:.2e}")
        assert rel < 1e-8
        nonsym.append({"sigma": s, "iterations": int(itersb[k]),
                       "max_error": berrsb[k].max(), "relative_error": rel})
    print("non-symmetric response OK")
    return _cli.report({"example": "response_equations", "device": device.type, "n": n,
                        "cg_iterations": iters, "cg_errors": errors,
                        "symmetric": symmetric, "nonsym": nonsym})


if __name__ == "__main__":
    main()
