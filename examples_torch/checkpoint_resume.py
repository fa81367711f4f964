"""Checkpoint/resume: interrupt a Davidson run, save the solver state to one
.npz, restore it as a new process would, and finish the solve. Then the
non-hermitian device tier, checkpointed mid-solve and resumed at the
iteration count an uninterrupted run would take.

Both checkpoints go to a temporary directory (``tempfile``: $TMPDIR
chooses the disk) in the ``.npz`` layout, which loads in the JAX package
too; HDF5 (``.h5``) paths need ``h5py``. Float64, on the card or, with
``--device cpu``, on the host.

Run: python3 examples_torch/checkpoint_resume.py [--device cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402
import torch  # noqa: E402

import iterative_solver_torch as its  # noqa: E402
from examples_torch import _cli  # noqa: E402
from iterative_solver_torch import FusedNonSymDavidson  # noqa: E402
from iterative_solver_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    args = ap.parse_args(argv)
    device = _cli.device(args.device)
    f64 = dict(dtype=torch.float64, device=device)
    n = 200
    problem = its.models.ExampleProblem(n, **f64)
    matrix = _cli.host(problem.matrix)
    solver = its.create_linear_eigensystem(n, 2, "Davidson", **f64)
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE

    with tempfile.TemporaryDirectory() as tmp:
        # run three iterations, then "preemption"
        params = torch.zeros((2, n), **f64)
        params[0, 0] = params[1, 1] = 1.0
        actions = torch.zeros((2, n), **f64)
        nwork = 2
        for _ in range(3):
            actions = problem.action(params[:nwork])
            nwork, params, actions = solver.add_vector(params, actions)
            while solver.end_iteration_needed:
                if nwork > 0:
                    actions = problem.precondition(actions[:nwork],
                                                   solver.working_set_eigenvalues()[:nwork],
                                                   problem.diagonals())
                nwork, params, actions = solver.end_iteration(params, actions)
        interrupted_errors = np.asarray(solver.errors)
        print("interrupted with errors:", [f"{e:.1e}" for e in interrupted_errors])
        save_checkpoint(solver, os.path.join(tmp, "davidson_ckpt.npz"))

        # ... new process ...
        resumed = load_checkpoint(os.path.join(tmp, "davidson_ckpt.npz"), **f64)
        p2 = resumed.solution_params([0, 1])
        conv, *_ = resumed.solve(p2, problem=problem)
        evals = np.asarray(resumed.eigenvalues()[:2])
        dense = np.linalg.eigvalsh(matrix)[:2]
        print("resumed and converged:", conv)
        print("eigenvalues:", evals, "vs dense", dense)
        assert conv and np.abs(evals - dense).max() < 1e-9

        # --- the non-hermitian device tier checkpoints mid-solve: the loop
        # state persists between chunks, and resume() continues at the
        # iteration count an uninterrupted run would take ----------------
        mns = matrix.copy()
        mns[np.tril_indices(n, -1)] *= 0.9
        v0 = _cli.guess(np.diag(mns), 2)
        path = os.path.join(tmp, "nonsym_ckpt.npz")
        interrupted = FusedNonSymDavidson.from_dense(
            mns, 2, convergence_threshold=1e-9, max_iter=4, chunk_iters=2, rr="device",
            m_max=12, **f64)
        _, _, errs_i, it_i = interrupted.solve(v0, checkpoint_path=path)
        print(f"nonsym interrupted at iteration {it_i}, residual {errs_i.max():.1e}")
        fresh = FusedNonSymDavidson.from_dense(
            mns, 2, convergence_threshold=1e-9, max_iter=200, rr="device", m_max=12, **f64)
        evals_ns, _, errs, it = fresh.resume(path)
    ref = np.sort(scipy.linalg.eigvals(mns).real)[:2]
    err_ns = float(np.max(np.abs(np.sort(np.asarray(evals_ns).real) - ref[:len(evals_ns)])))
    print(f"nonsym resumed to iteration {it}, residual {errs.max():.1e}, "
          f"eigenvalue error {err_ns:.1e}")
    assert errs.max() <= 1e-9 and err_ns < 1e-9
    return _cli.report({
        "example": "checkpoint_resume", "device": device.type, "n": n,
        "interrupted_errors": interrupted_errors, "resumed_converged": conv,
        "iterations": resumed.stats.iterations, "eigenvalues": evals,
        "nonsym": {"interrupted_at": it_i, "iterations": it, "max_error": errs.max(),
                   "eigenvalues": np.sort(np.asarray(evals_ns).real),
                   "eigenvalue_error": err_ns},
    })


if __name__ == "__main__":
    main()
