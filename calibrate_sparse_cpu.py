#!/usr/bin/env python3
"""CPU calibration of the sparse checks in chip_smoke.py.

    python3 calibrate_sparse_cpu.py [bsr] [parity] [parity_linear] [phenol]

Each part prints one JSON line per run; the constants and limits
chip_smoke.py holds the card to are set from them (PERF.md says with what
margin). The port's plain path runs every solve in float32, as the card
does.

- ``bsr``: the 4 lowest eigenvalues of bench.py's sparse operator
  ``synthetic_fci_bsr(8192, block=128, density=0.3, seed=1)`` by
  ``np.linalg.eigvalsh`` of its dense f64 matrix (chip_smoke's
  REFERENCE_SPARSE_EIGENVALUES), then the sparse FusedDavidson leg on it (16
  roots, m_max 64, rr "full", tol 1e-5, the one-hot guess);
- ``parity``: ``create_linear_eigensystem(8192, 4, "Davidson",
  "convergence_threshold=1e-5")`` on a Problem whose action is the BSR
  action of the same operator;
- ``parity_linear``: ``create_linear_equations(8192, 4, "Davidson",
  "convergence_threshold=1e-5")`` on the same operator plus 3 I (its
  diagonal shifted the same way) with 4 right-hand sides from
  ``default_rng(3)``: iterations, stats, the f64 relative residual, and the
  count of actions it applied;
- ``phenol``: the phenol-scale solve of chip_smoke.py (16 roots, m_max 64,
  tol PHENOL_TOL) at n = 2^16 and at n = 2^14, and at n = 2^14 the 16
  lowest eigenvalues of the dense operator by ``np.linalg.eigvalsh`` against
  the 16 lowest diagonal entries (the margin behind the no-skipped-root
  check) and against the solve.

Each solve reports iterations, the max error, the f64 residual of the
normalised Ritz vectors and, where a reference exists, how far the Rayleigh
quotients lie from it. It imports no JAX and needs no card; it holds up to a
few GB of host memory and takes minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke

CPU = torch.device("cpu")
F32 = torch.float32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def f64_quality(x, dense, ref) -> dict:
    xs = x.double().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ dense
    rq = np.sum(xs * ax, axis=1)
    return {"f64_max_residual": float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1))),
            "rq_max_abs_err": float(np.max(np.abs(np.sort(rq)[:len(ref)] - ref)))}


def bench_operator():
    """bench.py's sparse operator in float32 on the CPU, its dense f64
    matrix, and its 4 lowest eigenvalues."""
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr

    t0 = time.perf_counter()
    bsr, dense = synthetic_fci_bsr(chip_smoke.SPARSE_N, block=chip_smoke.SPARSE_BLOCK,
                                   density=0.3, seed=1, dtype=F32, device=CPU)
    ref = np.linalg.eigvalsh(dense)[:4]
    emit({"part": "reference_sparse_eigenvalues", "n": chip_smoke.SPARSE_N,
          "n_blocks": bsr.n_blocks, "nnz": bsr.nnz, "eigenvalues": ref.tolist(),
          "seconds": time.perf_counter() - t0})
    return bsr, dense, ref


def bsr(op) -> None:
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.ops.kernels.spmv import bsr_matvec

    matrix, dense, ref = op
    diag = np.diagonal(dense)
    matvec, operand = bsr_matvec(matrix)
    solver = FusedDavidson(matvec, diag, chip_smoke.SPARSE_N, chip_smoke.NROOTS,
                           m_max=chip_smoke.M_MAX, rr="full", convergence_threshold=1e-5,
                           max_iter=60, operand=operand, dtype=F32, device=CPU)
    t0 = time.perf_counter()
    _, x, errors, iters = solver.run_on_device(chip_smoke.guess(diag, chip_smoke.NROOTS))
    emit({"part": "bsr_fused_davidson", "iterations": iters,
          "max_error": float(np.max(errors)), **f64_quality(x, dense, ref),
          "seconds": time.perf_counter() - t0})


def parity(op) -> None:
    import iterative_solver_torch as its

    matrix, dense, ref = op
    roots = chip_smoke.PARITY_ROOTS
    solver = its.create_linear_eigensystem(chip_smoke.SPARSE_N, roots, "Davidson",
                                           "convergence_threshold=1e-5", dtype=F32, device=CPU)
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    t0 = time.perf_counter()
    conv, _, _ = solver.solve(np.zeros((roots, chip_smoke.SPARSE_N)),
                              problem=chip_smoke.bsr_problem(matrix),
                              generate_initial_guess=True)
    params, _ = solver.solution(list(range(roots)))
    emit({"part": "parity_create_linear_eigensystem", "converged": bool(conv),
          "iterations": solver.stats.iterations, "stats": str(solver.stats),
          **f64_quality(params, dense, ref), "seconds": time.perf_counter() - t0})


def parity_linear(op) -> None:
    matrix, dense, _ = op
    problem = chip_smoke.shifted_bsr_problem(matrix)
    calls = []
    action = problem.action
    problem.action = lambda p: calls.append(p.shape[0]) or action(p)
    solver, conv, rhs, seconds = chip_smoke.parity_linear_solve(matrix, CPU, problem=problem,
                                                                dtype=F32)
    emit({"part": "parity_create_linear_equations", "converged": bool(conv),
          "iterations": solver.stats.iterations, "stats": str(solver.stats),
          "actions": len(calls), "max_error": float(max(solver.errors)),
          "f64_relative_residual": chip_smoke.parity_linear_residual(solver, dense, rhs),
          "seconds": seconds})


def phenol() -> None:
    for n in (1 << 16, 1 << 14):
        t0 = time.perf_counter()
        op, diag, _ = chip_smoke.phenol_operator(CPU, n)
        solver, v0 = chip_smoke.phenol_solver(op, diag, dtype=F32, device=CPU)
        _, x, errors, iters = solver.run_on_device(v0)
        checks = chip_smoke.quality(x, lambda xs: chip_smoke.bsr_matmat_f64(xs, op), diag,
                                    chip_smoke.PHENOL_ROOTS)
        out = {"part": f"phenol_n{n}", "tol": chip_smoke.PHENOL_TOL, "iterations": iters,
               "max_error": float(np.max(errors)), **checks, "n_blocks": op.n_blocks,
               "max_blocks_per_row": int(np.diff(op.row_ptr.numpy()).max()),
               "seconds": time.perf_counter() - t0}
        if n == 1 << 14:
            dense = np.zeros((n, n))
            vals = op.values.double().numpy()
            b = op.bm
            for k, (r, c) in enumerate(zip(op.row_idx.tolist(), op.col_idx.tolist())):
                dense[r * b:(r + 1) * b, c * b:(c + 1) * b] = vals[k]
            evals = np.linalg.eigvalsh(dense)[:chip_smoke.PHENOL_ROOTS]
            low = np.sort(diag)[:chip_smoke.PHENOL_ROOTS]
            out.update({"eigvalsh_minus_diag_max": float(np.max(np.abs(evals - low))),
                        "eigvalsh_min_gap": float(np.min(np.diff(evals))),
                        "solve_rq_minus_eigvalsh_max": float(np.max(np.abs(
                            np.asarray(checks["rayleigh_quotients_head"]) - evals[:4])))})
        emit(out)


def main(argv) -> int:
    parts = argv or ["bsr", "parity", "parity_linear", "phenol"]
    unknown = set(parts) - {"bsr", "parity", "parity_linear", "phenol"}
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}: use bsr, parity, parity_linear "
                         f"or phenol")
    op = bench_operator() if {"bsr", "parity", "parity_linear"} & set(parts) else None
    for part in parts:
        if part == "bsr":
            bsr(op)
        elif part == "parity":
            parity(op)
        elif part == "parity_linear":
            parity_linear(op)
        else:
            phenol()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
