#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's nonlinear and gradient phases, at
n=8192.

    python3 calibrate_nonlinear_cpu.py [lbfgs] [diis] [parity] [implicit]

Each part runs chip_smoke.py's own solver set-ups on the CPU, where the kernel
wrappers take their plain versions, and prints one JSON line per run; the
iteration counts and limits chip_smoke.py holds the card to are set from
them (PERF.md says with what margin).

- ``lbfgs``: ``lbfgs_solver`` (FusedLBFGS on 1/2 xᵀ(A+3I)x − bᵀx, the
  gradient by autograd through the differentiable packed action) in
  float32 (as the card runs it) and float64 at LBFGS_TOL, and float32 at
  looser and tighter tolerances: iterations, evaluations, the gradient
  norm and the f64 relative error against np.linalg.solve.
- ``diis``: ``diis_solver`` (FusedDIIS on (A+3I)x + eps x∘x − b) in float32
  and float64 at DIIS_TOL: iterations, err and the f64 relative residual.
- ``parity``: ``parity_nonlinear_solves`` in float64 (BFGS, SD, DIIS):
  iterations, stats and the distance to np.linalg.solve (the trig
  residual for DIIS).
- ``implicit``: ``implicit_eigenvalues`` in float32 (iterations, the
  eigenvalues' distance to REFERENCE_EIGENVALUES, the relative error of
  d(sum w lambda)/ds against sum w lambda, and of vbar against the f64
  outer-product tiles), and ``implicit_eigenpairs`` in
  float32 against float64: the response solve's iterations and error and
  the tile gradient's relative difference.

This script imports no JAX and needs no card. It holds a few GB of host
memory and takes a few minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke

N = chip_smoke.N
CPU = torch.device("cpu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def inputs():
    matrix = chip_smoke.bench_matrix(N)
    shifted = matrix + chip_smoke.LINEAR_SHIFT * np.eye(N)
    b = chip_smoke.linear_rhs(N)[0]
    return matrix, shifted, b, np.linalg.solve(shifted, b)


def lbfgs(shifted, b, x_ref) -> None:
    base = chip_smoke.LBFGS_TOL
    runs = [(torch.float32, base), (torch.float64, base), (torch.float32, base * 3),
            (torch.float32, base / 3), (torch.float32, base / 30)]
    for dtype, tol in runs:
        chip_smoke.LBFGS_TOL = tol
        t0 = time.perf_counter()
        solver, evaluations = chip_smoke.lbfgs_solver(shifted, b, CPU, dtype)
        x, f, gnorm, iters = solver.run(np.zeros(N))
        emit({"part": "lbfgs", "dtype": str(dtype), "tol": tol, "iterations": iters,
              "evaluations": evaluations[0], "gnorm": gnorm, "f": f,
              "f64_solution_error": chip_smoke.relative_error(x.numpy(), x_ref),
              "seconds": time.perf_counter() - t0})
    chip_smoke.LBFGS_TOL = base


def diis(shifted, b) -> None:
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        x, err, iters = chip_smoke.diis_solver(shifted, b, CPU, dtype).run(np.zeros(N))
        emit({"part": "diis", "dtype": str(dtype), "tol": chip_smoke.DIIS_TOL,
              "iterations": iters, "err": err,
              "f64_relative_residual": chip_smoke.diis_residual_f64(x.numpy(), shifted, b),
              "seconds": time.perf_counter() - t0})


def parity(shifted, x_ref) -> None:
    for method, solver, converged, x, wall in chip_smoke.parity_nonlinear_solves(
            shifted, x_ref, CPU):
        check = (float(np.max(np.abs(x - x_ref))) if method != "DIIS"
                 else chip_smoke.trig_residual_f64(x))
        emit({"part": "parity", "method": method, "converged": bool(converged),
              "iterations": solver.stats.iterations,
              "line_searches": solver.stats.line_searches, "stats": str(solver.stats),
              "check": check, "seconds": wall})


def implicit(matrix) -> None:
    t0 = time.perf_counter()
    eig = chip_smoke.implicit_eigenvalues(matrix, CPU, torch.float32)
    rq_err = float(np.max(np.abs(np.sort(eig["eigenvalues"])
                                 - np.asarray(chip_smoke.REFERENCE_EIGENVALUES))))
    emit({"part": "implicit_eigenvalues", "dtype": "torch.float32", **eig,
          "rq_max_abs_err": rq_err, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    g64, info64 = chip_smoke.implicit_eigenpairs(matrix, CPU, torch.float64, plain=True,
                                                 tol=1e-9, response_tol=1e-8)
    emit({"part": "implicit_eigenpairs", "dtype": "torch.float64", **info64,
          "seconds": time.perf_counter() - t0})
    for response_tol in (chip_smoke.EIGENPAIR_RESPONSE_TOL, 1e-5):
        t0 = time.perf_counter()
        g32, info32 = chip_smoke.implicit_eigenpairs(matrix, CPU, torch.float32,
                                                     response_tol=response_tol)
        emit({"part": "implicit_eigenpairs", "dtype": "torch.float32",
              "response_tol": response_tol, **info32,
              "gradient_relative_error": float(np.max(np.abs(g32 - g64))
                                               / np.max(np.abs(g64))),
              "seconds": time.perf_counter() - t0})


def main(argv) -> int:
    parts = argv or ["lbfgs", "diis", "parity", "implicit"]
    matrix, shifted, b, x_ref = inputs()
    if "lbfgs" in parts:
        lbfgs(shifted, b, x_ref)
    if "diis" in parts:
        diis(shifted, b)
    if "parity" in parts:
        parity(shifted, x_ref)
    if "implicit" in parts:
        implicit(matrix)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
