#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's non-hermitian phases, at their full
shapes (n = 8192).

    python3 calibrate_nonsym_cpu.py [eigen] [pairs] [linear] [batched] [shifted] [checkpoint]

Each part runs chip_smoke.py's own set-ups on the CPU, where the port's
plain path runs, in float32 (as the card runs it) and float64, and prints
one JSON line per run; the tolerances, limits and iteration counts that
chip_smoke.py holds the card to are set from them (PERF.md says with what
margin).

- ``eigen``: ``FusedNonSymDavidson.from_dense`` on ``nonsym_matrix()``
  (bench.py's leg_nonsym), 16 roots, m_max 64: every tier with rr
  "device" and "precise" with rr "host", float32 and float64: iterations,
  the largest error, the f64 residuals of the rows, the eigenvalues'
  distance to NONSYM_REFERENCE_EIGENVALUES.
- ``pairs``: ``pair_matrix()`` (6 conjugate pairs), 6 roots, m_max 24, rr
  "device", float32 and float64: iterations, escalation, the distance to
  PAIR_REFERENCE_EIGENVALUES, the pair blocks' residuals.
- ``linear``: ``FusedNonSymLinearEquations`` on the operator + 3 I with 16
  right-hand sides, "precise" and "int8_precise", rr "device" and "host":
  iterations, the f64 relative residual, the error against
  np.linalg.solve.
- ``batched``: ``solve_nonsym_batched`` in float32 and float64.
- ``shifted``: ``solve_nonsym_shifted`` in float32.
- ``checkpoint``: ``solve_nonsym_checkpointed`` in float32.

This script imports no JAX and needs no card. It holds a few GB of host
memory and takes several minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

CPU = torch.device("cpu")
DTYPES = (torch.float32, torch.float64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def eigen(matrix, a64) -> None:
    v0 = cs.guess(np.diag(matrix), cs.NONSYM_ROOTS)
    runs = [(tier, "device", dt) for tier in cs.NONSYM_TIERS for dt in DTYPES]
    runs += [("precise", "host", dt) for dt in DTYPES]
    for tier, rr, dtype in runs:
        tol = cs.NONSYM_TIERS[tier][0]
        t0 = time.perf_counter()
        solver = cs.nonsym_solver(matrix, tier, rr, tol, CPU, dtype)
        evals, x, errors, iters = solver.solve(v0)
        emit({"part": "eigen", "tier": tier, "rr": rr, "dtype": str(dtype), "tol": tol,
              "iterations": iters, "max_error": float(np.max(errors)),
              "roots": len(evals), **cs.nonsym_quality(x, evals, a64),
              "eigenvalue_max_abs_err": cs.eigenvalue_error(
                  evals, cs.NONSYM_REFERENCE_EIGENVALUES) if cs.NONSYM_REFERENCE_EIGENVALUES
              else None, "seconds": time.perf_counter() - t0})


def pairs() -> None:
    matrix = cs.pair_matrix()
    a64 = torch.as_tensor(matrix)
    v0 = cs.guess(np.diag(matrix), cs.PAIR_ROOTS)
    for dtype in DTYPES:
        t0 = time.perf_counter()
        solver = cs.nonsym_solver(matrix, "precise", "device", cs.PAIR_TOL, CPU, dtype,
                                  nroots=cs.PAIR_ROOTS, m_max=cs.PAIR_M_MAX,
                                  max_iter=cs.PAIR_MAX_ITER, chunk_iters=cs.PAIR_CHUNK)
        evals, x, errors, iters = solver.solve(v0)
        emit({"part": "pairs", "dtype": str(dtype), "tol": cs.PAIR_TOL, "iterations": iters,
              "rr_steps_active": solver.rr_steps_active, "max_error": float(np.max(errors)),
              "eigenvalues": [[float(e.real), float(e.imag)] for e in evals],
              **cs.nonsym_quality(x, evals, a64),
              "eigenvalue_max_abs_err": cs.eigenvalue_error(
                  evals, cs.PAIR_REFERENCE_EIGENVALUES) if cs.PAIR_REFERENCE_EIGENVALUES
              else None, "seconds": time.perf_counter() - t0})


def linear(matrix) -> None:
    shifted = matrix + cs.LINEAR_SHIFT * np.eye(cs.NONSYM_N)
    a64 = torch.as_tensor(shifted)
    b = cs.linear_rhs(cs.NONSYM_N)
    x_ref = np.linalg.solve(shifted, b.T).T
    for tier in cs.NONSYM_LINEAR_TIERS:
        for rr in ("device", "host"):
            for dtype in DTYPES:
                t0 = time.perf_counter()
                x, errors, iters = cs.nonsym_linear_solver(shifted, tier, rr, CPU,
                                                           dtype).solve(b)
                emit({"part": "linear", "tier": tier, "rr": rr, "dtype": str(dtype),
                      "tol": cs.NONSYM_LINEAR_TIERS[tier][0], "iterations": iters,
                      "max_error": float(np.max(errors)),
                      **cs.nonsym_linear_quality(x, a64, b, x_ref),
                      "seconds": time.perf_counter() - t0})


def main() -> int:
    parts = set(sys.argv[1:]) or {"eigen", "pairs", "linear", "batched", "shifted",
                                  "checkpoint"}
    torch.set_num_threads(max(1, min(8, torch.get_num_threads())))
    cs.emit = lambda obj: None      # the phases' own records: only this script's lines
    matrix = cs.nonsym_matrix() if parts & {"eigen", "linear", "shifted",
                                            "checkpoint"} else None
    if "eigen" in parts:
        eigen(matrix, torch.as_tensor(matrix))
    if "pairs" in parts:
        pairs()
    if "linear" in parts:
        linear(matrix)
    if "batched" in parts:
        for dtype in DTYPES:
            try:
                emit({"part": "batched", "dtype": str(dtype),
                      **_record(cs.solve_nonsym_batched, CPU, dtype)})
            except AssertionError as exc:
                emit({"part": "batched", "dtype": str(dtype), "failed": str(exc)})
    if "shifted" in parts:
        shifted = matrix + cs.LINEAR_SHIFT * np.eye(cs.NONSYM_N)
        try:
            emit({"part": "shifted", **_record(cs.solve_nonsym_shifted, shifted,
                                               cs.linear_rhs(cs.NONSYM_N), CPU)})
        except AssertionError as exc:
            emit({"part": "shifted", "failed": str(exc)})
    if "checkpoint" in parts:
        try:
            emit({"part": "checkpoint",
                  **_record(cs.solve_nonsym_checkpointed, matrix, CPU, torch.float32)})
        except AssertionError as exc:
            emit({"part": "checkpoint", "failed": str(exc)})
    return 0


def _record(fn, *args) -> dict:
    """A phase's record, its timings dropped (CPU seconds are no device
    metric)."""
    rec = fn(*args)
    return {k: v for k, v in rec.items() if "seconds" not in k}


if __name__ == "__main__":
    sys.exit(main())
