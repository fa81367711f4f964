#!/usr/bin/env python3
"""CPU calibration of the int8 checks in chip_smoke.py, at n=8192.

    JAX_PLATFORMS=cpu python3 calibrate_int8_cpu.py [davidson] [ppcg] [eigvalsh]

Each part prints one JSON line per run; the limits chip_smoke.py holds the
card to are set from them (PERF.md says with what margin).

- ``davidson``: the two int8 Davidson legs of chip_smoke.py on the bench
  matrix (n=8192, 16 roots, m_max 64, the one-hot guess): tier "int8" with
  rr "window", tol 5e-3; tier "int8_precise" with rr "anchored",
  anchor_every=2, tol 1e-5. The port's plain path runs them in float32 (as
  the card does) and in float64, and the JAX package in float64. Reported:
  iterations, max error, the f64 residual of the normalised Ritz vectors
  against the dense matrix, and the 4 lowest f64 Rayleigh quotients against
  chip_smoke.REFERENCE_EIGENVALUES.
- ``ppcg``: FusedPPCG (64 roots, rr_every 8, tol 5e-3, max_iter 400) on
  ``synthetic_packed_int8(8192, b=1024, seed=0)`` through the port's plain
  int8 action in float32. Reported: iterations, the f64 residual against the
  implied operator, max|X X^T - I|, and how far the sorted Rayleigh
  quotients lie from the 64 lowest diagonal entries.
- ``eigvalsh``: the 64 lowest eigenvalues of the implied dense operator of
  that n=8192 instance, against the 64 lowest diagonal entries (the margin
  behind chip_smoke's no-skipped-root check) and against the PPCG result.

This is the one script of the port that imports JAX (the reference); it
needs no card. It holds up to a few GB of host memory.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke

N = 8192
NROOTS_PPCG = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def f64_quality(x, matrix, ref_evals):
    xs = np.asarray(x, dtype=np.float64)[:, : matrix.shape[0]]
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ matrix
    rq = np.sum(xs * ax, axis=1)
    res = float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1)))
    rq_low = np.sort(rq)[: len(ref_evals)]
    return res, float(np.max(np.abs(rq_low - np.asarray(ref_evals))))


DAVIDSON_LEGS = {
    "int8": dict(tier="int8", rr="window", convergence_threshold=5e-3),
    "int8_precise": dict(tier="int8_precise", rr="anchored", anchor_every=2,
                         convergence_threshold=1e-5),
}


def davidson() -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    from iterative_solver_torch import FusedDavidson as TDavidson
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson as JDavidson

    matrix = chip_smoke.bench_matrix(N)
    v0 = chip_smoke.guess(np.diagonal(matrix), chip_smoke.NROOTS)
    common = dict(m_max=chip_smoke.M_MAX, max_iter=60)
    for leg, kw in DAVIDSON_LEGS.items():
        runs = {
            "port_f32": lambda: TDavidson.from_dense_symmetric(
                matrix, chip_smoke.NROOTS, device="cpu", dtype=torch.float32, **kw, **common),
            "port_f64": lambda: TDavidson.from_dense_symmetric(
                matrix, chip_smoke.NROOTS, device="cpu", **kw, **common),
            "jax_f64": lambda: JDavidson.from_dense_symmetric(
                matrix, chip_smoke.NROOTS, **kw, **common),
        }
        for name, make in runs.items():
            t0 = time.perf_counter()
            solver = make()
            evals, x, errors, iters = solver.run_on_device(v0)
            if isinstance(x, torch.Tensor):
                x = x.double().numpy()
            res, rq_err = f64_quality(x, matrix, chip_smoke.REFERENCE_EIGENVALUES)
            emit({"part": "davidson", "leg": leg, "run": name, "iterations": int(iters),
                  "max_error": float(np.max(errors)), "f64_max_residual": res,
                  "rq_max_abs_err": rq_err, "evals": np.sort(np.asarray(evals))[:4].tolist(),
                  "seconds": time.perf_counter() - t0})


def _ppcg_instance():
    from iterative_solver_torch.models.synthetic_fci import synthetic_packed_int8

    return synthetic_packed_int8(N, b=1024, seed=0, device="cpu")


def ppcg():
    """Returns the sorted PPCG eigenvalues, for the eigvalsh part."""
    from iterative_solver_torch import FusedPPCG
    from iterative_solver_torch.ops.kernels.symm_int8 import int8_matvec

    sym, diag = _ppcg_instance()
    matvec, op = int8_matvec(sym)
    solver = FusedPPCG(matvec, diag, N, NROOTS_PPCG, rr_every=8, convergence_threshold=5e-3,
                       max_iter=400, operand=op, device="cpu", dtype=torch.float32)
    v0 = chip_smoke.guess(diag, NROOTS_PPCG)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    rec = chip_smoke.ppcg_quality(x, sym, diag, NROOTS_PPCG)
    rec.update({"part": "ppcg", "n": N, "iterations": int(iters),
                "max_error": float(np.max(errors)), "seconds": time.perf_counter() - t0,
                "evals": evals.tolist()})
    emit(rec)
    return np.sort(evals)


def eigvalsh(ppcg_evals=None) -> None:
    from iterative_solver_torch.models.synthetic_fci import implied_dense_int8

    sym, diag = _ppcg_instance()
    t0 = time.perf_counter()
    ev = np.linalg.eigvalsh(implied_dense_int8(sym, diag))[:NROOTS_PPCG]
    low = np.sort(diag)[:NROOTS_PPCG]
    rec = {"part": "eigvalsh", "n": N, "seconds": time.perf_counter() - t0,
           "max_abs_eig_minus_diag": float(np.max(np.abs(ev - low))),
           "min_gap_of_lowest": float(np.min(np.diff(ev))),
           "eigenvalues": ev.tolist()}
    if ppcg_evals is not None:
        rec["max_abs_ppcg_minus_eig"] = float(np.max(np.abs(ppcg_evals - ev)))
    emit(rec)


def main(argv) -> int:
    parts = argv or ["davidson", "ppcg", "eigvalsh"]
    ppcg_evals = None
    for part in parts:
        if part == "davidson":
            davidson()
        elif part == "ppcg":
            ppcg_evals = ppcg()
        elif part == "eigvalsh":
            eigvalsh(ppcg_evals)
        else:
            raise SystemExit(f"unknown part {part!r}: use davidson, ppcg or eigvalsh")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
