#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's P-space, linear-equation and
refinement checks, at n=8192.

    JAX_PLATFORMS=cpu python3 calibrate_linear_cpu.py [pspace] [linear] [refine]

Each part prints one JSON line per run; the constants and limits
chip_smoke.py holds the card to are set from them (PERF.md says with what
margin).

- ``pspace``: chip_smoke's P-space Davidson (tier "precise", rr "full",
  16 roots, m_max 96, tol 1e-5; P the unit vectors of the 32 lowest
  diagonal entries with their exact rows as actions; the one-hot guess on
  the next 16) through the port's plain path in float32 (as the card runs
  it) and float64, and the JAX package in float32 and float64. Reported:
  iterations, max error, the f64 residual and the 4 lowest Rayleigh
  quotients against chip_smoke.REFERENCE_EIGENVALUES.
- ``linear``: FusedLinearEquations.from_dense_symmetric(bench + 3 I, 16,
  tier) on chip_smoke's 16 right-hand sides at each tier's tolerance, the
  port in float32 with the fused chain (its plain version on the CPU, as
  K2's raw mode computes) and the JAX package in float32 and float64.
  Reported: iterations, max error, the f64 relative residual ||A x - b|| /
  ||b|| and the f64 relative solution error against np.linalg.solve.
- ``refine``: the refinement leg: the port's precise solve in float32,
  then EigenpairRefiner with the f64 action and the float32 split action
  for the corrections, to 1e-8. Reported: passes, history, CG iterations,
  the eigenvalue error.

This script imports JAX (the reference) and needs no card. It holds a few
GB of host memory and takes minutes.
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
F32 = torch.float32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ritz_quality(x, matrix) -> dict:
    xs = np.asarray(x, dtype=np.float64)[:, : matrix.shape[0]]
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ matrix
    rq = np.sum(xs * ax, axis=1)
    return {"f64_max_residual": float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1))),
            "rq_max_abs_err": float(np.max(np.abs(
                np.sort(rq)[:4] - np.asarray(chip_smoke.REFERENCE_EIGENVALUES))))}


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def pspace(matrix) -> None:
    import jax.numpy as jnp

    _jax()
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson as JDavidson

    p_space, p_actions, v0 = chip_smoke.pspace_inputs(matrix)
    runs = {
        "port_f32": lambda: chip_smoke.pspace_solver(matrix, device=CPU, dtype=F32)[0],
        "port_f64": lambda: chip_smoke.pspace_solver(matrix, device=CPU)[0],
    }
    for name, dtype in (("jax_f32", jnp.float32), ("jax_f64", jnp.float64)):
        runs[name] = lambda dtype=dtype: JDavidson.from_dense_symmetric(
            matrix, chip_smoke.NROOTS, tier="precise", rr="full", m_max=chip_smoke.PSPACE_M_MAX,
            convergence_threshold=1e-5, max_iter=60, p_space=p_space, p_actions=p_actions,
            dtype=dtype)
    for name, make in runs.items():
        t0 = time.perf_counter()
        _, x, errors, iters = make().run_on_device(v0)
        x = x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        emit({"part": "pspace", "run": name, "iterations": int(iters),
              "max_error": float(np.max(errors)), **ritz_quality(x, matrix),
              "seconds": time.perf_counter() - t0})


def linear(matrix) -> None:
    import jax.numpy as jnp

    _jax()
    from iterative_solver_tpu.solvers.fused_linear import FusedLinearEquations as JLinear

    shifted = matrix + chip_smoke.LINEAR_SHIFT * np.eye(N)
    b = chip_smoke.linear_rhs(N)
    t0 = time.perf_counter()
    x_ref = np.linalg.solve(shifted, b.T).T
    emit({"part": "linear_reference", "seconds": time.perf_counter() - t0})
    for tier, tol in chip_smoke.LINEAR_TOLS.items():
        runs = {"port_f32": lambda tier=tier: chip_smoke.linear_solver(
            shifted, tier, device=CPU, dtype=F32, fuse_chain=True)}
        for name, dtype in (("jax_f32", jnp.float32), ("jax_f64", jnp.float64)):
            runs[name] = lambda tier=tier, tol=tol, dtype=dtype: JLinear.from_dense_symmetric(
                shifted, chip_smoke.NROOTS, tier=tier, convergence_threshold=tol, max_iter=60,
                dtype=dtype)
        for name, make in runs.items():
            t0 = time.perf_counter()
            x, errors, iters = make().solve(b)
            x = x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
            emit({"part": "linear", "tier": tier, "run": name, "tol": tol,
                  "iterations": int(iters), "max_error": float(np.max(errors)),
                  **chip_smoke.linear_quality(x, shifted, b, x_ref),
                  "seconds": time.perf_counter() - t0})


def refine(matrix) -> None:
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.solvers.refine import EigenpairRefiner

    diag = np.diagonal(matrix)
    solver = FusedDavidson.from_dense_symmetric(
        matrix, chip_smoke.NROOTS, tier="precise", m_max=chip_smoke.M_MAX, rr="full",
        convergence_threshold=1e-5, max_iter=60, device=CPU, dtype=F32)
    t0 = time.perf_counter()
    _, x, _, iters = solver.run_on_device(chip_smoke.guess(diag, chip_smoke.NROOTS))
    refiner = EigenpairRefiner(lambda xs: xs @ matrix, solver.matvec, solver.operand, diag, N,
                               chip_smoke.NROOTS, dtype=F32, device=CPU)
    out = refiner.refine(x.double().numpy(), tol=chip_smoke.REFINE_TOL)
    emit({"part": "refine", "solve_iterations": iters, "passes": out.passes,
          "history": out.history, "cg_iterations": refiner.cg_iterations,
          "converged": out.converged, "rq_max_abs_err": float(np.max(np.abs(
              np.sort(out.eigenvalues)[:4] - chip_smoke.REFERENCE_EIGENVALUES))),
          "seconds": time.perf_counter() - t0})


PARTS = {"pspace": pspace, "linear": linear, "refine": refine}


def main(argv) -> int:
    parts = argv or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}: use {', '.join(PARTS)}")
    torch.set_num_threads(min(8, torch.get_num_threads()))
    matrix = chip_smoke.bench_matrix(N)
    for part in parts:
        PARTS[part](matrix)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
