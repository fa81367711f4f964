#!/usr/bin/env python3
"""CPU calibration of the sharded phases of chip_smoke.py (b, c, d and the
family phases) and of its c_api phase.

    python3 calibrate_sharded_cpu.py [solves] [ppcg] [bsr] [lbfgs] [diis]
        [refine] [nonsym] [banded] [chebyshev] [parity] [offload] [c_api]

Each part runs chip_smoke.py's own phase code (``spawn_shards``: 4 rank
processes of chip_smoke.py joined by gloo, here on the CPU, where every
kernel wrapper takes its plain PyTorch version) in float32, as the card
runs it, and prints one JSON line per phase: rank 0's record (iterations,
the f64 checks) with every rank's iterations and whether the ranks
returned the same bits. Beside the sharded solves, ``solves`` runs the
same five tiers unsharded in float32 in this process, so the iteration
counts chip_smoke.py compares (within SHARD_ITER_SLACK) and the limits it
holds (the unsharded phases') can be checked off the card.

- ``solves``: FusedDavidson.from_dense_symmetric(sharding=) on the bench
  matrix (n = 8192, 16 roots, m_max 64) in the five tiers, each at its
  unsharded phase's settings (chip_smoke.SHARD_TIERS);
- ``ppcg``: the sharded PPCG flagship's configuration (64 roots, rr_every
  8, tol 5e-3) at n = 8192 (``synthetic_packed_int8(8192, b=1024)``): the
  plain int8 action at n = 32768 takes too long on the CPU;
- ``bsr``: the sharded BSR FusedDavidson on bench.py's sparse operator
  (n = 8192, 16 roots, m_max 64, tol 1e-5);
- the family phases (``lbfgs``, ``diis``, ``refine``, ``nonsym``,
  ``banded``, ``chebyshev``, ``parity``, ``offload``;
  chip_smoke.SHARD_FAMILIES), each run twice: on 4 ranks and on 1 rank
  (the same code with nothing to add across ranks, the unsharded count the
  card's sharded run is held to where the card has no unsharded twin:
  chip_smoke.SHARD_FAMILY_CPU_ITERATIONS). Each record carries the
  iterations, the collectives by kind (``collectives``) and the bytes a
  rank would stage through host memory on the card (``exchange_bytes``);
- ``c_api``: chip_smoke.c_api_loop in this process on the CPU (the float64
  solver, the float32 plain K1 action): chip_smoke.C_API_ITERATIONS.

No JAX; no card. About 10 minutes with the first three parts on 8 cores,
and a few GB of host memory (the bench matrix in every rank).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

CALIBRATION_FLAGSHIP_N = 8192


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def summarise(ranks) -> None:
    for recs in zip(*[r[1:] for r in ranks]):
        head = dict(recs[0])
        if "evals" in head:
            head.pop("evals")
            head["rank_iterations"] = [rec["iterations"] for rec in recs]
            head["evals_same_bits_on_every_rank"] = all(
                rec["evals"] == recs[0]["evals"] for rec in recs)
        emit(head)


def unsharded_solves() -> None:
    """The five tiers unsharded, float32, on the CPU: the iteration counts
    the sharded solves are compared with."""
    from iterative_solver_torch import FusedDavidson

    matrix = cs.bench_matrix(cs.N)
    v0 = cs.guess(np.diagonal(matrix), cs.NROOTS)
    for tier, (rr, tol, res_limit, rq_limit, _, kw) in cs.SHARD_TIERS.items():
        solver = FusedDavidson.from_dense_symmetric(
            matrix, cs.NROOTS, tier=tier, m_max=cs.M_MAX, rr=rr, convergence_threshold=tol,
            max_iter=60, dtype=torch.float32, device="cpu", **kw)
        t0 = time.perf_counter()
        _, x, errors, iters = solver.run_on_device(v0)
        emit({"phase": f"unsharded[{tier}]", "iterations": iters,
              "max_error": float(np.max(errors)), "seconds": time.perf_counter() - t0,
              "f64_residual_limit": res_limit, "rq_limit": rq_limit,
              **cs.dense_quality(x, matrix, cs.REFERENCE_EIGENVALUES)})


def summarise_family(ranks, world: int) -> None:
    for recs in zip(*[r[1:] for r in ranks]):
        head = dict(recs[0])
        if "unsharded_key" not in head:
            continue
        head.pop("evals")
        head["world"] = world
        head["rank_iterations"] = [rec["iterations"] for rec in recs]
        head["evals_same_bits_on_every_rank"] = all(
            rec["evals"] == recs[0]["evals"] for rec in recs)
        iters = max(head["iterations"], 1)
        head["collectives_per_iteration"] = {
            k: head["collectives"][k] / iters
            for k in ("all_gather", "reduce_scatter", "all_reduce")}
        head["exchange_bytes_per_iteration"] = head["collectives"]["exchange_bytes"] / iters
        emit(head)


def c_api_part() -> None:
    """chip_smoke.c_api_loop on the CPU: the float64 solver through the C
    ABI, the float32 plain K1 action."""
    import os

    os.environ["ITERATIVE_SOLVER_DEVICE"] = "cpu"
    matrix = cs.bench_matrix(cs.N)
    cpu = torch.device("cpu")
    sym = cs.packed_exact(matrix, cpu, torch.float32)
    t0 = time.perf_counter()
    evals, errors, p, iters, stats, calls, depth = cs.c_api_loop(
        matrix, cpu, cs.k1_host_action(sym, cpu))
    emit({"part": "c_api", "iterations": iters, "stats": stats, "calls": calls,
          "max_error": float(errors.max()), "stack_after_finalize": depth,
          "seconds": time.perf_counter() - t0,
          **cs.dense_quality(torch.as_tensor(p), matrix,
                             cs.REFERENCE_EIGENVALUES[:cs.PARITY_ROOTS])})


def family_inputs(parts) -> dict:
    """The arrays the family phases read, made once as chip_smoke.main
    makes them: the shifted system's solution ``x_ref`` and (for
    ``refine``) the precise solve's Ritz rows ``refine_x0``, here in
    float32 on the CPU."""
    matrix = cs.bench_matrix(cs.N)
    shifted = matrix + cs.LINEAR_SHIFT * np.eye(cs.N)
    inputs = {"x_ref": np.linalg.solve(shifted, cs.linear_rhs(cs.N)[0])}
    del shifted
    if "refine" in parts:
        inputs["refine_x0"] = cs.precise_start(matrix, torch.device("cpu"))
    return inputs


def main(argv) -> int:
    parts = argv or ["solves", "ppcg", "bsr"]
    inputs = (family_inputs(parts) if any(p in cs.SHARD_FAMILIES for p in parts)
              else None)
    for part in parts:
        t0 = time.perf_counter()
        if part == "c_api":
            c_api_part()
            continue
        worlds = (4, 1) if part in cs.SHARD_FAMILIES else (4,)
        for world in worlds:
            ranks = cs.spawn_shards([part], device_kind="cpu", world=world,
                                    flagship_n=CALIBRATION_FLAGSHIP_N, timeout=3600,
                                    inputs=inputs)
            emit({"part": part, "world": world, "seconds": time.perf_counter() - t0})
            if part in cs.SHARD_FAMILIES:
                summarise_family(ranks, world)
            else:
                summarise(ranks)
        if part == "solves":
            unsharded_solves()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
