#!/usr/bin/env python3
"""CPU calibration of the sharded phases of chip_smoke.py (b, c and d).

    python3 calibrate_sharded_cpu.py [solves] [ppcg] [bsr]

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
  (n = 8192, 16 roots, m_max 64, tol 1e-5).

No JAX; no card. About 10 minutes with all three parts on 8 cores, and a
few GB of host memory (the bench matrix in every rank).
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


def main(argv) -> int:
    parts = argv or ["solves", "ppcg", "bsr"]
    for part in parts:
        t0 = time.perf_counter()
        ranks = cs.spawn_shards([part], device_kind="cpu",
                                flagship_n=CALIBRATION_FLAGSHIP_N, timeout=3600)
        emit({"part": part, "seconds": time.perf_counter() - t0})
        summarise(ranks)
        if part == "solves":
            unsharded_solves()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
