"""Sharded Davidson: the vector axis split over ranks, one process each
(reference: examples/LinearEigensystemDistrArrayExample.cpp).

``main`` starts ``--ranks`` processes of this script. They join one gloo
group through a file store in a temporary directory, each keeps its rows
of the operator (``matrix_row_sharding``) and its slice of every vector
(``block_sharding``), and the matvec all-gathers x and multiplies by the
rank's rows. Every rank must return the same bits of the eigenvalues. On
one card all ranks share it and gloo stages each collective through host
memory (NCCL refuses two ranks on one card); ``--device cpu`` runs them on
the host. Float64.

Run: python3 examples_torch/distributed_eigensystem.py [--ranks 2] [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import _cli  # noqa: E402

N = 1024
TIMEOUT_S = 600


def operator(n: int = N) -> np.ndarray:
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * 0.01
    return a + a.T + np.diag(np.linspace(1.0, 10.0, n))


def rank_main(args) -> None:
    """One rank: join the group, solve, write the result to ``<out>/rank<r>.json``."""
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.parallel import (
        block_sharding,
        init_process_group,
        matrix_row_sharding,
    )
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec

    device = _cli.device(args.device)
    if device.type == "cuda":
        # the ranks share the cards in turn (all of them the one card there is)
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    mesh = init_process_group(f"file://{args.store}", args.ranks, args.rank, backend="gloo",
                              device=device)
    try:
        matrix = operator()
        solver = FusedDavidson(row_sharded_matvec(mesh), np.diag(matrix), N, 2, m_max=16,
                               dtype=torch.float64, sharding=block_sharding(mesh),
                               operand=matrix_row_sharding(mesh).shard(matrix))
        v0 = np.zeros((2, N))
        v0[0, 0] = v0[1, 1] = 1.0
        evals, x, errors, iters = solver.run_on_device(v0)
        result = {"rank": args.rank, "evals": np.asarray(evals).tolist(),
                  "iterations": iters, "errors": np.asarray(errors).tolist(),
                  "residuals": _cli.f64_residuals(matrix, x).tolist()}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(result, f)


def main(argv=None) -> dict:
    ap = _cli.parser(__doc__)
    ap.add_argument("--ranks", type=int, default=2)
    # a rank's own arguments, given by main to the processes it starts
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    device = _cli.device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--device", device.type,
               "--ranks", str(args.ranks), "--store", os.path.join(tmp, "store"),
               "--out", tmp]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(args.ranks)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode != 0 for p in procs):
            tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-3000:]}"
                              for r, (p, o) in enumerate(zip(procs, outs)))
            raise RuntimeError(f"a rank failed:\n{tails}")
        ranks = []
        for r in range(args.ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    head = ranks[0]
    dense = np.linalg.eigvalsh(operator())[:2]
    print("ranks:", args.ranks)
    print("eigenvalues:", np.asarray(head["evals"]), " iterations:", head["iterations"])
    print("vs dense:", dense)
    err = float(np.max(np.abs(np.sort(head["evals"]) - dense)))
    assert all(r["evals"] == head["evals"] for r in ranks), "the ranks disagree"
    assert max(head["errors"]) <= 1e-8 and err < 1e-9, (head["errors"], err)
    return _cli.report({"example": "distributed_eigensystem", "device": device.type,
                        "ranks": args.ranks, "n": N, "iterations": head["iterations"],
                        "eigenvalues": np.sort(head["evals"]), "errors": head["errors"],
                        "f64_residuals": head["residuals"], "eigenvalue_error": err,
                        "same_bits_on_every_rank": True})


if __name__ == "__main__":
    main()
