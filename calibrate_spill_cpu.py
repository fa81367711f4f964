#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's spill and many-root phases, at their
full shapes.

    python3 calibrate_spill_cpu.py [offload] [parity] [banded] [chebyshev] [sweeps]
    python3 calibrate_spill_cpu.py --device cuda sweeps

Each part runs chip_smoke.py's own set-ups on the CPU, where the port's
plain path runs, in float32 (as the card runs it), and prints one JSON line
per run; the limits and iteration counts that chip_smoke.py holds the card
to are set from them (PERF.md says with what margin).

- ``offload``: the streamed offload store at n = 2^20 with 256 rows in
  blocks of 64 (2.15 GB in the store's file), 16 rows of x: the error of
  its float32 gram against the host f64 store's and of its combination
  against float64, and pipelined against serial bits. (On the CPU the data
  comes from torch's CPU generator, not the card's.)
- ``parity``: create_linear_eigensystem on the bench BSR operator through
  the default stores, offload=True and offload="streamed": iterations,
  stats, the f64 residual.
- ``banded``: the 32 lowest eigenvalues of the bench matrix by
  np.linalg.eigvalsh in float64 (BANDED_REFERENCE_EIGENVALUES), then
  BandedEigensolver in both modes on the "exact" action: runs, the f64
  residuals, max|X X^T - I|, the eigenvalue errors.
- ``chebyshev``: make_chebyshev_davidson on the bench matrix, then
  Chebyshev and Jacobi on the flat-diagonal operator: iterations, matvecs,
  residuals, eigenvalue errors.
- ``sweeps`` (not in the default list): the streamed banded mode under
  variants that each change one source of rounding, with the f64 residual
  of every purged row at every sweep, to find what sets the sweep count.
  On the CPU: the plain path, K2's emulated partition and order
  (``expand_chain_emulated``), and that with K1's emulated walk
  (``square_walk``). With ``--device cuda`` (the one part that runs on the
  card): K1 and K2 as the smoke runs them, the plain chain in place of K2,
  a dense float32 matvec in place of K1, and the purge in float64.

This script imports no JAX and needs no card. It holds a few GB of host
memory (and 2.15 GB in tempfile.gettempdir(), TMPDIR) and takes several minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

CPU = torch.device("cpu")
F32 = torch.float32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def offload() -> None:
    from iterative_solver_torch.array.offload_store import StreamedOffloadStore

    store = StreamedOffloadStore(cs.OFFLOAD_ROWS, cs.OFFLOAD_N, dtype=F32,
                                 block_rows=cs.OFFLOAD_BLOCK_ROWS, device=CPU)
    t0 = time.perf_counter()
    slots = cs.offload_fill(store, cs.OFFLOAD_ROWS, CPU)
    x, coeff = cs.offload_inputs(store, CPU)
    g64, host_s, r64, c64 = cs.offload_references(store, slots, x, coeff, CPU)
    del r64
    g, c = store.gram(x, slots), store.combine(coeff, slots)
    gs, cser = store.gram(x, slots, prefetch=False), store.combine(coeff, slots, prefetch=False)
    emit({"part": "offload", "n": cs.OFFLOAD_N, "rows": cs.OFFLOAD_ROWS,
          "gram_rel_err": cs.rel_err(torch.as_tensor(g), torch.as_tensor(g64))[1],
          "combine_rel_err": cs.rel_err(c, torch.as_tensor(c64))[1],
          "same_bits": bool(np.array_equal(g, gs) and torch.equal(c, cser)),
          "host_gram_seconds": host_s, "seconds": time.perf_counter() - t0})
    store.close()


def parity() -> None:
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr

    bsr, dense = synthetic_fci_bsr(cs.SPARSE_N, block=cs.SPARSE_BLOCK, density=0.3, seed=1,
                                   dtype=F32, device=CPU)
    for form, off in cs.OFFLOAD_FORMS.items():
        t0 = time.perf_counter()
        solver = cs.parity_solver(CPU, offload=off, dtype=F32)
        conv, _, _ = solver.solve(np.zeros((cs.PARITY_ROOTS, cs.SPARSE_N)),
                                  problem=cs.bsr_problem(bsr), generate_initial_guess=True)
        params, _ = solver.solution(list(range(cs.PARITY_ROOTS)))
        xs = params.double().numpy()
        xs /= np.linalg.norm(xs, axis=1, keepdims=True)
        ax = xs @ dense
        rq = np.sum(xs * ax, axis=1)
        emit({"part": "parity", "store": form, "converged": bool(conv),
              "iterations": solver.stats.iterations, "stats": str(solver.stats),
              "eigenvalues": [float(e) for e in solver.eigenvalues()],
              "f64_max_residual": float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1))),
              "rq_max_abs_err": float(np.max(np.abs(
                  np.sort(rq) - np.asarray(cs.REFERENCE_SPARSE_EIGENVALUES)))),
              "seconds": time.perf_counter() - t0})


def banded(matrix, op) -> None:
    t0 = time.perf_counter()
    ref = np.linalg.eigvalsh(matrix)[:cs.BANDED_ROOTS]
    emit({"part": "banded_reference_eigenvalues", "eigenvalues": ref.tolist(),
          "seconds": time.perf_counter() - t0})
    for case in cs.BANDED_MODES:
        t0 = time.perf_counter()
        solver = cs.banded_solver(matrix, CPU, case, dtype=F32, op=op)
        vals, vecs, errs = solver.solve(cs.BANDED_ROOTS)
        emit({"part": "banded", "case": case, "band": solver.band, "m_max": solver.m_max,
              "tol": solver.tol,
              "runs": solver.runs, "n_locked": solver.n_locked,
              "max_error": float(np.max(errs)), **cs.many_root_quality(vals, vecs, matrix, ref),
              "seconds": time.perf_counter() - t0})


def chebyshev(matrix, op) -> None:
    diag = np.diagonal(matrix)
    matvec, sym = op
    ref = np.asarray(cs.BANDED_REFERENCE_EIGENVALUES[:cs.CHEB_ROOTS])
    t0 = time.perf_counter()
    solver = cs.chebyshev_solver(matvec, sym, diag, cs.CHEB_ROOTS, CPU, dtype=F32,
                                 tol=cs.CHEB_TOL)
    evals, x, errors, iters = solver.run_on_device(cs.guess(diag, cs.CHEB_ROOTS))
    q = cs.many_root_quality(evals, x.double().numpy(), matrix, ref)
    emit({"part": "chebyshev_bench", "iterations": iters, "matvecs": solver.matvecs,
          "max_error": float(np.max(errors)), **q, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    a64, (fmatvec, fsym), w = cs.flat_operator(cs.N, CPU, dtype=F32)
    emit({"part": "flat_operator", "seconds": time.perf_counter() - t0})
    fdiag = torch.diagonal(a64).numpy()
    v0 = cs.guess(fdiag, cs.FLAT_ROOTS)
    for name, make in (("chebyshev", cs.chebyshev_solver), ("jacobi", cs.jacobi_solver)):
        t0 = time.perf_counter()
        solver = make(fmatvec, fsym, fdiag, cs.FLAT_ROOTS, CPU, dtype=F32, tol=cs.FLAT_TOL,
                      max_iter=cs.FLAT_MAX_ITER)
        evals, x, errors, iters = solver.run_on_device(v0)
        xs = x.double()
        xs = xs / torch.linalg.vector_norm(xs, dim=1, keepdim=True)
        ax = xs @ a64
        rq = torch.sum(xs * ax, dim=1)
        emit({"part": f"flat_{name}", "nroots": cs.FLAT_ROOTS, "iterations": iters,
              "matvecs": solver.matvecs, "max_error": float(np.max(errors)),
              "f64_max_residual": float(torch.linalg.vector_norm(
                  ax - rq[:, None] * xs, dim=1).max()),
              "rq_max_abs_err": float(np.abs(np.sort(rq.numpy()) - w[:cs.FLAT_ROOTS]).max()),
              "seconds": time.perf_counter() - t0})


SWEEP_VARIANTS = {"cpu": ("plain", "chain_emulated", "chain_and_k1_emulated"),
                  "cuda": ("kernels", "chain_plain", "dense_matvec", "f64_purge")}


def sweeps(matrix, device) -> None:
    import functools

    from iterative_solver_torch.array.offload_store import StreamedOffloadStore
    from iterative_solver_torch.ops.kernels import chain, symm
    from iterative_solver_torch.solvers import banded as banded_mod
    from iterative_solver_torch.solvers import fused_davidson

    fused_chain, davidson = fused_davidson.fused_expand_chain, banded_mod.FusedDavidson
    for variant in SWEEP_VARIANTS[device.type]:
        matvec, sym = cs.spill_action(matrix, device, dtype=F32)
        store = None
        if variant in ("chain_emulated", "chain_and_k1_emulated"):
            fused_davidson.fused_expand_chain = (
                lambda r, v, mask, diag=None, evals=None, gs_passes=2: chain.expand_chain_emulated(
                    r, v, mask, diag, evals, gs_passes,
                    ctas=chain.chain_ctas(r.shape[0], v.shape[0], r.shape[1], 264)))
            banded_mod.FusedDavidson = functools.partial(davidson, fuse_chain=True)
        if variant == "chain_and_k1_emulated":
            matvec = lambda x, op: symm.square_walk([x], [op.values], op)  # noqa: E731
        if variant == "chain_plain":
            banded_mod.FusedDavidson = functools.partial(davidson, fuse_chain=False)
        if variant == "dense_matvec":
            dense = torch.as_tensor(matrix, dtype=F32, device=device)
            matvec = lambda x, op: x @ dense  # noqa: E731  (the matrix is symmetric)
        if variant == "f64_purge":
            _, band, _, _ = cs.BANDED_MODES["streamed"]
            store = StreamedOffloadStore(max(2 * band, 8), matrix.shape[0],
                                         dtype=torch.float64, name="locked",
                                         block_rows=cs.BANDED_STORE_BLOCK_ROWS, device=device)
        solver = cs.banded_solver(matrix, device, "streamed", dtype=F32, op=(matvec, sym),
                                  store=store)
        check, per_sweep = solver._f64_check, []

        def logged(x, check=check, per_sweep=per_sweep):
            rq, res = check(x)
            per_sweep.append(sorted(float(r) for r in res))
            return rq, res

        solver._f64_check = logged
        t0 = time.perf_counter()
        vals, vecs, _ = solver.solve(cs.BANDED_ROOTS)
        q = cs.many_root_quality(vals, vecs, matrix, cs.BANDED_REFERENCE_EIGENVALUES)
        emit({"part": "sweeps", "device": device.type, "variant": variant,
              "sweeps": len(solver.runs), "runs": solver.runs, "n_locked": solver.n_locked,
              "bar": 10 * solver.tol, "residuals_per_sweep": per_sweep,
              "f64_max_residual": q["f64_max_residual"],
              "rq_max_abs_err": q["rq_max_abs_err"], "seconds": time.perf_counter() - t0})
        fused_davidson.fused_expand_chain, banded_mod.FusedDavidson = fused_chain, davidson
        solver.store.close()


def main(argv) -> int:
    device = CPU
    if argv[:1] == ["--device"]:
        device, argv = torch.device(argv[1]), argv[2:]
    if device.type == "cuda":
        if argv != ["sweeps"]:
            raise SystemExit("only the sweeps part runs on the card")
        sweeps(cs.bench_matrix(cs.N), device)
        return 0
    parts = argv or ["offload", "parity", "banded", "chebyshev"]
    if "offload" in parts:
        offload()
    if "parity" in parts:
        parity()
    if "banded" in parts or "chebyshev" in parts:
        matrix = cs.bench_matrix(cs.N)
        op = cs.spill_action(matrix, CPU, dtype=F32)
        if "banded" in parts:
            banded(matrix, op)
        if "chebyshev" in parts:
            chebyshev(matrix, op)
    if "sweeps" in parts:
        sweeps(cs.bench_matrix(cs.N), CPU)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
