#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py    # build, check, solve, profile; about a minute

It drives the port's main path, ``FusedDavidson.from_dense_symmetric`` then
``run_on_device``, at the size of bench.py's headline leg: a dense symmetric
8192 x 8192 operator (the bench matrix: spectrum linspace(-2, 3, 32) and
linspace(6, 50, N-32), couplings 0.05/sqrt(N), ``default_rng(0)``), 16
roots, a 64-row basis. It imports nothing of JAX or of the JAX package.

Phases, one JSON line each:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. the build of every kernel from ``iterative_solver_torch/ops/kernels/csrc``
   with nvcc for sm_90a, all sources compiled in parallel;
3. every kernel (K1 with bf16 and with f32 tiles, K2, K3) against its plain
   PyTorch version on the same inputs on the card, at the main path's
   shapes (x 16 x 8192; K2 with a 64-row basis). Tolerance: 1e-5 of the
   plain result's max magnitude; the kernels add partial sums with f32
   atomics, which changes the order of the sum. Times from CUDA events,
   kernel and plain timed in turns (plain, kernel, kernel, plain);
4. the headline solve: tier "fast", rr "window", fused chain, tol 2e-4;
5. the "precise" solve: rr "full", tol 1e-5 (bench.py's precise leg);
6. the "exact" solve, same settings as 5, which drives K1's f32 tiles;
7. a torch.profiler breakdown of one more headline solve: device time by
   kernel family and the device's idle share.

Each solve reports iterations, convergence, time per iteration, the f64
residual ||A x - rho x|| of each normalised Ritz vector against the dense
f64 matrix, the 4 lowest Rayleigh quotients against REFERENCE_EIGENVALUES,
and the launches of each kernel wrapper counted during the solve, which
must equal init + symmetry probe + iterations + restarts (K2: iterations).

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error, times and bound; the card's nvidia-smi line; and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that last line. It also exits non-zero
where CUDA is absent, and where the package beside it is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 8192
NROOTS = 16
M_MAX = 64
# lowest-4 eigenvalues of the benchmark matrix, np.linalg.eigvalsh in f64
# (the constant of bench.py)
REFERENCE_EIGENVALUES = [
    -2.0000867851589925, -1.8397575604176952, -1.6784299270313459, -1.5176359291753378,
]
KERNEL_TOL = 1e-5

# H100 SXM data-sheet peaks (dense): memory 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bench_matrix(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


def guess(diag: np.ndarray, nroots: int) -> np.ndarray:
    v0 = np.zeros((nroots, diag.shape[0]))
    for row, i in enumerate(np.argsort(diag)[:nroots]):
        v0[row, i] = 1.0
    return v0


def time_ms(fn, device, reps: int = 20) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, device):
    """(kernel_ms, plain_ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, device)
    k1 = time_ms(kernel, device)
    k2 = time_ms(kernel, device)
    p2 = time_ms(plain, device)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got, ref) -> tuple:
    got = got.double()
    ref = ref.double()
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-300)


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def symm_flops(sym, m: int, products: int) -> float:
    """2 flop per multiply-add: each tile gives m x b x b products per
    contribution, two contributions off the diagonal, one on it."""
    ii = sym.ii.cpu().numpy()
    jj = sym.jj.cpu().numpy()
    contributions = 2 * int(np.sum(ii != jj)) + int(np.sum(ii == jj))
    return 2.0 * products * m * sym.b * sym.b * contributions


def check_kernels(matrix: np.ndarray, device) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from iterative_solver_torch.ops.kernels import chain, symm

    n = matrix.shape[0]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((NROOTS, n)), dtype=torch.float32, device=device)
    dense32 = torch.as_tensor(matrix, dtype=torch.float32, device=device)
    io_bytes = 2 * x.numel() * 4  # x read, y written
    results = []

    def symm_case(name, sym, kernel, plain, tile_bytes, products, kind, lib_dtype, replaces):
        y = kernel(x, sym)
        y_ref = plain(x, sym)
        torch.cuda.synchronize(device)
        abs_err, rel = rel_err(y, y_ref)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: max relative error {rel:.3e} > {KERNEL_TOL}")
        kernel_ms, plain_ms = in_turns(lambda: plain(x, sym), lambda: kernel(x, sym), device)
        a_lib = dense32.to(lib_dtype)
        x_lib = x.to(lib_dtype)
        library_ms = time_ms(lambda: torch.matmul(x_lib, a_lib), device)
        del a_lib
        nbytes = tile_bytes + 8 * sym.n_pairs + io_bytes
        bound_ms, bound_by = bound(nbytes, symm_flops(sym, NROOTS, products), kind)
        results.append({
            "name": name, "route": "cuda",
            "source": "iterative_solver_torch/ops/kernels/csrc/symm_packed.cu",
            "replaces": replaces, "max_abs_err": abs_err, "max_rel_err": rel,
            "tolerance": KERNEL_TOL, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shapes": {"m": NROOTS, "n": n, "b": sym.b, "n_pairs": sym.n_pairs},
        })

    k1 = "iterative_solver_tpu/ops/kernels/symm_pallas.py:148"
    sym = symm.SymmetricBlocked.from_dense(matrix, b=1024, dtype=torch.bfloat16, device=device)
    symm_case("K1-bf16", sym, symm.symm_matmat_kernel, symm.symm_matmat,
              sym.values.numel() * 2, 1, "bf16", torch.bfloat16, k1)
    del sym
    sym = symm.SymmetricBlocked.from_dense(matrix, b=512, dtype=torch.float32, device=device)
    symm_case("K1-f32", sym, symm.symm_matmat_kernel, symm.symm_matmat,
              sym.values.numel() * 4, 1, "f32", torch.float32, k1)
    del sym
    sym = symm.SymmetricBlockedSplit.from_dense(matrix, b=512, device=device)
    symm_case("K3", sym, symm.symm_matmat_split_kernel, symm.symm_matmat_split,
              sym.hi.numel() * 4, 3, "bf16", torch.bfloat16,
              "iterative_solver_tpu/ops/kernels/symm_pallas.py:325")
    del sym, dense32

    # K2 at the step's shapes: residuals, a basis stack filled to 48 of 64
    # rows (dead rows hold zeros, as in the solver), the operator diagonal,
    # and Ritz values near the lowest diagonal entries
    r = x
    q, _ = torch.linalg.qr(torch.as_tensor(rng.standard_normal((n, M_MAX)),
                                           dtype=torch.float32, device=device))
    mask = torch.zeros(M_MAX, dtype=torch.float32, device=device)
    mask[:48] = 1.0
    v = (q.T * mask[:, None]).contiguous()
    diag = torch.as_tensor(np.diagonal(matrix).copy(), dtype=torch.float32, device=device)
    evals = torch.as_tensor(np.linspace(-2.0001, -1.5, NROOTS), dtype=torch.float32,
                            device=device)
    got = chain.fused_expand_chain(r, v, mask, diag, evals)
    ref = chain.expand_chain(r, v, mask, diag, evals)
    torch.cuda.synchronize(device)
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    rel = max(e[1] for e in errs)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"K2: max relative error {rel:.3e} > {KERNEL_TOL} "
                             f"(t, n0, n2, g: {[e[1] for e in errs]})")
    kernel_ms, plain_ms = in_turns(lambda: chain.expand_chain(r, v, mask, diag, evals),
                                   lambda: chain.fused_expand_chain(r, v, mask, diag, evals),
                                   device)
    rn = NROOTS * n
    nbytes = 4 * (2 * rn + M_MAX * n + M_MAX + n + NROOTS + 2 * NROOTS + NROOTS * NROOTS)
    # Jacobi (3), n0 (2), two GS passes (2 x 2 x 2 x M), n2 (2), g (2 R)
    flops = rn * (3 + 2 + 8 * M_MAX + 2 + 2 * NROOTS)
    bound_ms, bound_by = bound(nbytes, flops, "f32")
    results.append({
        "name": "K2", "route": "cuda",
        "source": "iterative_solver_torch/ops/kernels/csrc/chain.cu",
        "replaces": "iterative_solver_tpu/ops/kernels/chain_pallas.py:94",
        "max_abs_err": max(e[0] for e in errs), "max_rel_err": rel,
        "tolerance": KERNEL_TOL, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "shapes": {"r": NROOTS, "m_max": M_MAX, "n": n, "active": 48},
    })
    return results


def expected_restarts(iters: int, nroots: int, m_max: int) -> int:
    k, restarts = nroots, 0
    for _ in range(iters):
        if k + nroots > m_max:
            k, restarts = nroots, restarts + 1
        k += nroots
    return restarts


def solve_phase(matrix, ref_evals, device, tier, rr, tol, res_limit, rq_limit,
                action_key) -> dict:
    """One solve through the public entry points; raises on a failed check.
    Returns the phase record with the launches counted during the solve."""
    import torch

    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.ops.kernels import chain, symm

    diag = np.diagonal(matrix)
    t0 = time.perf_counter()
    solver = FusedDavidson.from_dense_symmetric(
        matrix, NROOTS, tier=tier, m_max=M_MAX, rr=rr,
        convergence_threshold=tol, max_iter=60)
    setup_s = time.perf_counter() - t0
    v0 = guess(diag, NROOTS)

    for d in (symm.LAUNCHES, chain.LAUNCHES):
        for key in d:
            d[key] = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"action": symm.LAUNCHES[action_key], "chain": chain.LAUNCHES["chain"]}

    # a second solve from the same guess (no symmetry probe): steady time
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _, _, _, iters2 = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall2 = time.perf_counter() - t0

    restarts = expected_restarts(iters, NROOTS, M_MAX)
    expected = {"action": 1 + 2 + iters + restarts, "chain": iters}
    converged = bool(np.max(errors) <= tol)

    xs = x.detach().to("cpu", torch.float64).numpy()[:, : matrix.shape[0]]
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ matrix  # matrix is symmetric
    rq = np.sum(xs * ax, axis=1)
    res = float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1)))
    rq_low = np.sort(rq)[: len(ref_evals)]
    rq_err = float(np.max(np.abs(rq_low - np.asarray(ref_evals))))

    rec = {
        "phase": f"solve_{tier}", "tier": tier, "rr": rr, "n": matrix.shape[0],
        "nroots": NROOTS, "m_max": M_MAX, "tol": tol, "fuse_chain": solver.fuse_chain,
        "iterations": iters, "restarts": restarts, "converged": converged,
        "max_error": float(np.max(errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1),
        "steady_seconds": wall2, "steady_seconds_per_iteration": wall2 / max(iters2, 1),
        "setup_seconds": setup_s,
        "f64_max_residual": res, "f64_residual_limit": res_limit,
        "rayleigh_quotients": rq_low.tolist(), "rq_max_abs_err": rq_err,
        "rq_limit": rq_limit, "launches": launches, "expected_launches": expected,
        "action_kernel": action_key,
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    if not res <= res_limit:
        failures.append(f"f64 residual {res:.3e} > {res_limit}")
    if not rq_err <= rq_limit:
        failures.append(f"Rayleigh quotients off by {rq_err:.3e} > {rq_limit}")
    if launches != expected or min(launches.values()) == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError(f"solve_{tier}: " + "; ".join(failures))
    return rec


def profile_headline(matrix, device) -> dict:
    """Device time by kernel family, and the host's waits on the device, over
    one headline solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iterative_solver_torch import FusedDavidson

    solver = FusedDavidson.from_dense_symmetric(
        matrix, NROOTS, tier="fast", m_max=M_MAX, rr="window",
        convergence_threshold=2e-4, max_iter=60)
    v0 = guess(np.diagonal(matrix), NROOTS)
    solver.run_on_device(v0)  # warm: probe, library handles
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, iters = solver.run_on_device(v0)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    families = {"K1 symm_packed": ("symm_packed",), "K2 chain": ("chain_",),
                "eigh, cholesky, trsm (cuSOLVER)": (
                    "syev", "sytrd", "ormtr", "stedc", "steqr", "orgtr", "lansy",
                    "potrf", "getrf", "trsm", "trsv", "row_rotate", "cusolver", "magma"),
                "gemm, gemv (cuBLAS)": ("gemm", "gemv", "xmma", "cutlass", "sm90",
                                        "splitkreduce"),
                "memcpy": ("memcpy",),
                "elementwise, reductions (PyTorch)": ("at::native",),
                }
    by_family = {k: 0.0 for k in families}
    by_family["other"] = 0.0
    top = []
    # host-side waits on the device: scalar reads (the convergence test,
    # cuSOLVER's info checks) and the copies behind them
    sync_names = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                  "cudaDeviceSynchronize", "cudaMemcpyAsync")
    syncs = {}
    for ev in prof.key_averages():
        if ev.key in sync_names:
            syncs[ev.key] = {"count": ev.count, "cpu_ms": ev.self_cpu_time_total / 1e3}
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if not dev_us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        fam = next((k for k, pats in families.items()
                    if any(p in name.lower() for p in pats)), "other")
        by_family[fam] += dev_us / 1e3
        top.append((dev_us / 1e3, ev.count, name[:80]))
    top.sort(reverse=True)
    busy = sum(by_family.values())
    if not busy > 0:
        raise AssertionError("the profiler recorded no device time")
    return {
        "phase": "profile_fast", "iterations": iters, "wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (wall * 1e3),
        "ms_by_family": by_family, "host_syncs": syncs,
        "top_kernels": [{"ms": t, "count": c, "name": nm} for t, c, nm in top[:12]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from iterative_solver_torch.ops.kernels import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SOURCES), "built": sorted(logs), "ptxas": ptxas})

    matrix = bench_matrix(N)
    kernels = check_kernels(matrix, device)
    emit({"phase": "kernel_checks", "kernels": kernels})

    fast = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "fast", "window",
                       2e-4, 1e-3, 1e-5, "symm_bf16")
    precise = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "precise", "full",
                          1e-5, 1e-4, 1e-8, "symm_split")
    exact = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "exact", "full",
                        1e-5, 1e-4, 1e-8, "symm_f32")
    emit(profile_headline(matrix, device))

    launches = {
        "K1-bf16": fast["launches"]["action"],
        "K1-f32": exact["launches"]["action"],
        "K3": precise["launches"]["action"],
        "K2": sum(p["launches"]["chain"] for p in (fast, precise, exact)),
    }
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = []
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
        line.append({key: k[key] for key in keys})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
