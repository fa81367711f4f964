#!/usr/bin/env python3
"""Time the packed actions (K1, K3), the expand chain (K2), the int8
actions (K4, K5), the block-sparse action (K6), the masked Gram (K7) and
PPCG's per-root Rayleigh-Ritz (K8) of one source tree on a CUDA card, so
that two trees can be compared in one run.

    python3 compare_kernels.py <tree> <tag> [k1] [k2] [k4] [k5] [k6] [k7] [k8]

``<tree>`` is the root of a checkout (this one, or another commit unpacked
with ``git archive`` into a directory under ``build/``); its
``iterative_solver_torch`` and ``chip_smoke.py`` are imported, and its
kernels are built into its own ``build/torch_kernels/``. Run two trees in
turns in one session (parent, change, change, parent): times of one card
spread by several percent between processes.

Shapes are ``chip_smoke.py``'s: K1 (bf16 tiles of 1024, f32 tiles of 512)
and K3 (split, tiles of 512) at 16 x 8192 and 1 x 8192 on the bench matrix
and at 16 x 32768 on ``packed_on_card`` operators (``k1`` selects all three
kernels); K2 with 16 rows and a 64-row basis (48
active) at n = 8192 and n = 2^20 (a diagonal of linspace(-2, 50, n), Ritz
values just below its lowest entries); K4 and K5 at 16 x 8192 on the bench
matrix in tiles of 1024; K6 on bench.py's sparse operator (n = 8192, block
128) at 16 and 4 rows and on the phenol-scale operator (n = 2^20) at 16
rows; K7 at 64 x 8192 and 64 x 2^20 with 40 active rows. For each it
prints and writes to ``chiprun_out/compare_<tag>.json``: the relative error
against the plain version (K2 also against float64; K4 and K5 must equal
it), whether a second call gives the same bits, the CUDA-event time per
call over back-to-back calls, the device time per call of the kernels the
wrapper launches (K4, K5: the products kernel and its epilogue) and their
number, from torch.profiler over 20 calls, and library yardsticks in both
times (K4, K5: ``torch._int_mm`` per int8 product on the dense matrix the
tiles imply, x padded to 32 rows; K7: the bare ``v @ w.T``). K8 at 64 x
131072 and 8 x 2048 (unit rows, a diagonal action, every direction live):
its two kernels (each kernel's device time apart too) beside the byte
bound, the eager chain (row dots, ``_rr3_coeffs``, the update), the same
chain with ``_rr3_coeffs`` replayed from one CUDA graph, and K8's dots
kernel alone before that graph; whether the coefficients and blocks equal
the eager chain's given the kernel's dots. Also the card's name and power
limit and the compiler's register report.
"""

import json
import os
import subprocess
import sys
import time


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    which = set(sys.argv[3:]) or {"k1", "k2", "k4", "k5", "k6", "k7", "k8"}
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from iterative_solver_torch.ops.kernels import _build, chain, gram, spmv, symm, symm_int8

    if not cs.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cs.__file__}, not the tree {root}")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    sources = {"k1": "symm_packed", "k2": "chain", "k4": "symm_int8", "k5": "symm_int8", "k6": "spmv",
               "k7": "gram", "k8": "rr3"}
    logs = _build.build(sorted({sources[k] for k in which}))
    out = {"tag": tag, "root": root, "card": card.strip(), "build_s": time.perf_counter() - t0,
           "ptxas": [ln.strip() for log in logs.values() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=dev)

    def timed(fn, pattern, per_call):
        ms, _, seen = cs.device_ms(fn, dev, pattern, per_call, calls=20)
        return {"event_ms": cs.time_ms(fn, dev), "device_ms": ms, "kernels_per_call": seen}

    if "k1" in which:
        matrix = cs.bench_matrix(8192)
        for name, kind, b, _ in cs.SYMM_CASES:
            for m, n in ((16, 8192), (1, 8192), (16, cs.FLAGSHIP_N)):
                if n == 8192 and kind == "split":
                    sym = symm.SymmetricBlockedSplit.from_dense(matrix, b=b, device=dev)
                elif n == 8192:
                    sym = symm.SymmetricBlocked.from_dense(
                        matrix, b=b, device=dev,
                        dtype=torch.bfloat16 if kind == "bf16" else torch.float32)
                else:
                    sym = cs.packed_on_card(n, b, kind, dev, seed=m)
                split = kind == "split"
                kernel = symm.symm_matmat_split_kernel if split else symm.symm_matmat_kernel
                plain = symm.symm_matmat_split if split else symm.symm_matmat
                x = torch.as_tensor(rng.standard_normal((m, n)), **f32)
                fn = lambda: kernel(x, sym)  # noqa: E731
                y = fn()
                out[f"{name}@{m}x{n}"] = {"rel": cs.rel_err(y, plain(x, sym))[1],
                                          "same_bits": bool(torch.equal(fn(), y)),
                                          **timed(fn, "symm_packed", None)}
                del sym, x, y
                torch.cuda.empty_cache()
        del matrix
    if "k2" in which:
        for name, n in (("K2", 8192), ("K2@2^20", 1 << 20)):
            r = torch.as_tensor(rng.standard_normal((16, n)), **f32)
            q, _ = torch.linalg.qr(torch.randn((n, 64), generator=torch.Generator(
                device=dev).manual_seed(5), device=dev))
            mask = (torch.arange(64, device=dev) < 48).to(torch.float32)
            v = (q.T * mask[:, None]).contiguous()
            d = torch.as_tensor(np.linspace(-2.0, 50.0, n), **f32)
            ev = torch.as_tensor(np.linspace(-2.0001, -1.5, 16), **f32)
            fn = lambda: chain.fused_expand_chain(r, v, mask, d, ev)  # noqa: E731
            got = fn()
            ref = chain.expand_chain(r, v, mask, d, ev)
            ref64 = chain.expand_chain(*(a.double() for a in (r, v, mask, d, ev)))
            out[name] = {"rel": max(cs.rel_err(a, b)[1] for a, b in zip(got, ref)),
                         "rel_f64": [cs.rel_err(a, b)[1] for a, b in zip(got, ref64)],
                         "same_bits": all(torch.equal(a, b) for a, b in zip(fn(), got)),
                         **timed(fn, "chain", None)}
            del r, q, v, got, ref, ref64
        torch.cuda.empty_cache()
    if which & {"k4", "k5"}:
        matrix = cs.bench_matrix(8192)
        x = torch.as_tensor(rng.standard_normal((16, 8192)), **f32)
        cases = [("K4@n8192", symm_int8.SymmetricBlockedInt8, symm_int8.symm_matmat_int8_kernel,
                  symm_int8.symm_matmat_int8, "k4"),
                 ("K5", symm_int8.SymmetricBlockedInt8Split,
                  symm_int8.symm_matmat_int8_split_kernel, symm_int8.symm_matmat_int8_split,
                  "k5")]
        for name, cls, kernel, plain, key in cases:
            if key not in which:
                continue
            sym = cls.from_dense(matrix, b=1024, device=dev)
            fn = lambda: kernel(x, sym)  # noqa: E731
            y = fn()
            if key == "k4":
                planes = (sym.q,)
                xs = symm_int8.quantize_rows(x * sym.gq[None, :])[:1]
                products = ((0, 0),)
            else:
                planes = (sym.q1, sym.q2)
                xs = symm_int8.quantize_rows_split(x * sym.gq[None, :])[:2]
                products = ((0, 0), (0, 1), (1, 0))
            dense = [cs.dense_from_tiles(p, sym.ii, sym.jj, sym.b, 8192) for p in planes]
            padded = []
            for xp in xs:
                pad = torch.zeros((32, 8192), dtype=torch.int8, device=dev)
                pad[:16] = xp
                padded.append(pad)
            lib = lambda: [torch._int_mm(padded[a], dense[k]) for a, k in products]  # noqa: E731
            out[name] = {"equal": bool(torch.equal(y, plain(x, sym))),
                         "same_bits": bool(torch.equal(fn(), y)),
                         **timed(fn, "symm_int8", 2),
                         "library_event_ms": cs.time_ms(lib, dev),
                         "library_device_ms": cs.device_ms(lib, dev, "", None)[0]}
            del sym, dense, padded
        del matrix
        torch.cuda.empty_cache()
    if "k6" in which:
        bench, _, _ = cs.make_bench_bsr(dev)
        phenol, _, _ = cs.phenol_operator(dev)
        for name, bsr, m in (("K6", bench, 16), ("K6@m4", bench, 4),
                             ("K6@phenol", phenol, 16)):
            x = torch.as_tensor(rng.standard_normal((m, bsr.shape[1])), **f32)
            fn = lambda: spmv.bsr_matmat_kernel(x, bsr)  # noqa: E731
            y = fn()
            _, rel = cs.rel_err(y, spmv.bsr_matmat(x, bsr))
            out[name] = {"rel": rel, "same_bits": bool(torch.equal(fn(), y)),
                         "event_ms": cs.time_ms(fn, dev),
                         "device_ms": cs.device_ms(fn, dev, "bsr_kernel", None, calls=20)[0]}
            del x, y
        del bench, phenol
        torch.cuda.empty_cache()
    if "k7" in which:
        for name, n in (("K7", 8192), ("K7@2^20", 1 << 20)):
            v = torch.as_tensor(rng.standard_normal((64, n)) / np.sqrt(n), **f32)
            d = torch.as_tensor(np.linspace(-2.0, 50.0, n), **f32)
            w = v * d[None, :]
            mask = (torch.arange(64, device=dev) < 40).to(torch.float32)
            fn = lambda: gram.masked_gram_kernel(v, w, mask)  # noqa: E731
            h = fn()
            _, rel = cs.rel_err(h, gram.masked_gram(v, w, mask))
            lib = lambda: torch.matmul(v, w.T)  # noqa: E731
            out[name] = {"rel": rel, "same_bits": bool(torch.equal(fn(), h)),
                         "event_ms": cs.time_ms(fn, dev),
                         "device_ms": cs.device_ms(fn, dev, "gram", None, calls=20)[0],
                         "library_ms": cs.time_ms(lib, dev),
                         "library_device_ms": cs.device_ms(lib, dev, "", None)[0]}
    if "k8" in which:
        from iterative_solver_torch.ops.kernels import rr3
        from iterative_solver_torch.solvers import fused_ppcg as fp

        for name, r, n in (("K8", 64, 131072), ("K8@8x2048", 8, 2048)):
            d = torch.linspace(-2.0, 50.0, n, **f32)
            x, w, p = (v / torch.linalg.norm(v, dim=1, keepdim=True) for v in (
                torch.as_tensor(rng.standard_normal((r, n)), **f32) for _ in range(3)))
            blocks = (x, x * d, w, w * d, p, p * d)
            live = torch.ones(r, dtype=torch.bool, device=dev)
            # the step's former form: _rr3_coeffs captured once in a CUDA graph
            dots_in = fp._rr3_dots(*blocks)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fp._rr3_coeffs(dots_in, live, live, r)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                c_out = fp._rr3_coeffs(dots_in, live, live, r)

            def graphed(dots):
                dots_in.copy_(dots)
                graph.replay()
                return rr3.rr3_update_plain(c_out, *blocks)

            kernels = lambda: rr3.rr3_update(rr3.rr3_dots(*blocks), live, live, *blocks)  # noqa: E731
            eager = lambda: rr3.rr3_update_plain(  # noqa: E731
                fp._rr3_coeffs(fp._rr3_dots(*blocks), live, live, r), *blocks)
            graph_chain = lambda: graphed(fp._rr3_dots(*blocks))  # noqa: E731
            dots_only = lambda: graphed(rr3.rr3_dots(*blocks))  # noqa: E731
            dots = rr3.rr3_dots(*blocks)
            *new, c = rr3.rr3_update(dots, live, live, *blocks)
            ref_c = fp._rr3_coeffs(dots, live, live, r)
            ref = rr3.rr3_update_plain(ref_c, *blocks)
            byte = 4 * r * n / 3.35e9
            out[name] = {
                "same_bits_given_dots": bool(torch.equal(c, ref_c)) and all(
                    torch.equal(a, b) for a, b in zip(new, ref)),
                "dots_repeat": bool(torch.equal(rr3.rr3_dots(*blocks), dots)),
                "dots_rel": cs.rel_err(dots, fp._rr3_dots(*blocks))[1],
                "bound_ms": 16 * byte, "dots_bound_ms": 6 * byte, "update_bound_ms": 10 * byte,
                **timed(kernels, "rr3_", 2),
                "dots_device_ms": cs.device_ms(kernels, dev, "rr3_dots", 1, calls=20)[0],
                "update_device_ms": cs.device_ms(kernels, dev, "rr3_update", 1, calls=20)[0],
                "eager_event_ms": cs.time_ms(eager, dev),
                "eager_device_ms": cs.device_ms(eager, dev, "", None)[0],
                "graph_event_ms": cs.time_ms(graph_chain, dev),
                "graph_device_ms": cs.device_ms(graph_chain, dev, "", None)[0],
                "dots_only_event_ms": cs.time_ms(dots_only, dev),
                "dots_only_device_ms": cs.device_ms(dots_only, dev, "", None)[0]}
            del graph, blocks, x, w, p, new, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/compare_{tag}.json", "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
