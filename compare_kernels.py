#!/usr/bin/env python3
"""Time the block-sparse action (K6) and the masked Gram (K7) of one source
tree on a CUDA card, so that two trees can be compared in one run.

    python3 compare_kernels.py <tree> <tag> [k6] [k7]

``<tree>`` is the root of a checkout (this one, or another commit unpacked
with ``git archive`` into a directory under ``build/``); its
``iterative_solver_torch`` and ``chip_smoke.py`` are imported, and its
kernels are built into its own ``build/torch_kernels/``. Run two trees in
turns in one session (parent, change, change, parent): times of one card
spread by several percent between processes.

Shapes are ``chip_smoke.py``'s: K6 on bench.py's sparse operator
(n = 8192, block 128) at 16 and 4 rows and on the phenol-scale operator
(n = 2^20) at 16 rows; K7 at 64 x 8192 and 64 x 2^20 with 40 active rows.
For each it prints and writes to ``chiprun_out/compare_<tag>.json``: the
relative error against the plain version, whether a second call gives the
same bits, the CUDA-event time per call over back-to-back calls, the
kernel's device time per call from torch.profiler, and for K7 the bare
``v @ w.T`` in both. Also the card's name and power limit and the
compiler's register report.
"""

import json
import os
import subprocess
import sys
import time


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    which = set(sys.argv[3:]) or {"k6", "k7"}
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from iterative_solver_torch.ops.kernels import _build, gram, spmv

    if not cs.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cs.__file__}, not the tree {root}")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    logs = _build.build(["spmv", "gram"])
    out = {"tag": tag, "root": root, "card": card.strip(), "build_s": time.perf_counter() - t0,
           "ptxas": [ln.strip() for log in logs.values() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=dev)
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
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/compare_{tag}.json", "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
