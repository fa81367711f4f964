#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's examples phase.

    python3 calibrate_examples_cpu.py [twin ...]

Runs each twin of examples_torch/ through its ``main`` with
``--device cpu`` at the arguments the smoke gives it on the card
(``chip_smoke.EXAMPLES``), where the kernel wrappers take their plain
versions, and the twin notebook's cells with ``EXAMPLES_DEVICE=cpu``; prints
one JSON line per twin with its iteration counts (``chip_smoke.example_counts``)
and seconds, then the ``EXAMPLE_CPU_ITERATIONS`` table that chip_smoke.py
holds the card's counts to. With twin names, only those run.

This script imports no JAX and needs no card. The n = 8192 twins hold a
few GB of host memory; all of it takes several minutes, most of them
quantized_screening's int8_precise polish at n = 8192.
"""

from __future__ import annotations

import json
import os
import sys
import time

import chip_smoke
from examples_torch import _cli


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(names) -> None:
    table = {}
    os.environ["EXAMPLES_DEVICE"] = "cpu"
    for name, argv in chip_smoke.EXAMPLES + (("OptimizeExample", None),):
        if names and name not in names:
            continue
        t0 = time.perf_counter()
        out = (_cli.run_notebook(os.path.join(chip_smoke.EXAMPLES_DIR,
                                              chip_smoke.EXAMPLE_NOTEBOOK))
               if argv is None
               else chip_smoke.twin_main(name, ["--device", "cpu", *argv])[0])
        table[name] = chip_smoke.example_counts(out)
        emit({"twin": name, "argv": argv, "seconds": time.perf_counter() - t0,
              "iterations": table[name]})
    emit({"EXAMPLE_CPU_ITERATIONS": table})


if __name__ == "__main__":
    main(sys.argv[1:])
