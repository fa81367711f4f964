"""Run one cell of the port's benchmark once, on the CUDA card of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and window
seconds. Every run checks the solves of its window against the plain
reference; the numbers compared, each beside its limit, come last on
standard error and under ``checks`` in the result. Without a CUDA card it
exits with code 2 and prints no result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def log(obj) -> None:
    print(json.dumps({"portbench": obj}), flush=True)


def card_info() -> dict:
    """The card's name, power limit and top SM clock, as nvidia-smi reads
    them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return {"nvidia_smi": out.stdout.strip() or out.stderr.strip()}
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc!r}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    # one host thread: the solves' host work spreads less with the load of
    # the machine's other tenants
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, START,
                              log=log)
    log(card_info())
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
