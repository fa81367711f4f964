"""The readings that the limits of ``correct`` are set from: the numbers
that ``harness.judge`` compares, for the program on many seeds and for the
control on a few, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

The program's reading of a seed is the solve after a warm one, as the
window runs it. The control is the configuration's plain reference put in
the program's place: the same solver family over the reference's action,
computed in the configuration's ``control`` precision, the nearest below
the one it states (``action``: the operator's action's; ``tf32``: the
solver's own float32 products in TensorFloat-32). One JSON line a
reading; the last line gives the largest program reading and the smallest
control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402


def program_reading(cell, seed: int, device) -> dict:
    """The numbers of one seed's solve through the port, as a window's."""
    op_mod = harness.plugin("operators", cell.cfg["operator"])
    fam = harness.plugin("families", cell.traffic["family"])
    op = op_mod.build(op_mod.generate(cell.cfg, seed, device), cell.cfg, device)
    solver = fam.build(op, cell.traffic, device)
    v0 = fam.guess(op.diag, cell.traffic)
    fam.solve(solver, v0)
    t0 = time.perf_counter()
    ev, x, err, it = fam.solve(solver, v0)
    harness.sync(device)
    wall = time.perf_counter() - t0
    del solver, op
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = harness.judge(cell, seed, device, [np.sort(ev)], [(ev, x)])
    return {"side": "program", "seed": seed, "iterations": int(it), "max_error": float(max(err)),
            "solve_s": wall, **numbers}


def control_reading(cell, seed: int, device) -> dict:
    """The numbers of one seed's solve with the reference's action in the
    configuration's control precision in the program's place."""
    op_mod = harness.plugin("operators", cell.cfg["operator"])
    ref = harness.plugin("reference", cell.cfg["operator"])
    fam = harness.plugin("families", cell.traffic["family"])
    control = cell.cfg["control"]
    gen = op_mod.generate(cell.cfg, seed, device)

    def matvec(x, operand):
        return ref.action(gen, x, precision=control["action"]).to(x.dtype)

    n = gen["sizes"]["n"]
    op = SimpleNamespace(matvec=matvec, operand=None, n=n, diag=gen["diag"].cpu().numpy())
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control["tf32"]
    try:
        solver = fam.build(op, cell.traffic, device)
        ev, x, err, it = fam.solve(solver, fam.guess(op.diag, cell.traffic))
        harness.sync(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    numbers = harness.judge(cell, seed, device, [np.sort(ev)], [(ev, x)], gen=gen)
    return {"side": "control", **control, "seed": seed, "iterations": int(it),
            "max_error": float(max(err)), **numbers}


def summary(readings: list) -> dict:
    out = {}
    for k in harness.NUMBERS:
        prog = [r[k] for r in readings if r["side"] == "program"]
        ctrl = [r[k] for r in readings if r["side"] == "control"]
        out[k] = {"program_max": max(prog) if prog else None,
                  "control_min": min(ctrl) if ctrl else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    readings = []
    for side, seeds, fn in (("program", args.seeds, program_reading),
                            ("control", args.control_seeds, control_reading)):
        for s in filter(None, seeds.split(",")):
            r = fn(cell, int(s), device)
            readings.append(r)
            print(json.dumps(r), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "summary": summary(readings)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
