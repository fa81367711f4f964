"""One run of one cell: set-up, the timed window, the traced segment and
the check that decides ``correct``.

Everything is found by name. ``BENCHMARK.json`` maps the cell to its
configuration file and its traffic; the configuration names its operator
kind, and the traffic its solver family; each metric is a reader of its
own. So a cell, a configuration or a metric is added as files:

- ``configs/<config>.json``: the deployment, with ``operator`` naming
  ``operators/<kind>.py`` (generation on the card, the port's operand, the
  bytes and operations of one action) and ``reference/<kind>.py`` (its
  plain action);
- ``traffic/<traffic>.json``: the solves, with ``family`` naming
  ``families/<family>.py`` (build a solver, the guess, one solve);
- ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: ``read(run)``, the metric from the run's
  record, or ``None`` where the record holds nothing to read.

The window is a closed loop with one client: solves back to back on the
solver built once in set-up, until the seconds have passed; the solve
running then completes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import measure
from .reference import eigen

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# top-level module names that no run may hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "iterative_solver_tpu")
# solves of the window whose eigenvectors the check reads, drawn from the seed
KEPT = 3
# solves traced in the profiled segment, and the windows taken at most
# where the profiler drops device events
TRACED_SOLVES = 5
TRACE_ATTEMPTS = 8
ACTION_REPS = 20
ANNOTATION = "portbench.traced_solves"
# the numbers compared with the reference, each against its limit
NUMBERS = ("eig_gap", "residual", "orthonormality")


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic, limits and metrics; raises KeyError for an unknown cell and
    ValueError for a traffic key that its family does not read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in spec["workloads"]}[name]
    cfg_file = {c["name"]: c["file"] for c in spec["configs"]}[wl["config"]]
    cfg = json.loads((root / cfg_file).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{wl['traffic']}.json").read_text())
    check_traffic(wl["traffic"], traffic)
    limits = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())["limits"]

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name, wl["chips"], cfg, traffic, limits, [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def check_traffic(name: str, traffic: dict) -> None:
    """Refuse a traffic mix with a key that its family does not read: a
    setting that the harness would silently leave out of the run."""
    unknown = set(traffic) - {"family", *plugin("families", traffic["family"]).KEYS}
    if unknown:
        raise ValueError(f"traffic {name!r}: keys that the {traffic['family']!r} family "
                         f"does not read: {sorted(unknown)}")


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded from its
    file (a metric's name may hold dots and dashes)."""
    modname = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def action_rows(n: int, rows: int, seed: int, device) -> torch.Tensor:
    """Unit rows of normal draws from the seed, float32, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device=device)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def run_window(fam, solver, v0, seconds: float, tol: float, seed: int, device, log) -> dict:
    """Solves back to back until ``seconds`` have passed, each timed on the
    host clock to its synchronise. Keeps every solve's sorted eigenvalues
    and iteration count, and the eigenpairs of ``KEPT`` solves drawn from
    the seed (a reservoir). A solve that raises or ends above ``tol``
    counts as failed."""
    rng = random.Random(seed)
    times, iterations, evals, kept = [], [], [], []
    failed = 0
    t_first = time.perf_counter()
    deadline = t_first + seconds
    while True:
        t0 = time.perf_counter()
        try:
            ev, x, err, it = fam.solve(solver, v0)
            sync(device)
        except (RuntimeError, ValueError) as exc:
            ev = None
            if not failed:
                log({"solve_failed": repr(exc)[:500]})
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if ev is None:
            failed += 1
        else:
            if not float(np.max(err)) <= tol:
                failed += 1
            iterations.append(int(it))
            evals.append(np.sort(np.asarray(ev, dtype=np.float64)))
            pair = (np.asarray(ev, dtype=np.float64), x)
            i = len(evals) - 1
            if i < KEPT:
                kept.append(pair)
            else:
                j = rng.randrange(i + 1)
                if j < KEPT:
                    kept[j] = pair
        if t1 >= deadline:
            break
    return {"window_s": t1 - t_first, "solve_times": times, "iterations": iterations,
            "attempted": len(times), "failed": failed, "evals": evals, "kept": kept}


def traced_solves(fam, solver, v0, device, log) -> dict:
    """``TRACED_SOLVES`` solves under ``torch.profiler``, reduced by
    ``measure.reduce_trace``, with their iteration count. A window whose
    device kernels fall short of the host's launch calls lost events to the
    profiler and is taken again, up to ``TRACE_ATTEMPTS`` windows; the
    retakes are logged."""
    from torch.profiler import ProfilerActivity, profile, record_function

    retries = []
    for attempt in range(TRACE_ATTEMPTS):
        iters = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            measure.pad_events(device)
            with record_function(ANNOTATION):
                for _ in range(TRACED_SOLVES):
                    iters += int(fam.solve(solver, v0)[3])
                    sync(device)
            measure.pad_events(device)
        summary = measure.reduce_trace(measure.export_events(prof), ANNOTATION)
        if summary and summary["busy_s"] > 0 and summary["kernels"] >= summary["launch_calls"]:
            log({"trace_retries": retries})
            return {**summary, "iterations": iters}
        retries.append({"attempt": attempt + 1,
                        **({k: summary[k] for k in ("kernels", "launch_calls", "busy_s")}
                           if summary else {"summary": None})})
    log({"trace_retries": retries})
    raise RuntimeError(f"the profiler lost device events in {TRACE_ATTEMPTS} windows: {retries}")


def judge(cell: Cell, seed: int, device, evals: list, kept: list, gen: dict = None) -> dict:
    """The numbers compared with the plain reference, from the generator's
    operator made anew from the seed: the widest gap of any solve's sorted
    eigenvalues from the reference's lowest ones (a skipped root shows as a
    gap of a level spacing), and of the kept solves' eigenpairs (evals, X)
    the largest residual ||A x - lambda x|| of a returned pair, x a unit
    row, under the float64 reference action, and max|X X^T - I|. ``None``
    where nothing was returned. ``gen``: the generator's operator where the
    caller holds it."""
    ref = plugin("reference", cell.cfg["operator"])
    if gen is None:
        gen = plugin("operators", cell.cfg["operator"]).generate(cell.cfg, seed, device)

    def act(x):
        return ref.action(gen, x)

    lam, _ = eigen.lowest(act, gen["diag"], cell.traffic["nroots"])
    out = dict.fromkeys(NUMBERS)
    if evals:
        out["eig_gap"] = float(max(np.max(np.abs(ev - lam)) for ev in evals))
    if kept:
        res = ortho = 0.0
        for ev, x in kept:
            x64 = x.to(torch.float64)
            xs = x64 / torch.linalg.norm(x64, dim=1, keepdim=True)
            lam_x = torch.as_tensor(ev, dtype=torch.float64, device=xs.device)
            r = act(xs) - lam_x[:, None] * xs
            res = max(res, float(torch.linalg.norm(r, dim=1).max()))
            eye = torch.eye(x64.shape[0], dtype=torch.float64, device=x64.device)
            ortho = max(ortho, float((x64 @ x64.T - eye).abs().max()))
        out["residual"], out["orthonormality"] = res, ortho
    return out


def verdict(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, checks): every number present and within its limit, and no
    solve failed; the checks list each number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    checks["failed_solves"] = {"value": failed, "limit": 0}
    ok = failed == 0 and all(numbers[k] is not None and numbers[k] <= limits[k] for k in NUMBERS)
    return ok, checks


def read_metrics(specs: list, run: dict) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something in the run's record."""
    out = {}
    for m in specs:
        value = plugin("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float,
             log=print) -> dict:
    """One run: set-up from ``start`` (the process's first clock reading) to
    the first timed solve, the window, with ``trace`` the profiled solves
    and the timed action, then the check. Returns the result object, its
    ``checks`` last."""
    op_mod = plugin("operators", cell.cfg["operator"])
    fam = plugin("families", cell.traffic["family"])
    rows = cell.traffic["nroots"]
    run = {}

    t0 = time.perf_counter()
    gen = op_mod.generate(cell.cfg, seed, device)
    sizes = gen["sizes"]
    sync(device)
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    op = op_mod.build(gen, cell.cfg, device)
    del gen
    sync(device)
    t2 = time.perf_counter()
    x = action_rows(op.n, rows, seed, device)
    op.matvec(x, op.operand)
    del x
    sync(device)
    t3 = time.perf_counter()
    solver = fam.build(op, cell.traffic, device)
    v0 = fam.guess(op.diag, cell.traffic)
    t4 = time.perf_counter()
    fam.solve(solver, v0)
    sync(device)
    t5 = time.perf_counter()
    run["first_solve_s"] = t5 - t4
    run["setup_s"] = t5 - start
    log({"setup": {"generate_s": t1 - t0, "build_s": t2 - t1, "first_action_s": t3 - t2,
                   "solver_s": t4 - t3, "first_solve_s": t5 - t4, "setup_s": run["setup_s"],
                   "sizes": sizes}})

    window = run_window(fam, solver, v0, seconds, cell.traffic["tol"], seed, device, log)
    run.update({k: window[k] for k in ("window_s", "solve_times", "iterations", "attempted",
                                        "failed")})
    run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    times = window["solve_times"]
    log({"window": {"solves": window["attempted"], "failed": window["failed"],
                    "window_s": window["window_s"], "iterations": sorted(set(window["iterations"])),
                    "solve_s_min": min(times), "solve_s_median": measure.percentile(times, 50)}})

    if trace and device.type == "cuda":
        run["trace"] = traced_solves(fam, solver, v0, device, log)
        x = action_rows(op.n, rows, seed, device)
        nbytes, ops, peak = op_mod.action_cost(sizes, rows)
        ms = measure.time_ms(lambda: op.matvec(x, op.operand), device, ACTION_REPS)
        run["action"] = {"ms": ms, "bytes": nbytes, "ops": ops, "peak": peak}
        log({"action": run["action"]})
        del x

    del solver, op
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t6 = time.perf_counter()
    numbers = judge(cell, seed, device, window["evals"], window["kept"])
    correct, checks = verdict(numbers, cell.limits, window["failed"])
    log({"check_s": time.perf_counter() - t6})

    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end, run),
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}}
    if "trace" in run:
        result["device"]["busy_s"] = run["trace"]["busy_s"]
        result["device"]["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result
