"""The benchmark's PPCG cell, ``fci-ppcg-r64``, at a tiny size on the CPU
(n 4096, tile 512) through the harness as on the card: the port's
``FusedPPCG`` over ``int8_matvec`` held against the plain float64
reference (``portbench/reference/``) on values drawn from the seed. A
sound run comes out correct; a run with one tile pair dropped from the
port's operand, or with one root skipped, does not. The ``ppcg_*``
per-layer metrics read the program's iteration count, and its spans under
a trace."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solver_torch.utils import profiler
from portbench import harness, ppcg_spans
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

CPU = torch.device("cpu")
NAME = "fci-ppcg-r64"
SEED = 2 ** 31 + 12345
SPAN_METRICS = ("ppcg_action_share", "ppcg_rr3_ms_per_iter", "ppcg_full_rr_ms_per_solve",
                "ppcg_host_wait_ms_per_solve")
SOLVES = 2
# what the harness's record of a traced run holds beside the registry
TRACE = {"window_s": 0.0, "busy_s": 0.0, "kernels": 0, "launch_calls": 0, "iterations": 0,
         "device_ops": [], "idle_gaps": []}


@pytest.fixture
def cell():
    cell = harness.load_cell(NAME)
    cell.cfg = {**cell.cfg, "n": 4096, "tile": 512}
    return cell


def run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.5, trace, CPU, time.perf_counter(),
                            log=lambda obj: None)


def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"solve_s", "solve_p95_s", "setup_s"}   # no card: no memory
    assert list(res)[-1] == "checks"
    json.dumps(res)


def test_traced_run_reads_the_iterations(cell):
    res = run(cell, trace=True)
    assert res["correct"], res["checks"]
    # the CPU has no device trace, no CUDA events and no timed action
    assert set(res["metrics"]) == {"ppcg_iterations"}
    assert res["metrics"]["ppcg_iterations"] == {"value": 2.0, "unit": "iters"}


def dropped_tile_pair(monkeypatch, cell):
    """The port's operand without the tile pair (0, 0), the block that
    couples the low states with each other."""
    mod = harness.plugin("operators", cell.cfg["operator"])
    build = mod.build

    def broken(gen, cfg, device):
        keep = (gen["ii"] != 0) | (gen["jj"] != 0)
        return build({**gen, "q": gen["q"][keep], "ii": gen["ii"][keep],
                      "jj": gen["jj"][keep]}, cfg, device)

    monkeypatch.setattr(mod, "build", broken)


def skipped_root(monkeypatch, cell):
    """The guess's last row on the 65th lowest diagonal entry in place of
    the 64th: PPCG keeps each root in its own subspace, so the 64th root is
    never found."""
    fam = harness.plugin("families", cell.traffic["family"])
    guess = fam.guess

    def broken(diag, traffic):
        v0 = guess(diag, traffic)
        v0[-1] = 0.0
        v0[-1, np.argsort(diag, kind="stable")[traffic["nroots"]]] = 1.0
        return v0

    monkeypatch.setattr(fam, "guess", broken)


@pytest.mark.parametrize("fault", [dropped_tile_pair, skipped_root], ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.fixture
def registry(cell):
    """The registry after ``SOLVES`` profiled solves of the tiny cell, its
    solver warmed first, as the harness's traced segment leaves it."""
    op_mod = harness.plugin("operators", cell.cfg["operator"])
    fam = harness.plugin("families", cell.traffic["family"])
    op = op_mod.build(op_mod.generate(cell.cfg, SEED, CPU), cell.cfg, CPU)
    solver = fam.build(op, cell.traffic, CPU)
    v0 = fam.guess(op.diag, cell.traffic)
    fam.solve(solver, v0)
    profiler.reset()
    iters = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(SOLVES):
            iters += int(fam.solve(solver, v0)[3])
    yield profiler.snapshot(), iters
    profiler.reset()


def test_span_metrics_read_the_registry(cell, registry):
    reg, iters = registry
    s = reg["spans"]
    assert s["ppcg.solve"]["count"] == SOLVES and s["ppcg.iteration"]["count"] == iters
    assert s["ppcg.full_rr"]["count"] >= SOLVES      # the full RR runs in every solve
    got = harness.read_metrics(cell.per_layer, {"trace": TRACE})
    assert set(got) == set(SPAN_METRICS)      # no launches or timed action on the CPU
    assert {k: v["value"] for k, v in got.items()} == pytest.approx({
        "ppcg_action_share": 100 * s["ppcg.action"]["device_s"] / s["ppcg.solve"]["device_s"],
        "ppcg_rr3_ms_per_iter": 1e3 * s["ppcg.rr3"]["device_s"] / iters,
        "ppcg_full_rr_ms_per_solve": 1e3 * s["ppcg.full_rr"]["device_s"] / SOLVES,
        "ppcg_host_wait_ms_per_solve": 1e3 * s["ppcg.wait"]["host_s"] / SOLVES,
    })
    assert 0 < got["ppcg_action_share"]["value"] < 100
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    assert all(got[name]["unit"] == units[name] for name in SPAN_METRICS)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_ppcg_spans(name, monkeypatch):
    """Nothing without a trace, before any profiled solve, after a Davidson
    solve alone (a program whose PPCG has no spans), or in a program
    without the registry."""
    read = harness.plugin("metrics", name).read
    profiler.reset()
    assert read({"attempted": 1, "iterations": [2]}) is None
    assert read({"trace": TRACE}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("davidson.solve"):
            pass
    assert read({"trace": TRACE}) is None and ppcg_spans.registry({"trace": TRACE}) is None
    monkeypatch.delattr(profiler, "snapshot")
    assert read({"trace": TRACE}) is None
    profiler.reset()
