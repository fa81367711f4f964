"""The per-layer metrics that read the program's spans and counter
(``spans.py`` and its readers under ``metrics/``): nothing without a trace
or without the program's registry, and each value from the registry that
profiled solves of a tiny cell leave."""

import pytest
from torch.profiler import ProfilerActivity, profile

from iterative_solver_torch.utils import profiler
from portbench import harness, spans
from portbench.tests.conftest import CPU

NEW = ("upload_ms_per_solve", "h2d_mb_per_solve", "host_wait_ms_per_solve", "rr_ms_per_iter",
       "ritz_ms_per_iter", "expand_ms_per_iter", "action_share")
SOLVES = 2
# what the harness's record of a traced run holds beside the registry
TRACE = {"window_s": 0.0, "busy_s": 0.0, "kernels": 0, "launch_calls": 0, "iterations": 0,
         "device_ops": [], "idle_gaps": []}


def read(name, run):
    return harness.plugin("metrics", name).read(run)


@pytest.fixture
def registry(cell):
    """The registry after ``SOLVES`` profiled solves of the tiny cell, its
    solver warmed first, as the harness's traced segment leaves it."""
    op_mod = harness.plugin("operators", cell.cfg["operator"])
    fam = harness.plugin("families", cell.traffic["family"])
    op = op_mod.build(op_mod.generate(cell.cfg, 2 ** 31 + 7, CPU), cell.cfg, CPU)
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


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_a_trace(name, registry):
    run = {"attempted": 1, "window_s": 1.0, "solve_times": [1.0], "iterations": [2],
           "memory_peak_bytes": None}
    assert read(name, run) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_in_a_program_without_the_registry(name, registry, monkeypatch):
    monkeypatch.delattr(profiler, "snapshot")
    assert read(name, {"trace": TRACE}) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_before_a_profiled_solve(name):
    profiler.reset()
    assert read(name, {"trace": TRACE}) is None


def test_readers_compute_from_the_registry(registry):
    reg, iters = registry
    s = reg["spans"]
    assert s["davidson.solve"]["count"] == SOLVES and s["davidson.iteration"]["count"] == iters
    run = {"trace": TRACE}
    assert {name: read(name, run) for name in NEW} == pytest.approx({
        "upload_ms_per_solve": 1e3 * s["davidson.upload"]["host_s"] / SOLVES,
        "h2d_mb_per_solve": 0.0,   # the CPU solve lands nothing on a card
        "host_wait_ms_per_solve": 1e3 * s["davidson.wait"]["host_s"] / SOLVES,
        "rr_ms_per_iter": 1e3 * s["davidson.rr"]["device_s"] / iters,
        "ritz_ms_per_iter": 1e3 * s["davidson.ritz"]["device_s"] / iters,
        "expand_ms_per_iter": 1e3 * s["davidson.expand"]["device_s"] / iters,
        "action_share": 100 * s["davidson.action"]["device_s"] / s["davidson.solve"]["device_s"],
    })
    assert 0 < read("action_share", run) < 100
    # the counter, as the guess's upload to a card adds it
    with profile(activities=[ProfilerActivity.CPU]):
        profiler.count("h2d_bytes", 16 * 131072 * 4 * SOLVES)
    assert read("h2d_mb_per_solve", run) == pytest.approx(8.388608)


def test_cell_reports_the_new_metrics(cell, registry):
    got = harness.read_metrics(cell.per_layer, {"trace": TRACE})
    assert set(NEW) <= set(got)
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    assert all(got[name]["unit"] == units[name] for name in NEW)
    assert spans.registry({"trace": TRACE}) is not None
