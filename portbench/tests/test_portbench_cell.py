"""Whole cells through the harness: sound runs on the CPU at tiny sizes come
out correct, and runs with the timed path broken underneath come out not
correct; on the card, the control at the cell's own size is refused."""

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.conftest import CPU, ROOT

SEED = 2 ** 31 + 12345


def run(cell, seconds=0.5, trace=False):
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter(),
                            log=lambda obj: None)


def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"solve_s", "solve_p95_s", "setup_s"}   # no card: no memory
    assert list(res)[-1] == "checks"
    json.dumps(res)


def test_traced_run_reads_the_per_layer_metrics_it_can(cell):
    res = run(cell, trace=True)
    assert res["correct"]
    # the CPU has no device trace and no CUDA events
    assert set(res["metrics"]) == {"first_solve_s", "iterations"}


def step_unchanged(monkeypatch, cell):
    from iterative_solver_torch.solvers import fused_davidson

    monkeypatch.setattr(fused_davidson, "_step_body",
                        lambda *a, **k: (lambda state, operand, diag, it=0: state))


def half_the_rows(monkeypatch, cell):
    """The action computes the first half of the rows of x and returns
    zeros for the rest."""
    mod = harness.plugin("operators", cell.cfg["operator"])
    build = mod.build

    def broken(gen, cfg, device):
        op = build(gen, cfg, device)

        def matvec(x, operand):
            y = op.matvec(x, operand)
            y[(x.shape[0] + 1) // 2:] = 0.0
            return y

        return SimpleNamespace(**{**vars(op), "matvec": matvec})

    monkeypatch.setattr(mod, "build", broken)


def altered_eigenvalue(monkeypatch, cell):
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    finish = FusedDavidson._finish

    def broken(self, state):
        evals, x, errors, its = finish(self, state)
        evals = evals.copy()
        evals[5] += 1e-2
        return evals, x, errors, its

    monkeypatch.setattr(FusedDavidson, "_finish", broken)


def altered_eigenvector(monkeypatch, cell):
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    finish = FusedDavidson._finish

    def broken(self, state):
        evals, x, errors, its = finish(self, state)
        x = x.clone()
        x[2] = x[3]
        return evals, x, errors, its

    monkeypatch.setattr(FusedDavidson, "_finish", broken)


@pytest.mark.parametrize("fault", [step_unchanged, half_the_rows, altered_eigenvalue,
                                   altered_eigenvector], ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fci-davidson-r16"])
def test_control_is_refused_on_the_card(name, cuda_device):
    """At the cell's own size: the program's reading of a seed passes every
    limit, and the control's fails one."""
    cell = harness.load_cell(name)
    prog = calibrate.program_reading(cell, SEED, cuda_device)
    ctrl = calibrate.control_reading(cell, SEED, cuda_device)
    assert all(prog[k] <= cell.limits[k] for k in harness.NUMBERS), prog
    assert any(not ctrl[k] <= cell.limits[k] for k in harness.NUMBERS), ctrl


def test_run_without_a_card_prints_no_result(tmp_path):
    """The command refuses to run without CUDA, and a directory that holds
    only the benchmark's files cannot give a result either (on the card,
    only the second is checked: the first would run the cell)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in [tmp_path] if torch.cuda.is_available() else [ROOT, tmp_path]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                              "fci-davidson-r16", "--seed", "1", "--seconds", "1"],
                             cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
        if not torch.cuda.is_available():
            assert out.returncode == 2 and "CUDA" in out.stderr
