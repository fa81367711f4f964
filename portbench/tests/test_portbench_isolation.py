"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference loads nothing of the port. Each check runs in a fresh process,
so that what other tests import cannot hide or fake a finding."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

REFERENCE = sorted(p.stem for p in (harness.BENCH_DIR / "reference").glob("*.py")
                   if p.stem != "__init__")


def fresh(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_and_a_cell_run_load_no_jax():
    """Every module of portbench imported, every plugin loaded, and a tiny
    cell run on the CPU through the port: no module whose top-level name is
    jax, jaxlib, flax or iterative_solver_tpu."""
    code = f"""
import json, pkgutil, importlib, sys, time
sys.path.insert(0, {str(ROOT)!r})
import portbench
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
import torch
from portbench import harness
for kind in ("operators", "reference", "families", "metrics"):
    for p in (harness.BENCH_DIR / kind).glob("*.py"):
        if p.stem != "__init__":
            harness.plugin(kind, p.stem)
cell = harness.load_cell("fci-davidson-r16")
cell.cfg = {{**cell.cfg, "n": 2048, "tile": 512}}
res = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter(),
                       log=lambda o: None)
print(json.dumps({{"found": harness.forbidden_modules(), "correct": res["correct"],
                  "port": "iterative_solver_torch" in sys.modules}}))
"""
    got = fresh(code)
    assert got == {"found": [], "correct": True, "port": True}


def test_forbidden_names_are_compared_whole():
    assert set(harness.FORBIDDEN) >= {"jax", "jaxlib", "iterative_solver_tpu"}
    names = ("jaxtyping", "iterative_solver_tpu_extra")
    for name in names:
        sys.modules.setdefault(name, sys)
    try:
        assert not set(names) & set(harness.forbidden_modules())
    finally:
        for name in names:
            del sys.modules[name]


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_loads_nothing_of_the_port(name):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.{name}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"iterative_solver_torch", "iterative_solver_tpu", "jax", "jaxlib"}})))
"""
    assert fresh(code) == []
