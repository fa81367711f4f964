"""The port's examples (examples_torch/) run as a user runs them.

Each twin of an ``examples/*.py`` script runs in a fresh subprocess with
``--device cpu``, must exit 0 and end its output with one JSON line (its
``main``'s dict); the notebook's code cells run in order with
``EXAMPLES_DEVICE=cpu``. Without CUDA and without ``--device cpu`` every
twin raises. The two twins whose JAX examples read the reference's
hamiltonian files (absent here) run on synthetic operators and are held
against ``np.linalg.eigvalsh``. tests/test_torch_examples_parity*.py hold
the others against the JAX examples on the same inputs.

The twins' subprocess runs are split over four files by ``GROUPS`` (this
file: the kernel-bearing twins; test_torch_examples_runs_*.py: the
others), so that each file stays short on one test worker; the other
files take ``run_twin`` from here.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_testing import child_env
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_DIR = os.path.join(REPO, "examples_torch")
TWINS = sorted(f[:-3] for f in os.listdir(TWIN_DIR)
               if f.endswith(".py") and not f.startswith("_"))
NOTEBOOK = "OptimizeExample.ipynb"
# the twins whose subprocess runs each file holds
GROUPS = {
    "kernels": ["hybrid_precision", "packed_symmetric_davidson", "quantized_screening",
                "refine_to_1e8"],
    "solvers": ["batched_scan", "checkpoint_resume", "distributed_eigensystem",
                "nonhermitian_eigen", "ppcg_hard_spectrum", "response_equations"],
    "factories": ["differentiable_eigenvalues", "eigenvector_adjoint", "linear_eigensystem",
                  "linear_equations", "nonlinear_equations", "optimize"],
    "hamiltonian": ["foreign_container", "linear_eigensystem_multiroot"],
}
TIMEOUT_S = 240

_RUNS = {}


def _env(**extra):
    env = child_env()
    env.pop("EXAMPLES_DEVICE", None)
    env.update(extra)
    return env


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def run_twin(name: str) -> dict:
    """The twin's JSON line from a subprocess run with --device cpu (once
    per test session and worker)."""
    if name not in _RUNS:
        proc = subprocess.run(
            [sys.executable, os.path.join(TWIN_DIR, f"{name}.py"), "--device", "cpu"],
            capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(), cwd=REPO)
        assert proc.returncode == 0, (
            f"{name} failed\nstdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-3000:]}")
        _RUNS[name] = _last_json(proc.stdout)
    return _RUNS[name]


def test_refine_split_action_on_the_cpu():
    """refine_to_1e8 with the card's operator (the split packed action, its
    plain version here): the refinement reaches 1e-8 whatever the float32
    solve's count (its floor sits at the solve's tol 1e-5)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(TWIN_DIR, "refine_to_1e8.py"), "--device", "cpu",
         "--action", "split", "--n", "512", "--nroots", "4"],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = _last_json(proc.stdout)
    assert out["action"] == "split" and out["converged"] and out["max_residual_f64"] <= 1e-8
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)) * (0.05 / np.sqrt(512))
    ref = np.linalg.eigvalsh(a + a.T + np.diag(np.concatenate([np.linspace(-2.0, 3.0, 32),
                                                               np.linspace(6.0, 50.0, 480)])))
    np.testing.assert_allclose(out["eigenvalues"], ref[:4], rtol=0, atol=1e-9)


def test_every_example_has_a_twin():
    examples = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                      if f.endswith(".py"))
    assert TWINS == examples == sorted(sum(GROUPS.values(), []))
    assert os.path.exists(os.path.join(TWIN_DIR, NOTEBOOK))


@pytest.mark.parametrize("name", GROUPS["kernels"])
def test_twin_runs_on_the_cpu(name):
    out = run_twin(name)
    assert out["example"] == name and out["device"] == "cpu"


def _skip_on_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_without_cuda(name):
    """The default device is the card: without CUDA, main raises before it
    computes anything."""
    _skip_on_a_card()
    twin = importlib.import_module(f"examples_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([])


def _run_notebook(**env):
    code = ("import json\n"
            "from examples_torch import _cli\n"
            f"print(json.dumps(_cli.run_notebook({os.path.join(TWIN_DIR, NOTEBOOK)!r})))\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=_env(**env), cwd=REPO)


def test_notebook_runs_on_the_cpu():
    proc = _run_notebook(EXAMPLES_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = _last_json(proc.stdout)
    assert out["example"] == "OptimizeExample" and out["device"] == "cpu"
    assert out["bfgs_iterations"] == 7 and out["fused_x_error"] < 1e-6


def test_notebook_refuses_without_cuda():
    _skip_on_a_card()
    proc = _run_notebook()
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("name,argv", [
    ("refine_to_1e8", ["--n", "1000", "--action", "split"]),
    ("quantized_screening", ["--n", "1000"]),
    ("packed_symmetric_davidson", ["--n", "512", "--b", "100"]),
])
def test_twin_rejects_a_width_off_its_tile(name, argv):
    twin = importlib.import_module(f"examples_torch.{name}")
    with pytest.raises(SystemExit):
        twin.main(argv + ["--device", "cpu"])
