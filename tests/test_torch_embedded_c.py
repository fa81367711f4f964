"""End-to-end test of the port's embedded C shared library
(iterative_solver_torch/bindings/build_embedded.py): builds
``libiterative_solver_torch_c.so`` with cffi, compiles each C example of
examples/c against the repository's unchanged header
(include/iterative_solver_c.h) with gcc, and runs it on the CPU
(``ITERATIVE_SOLVER_DEVICE=cpu``): the port's twin of tests/test_embedded_c.py.
Skipped only where gcc or cffi is absent."""

import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig

import pytest
from torch_testing import child_env
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [
    pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc unavailable"),
    pytest.mark.skipif(importlib.util.find_spec("cffi") is None, reason="cffi unavailable"),
]

# example -> the line it prints on success (tests/test_embedded_c.py's)
EXAMPLES = {
    "linear_eigensystem_c": "C ABI OK",
    "pspace_c": "P-space C ABI OK",
    "linear_equations_c": "OK",
    "optimize_c": "Optimize C ABI OK",
    "diis_c": "DIIS C ABI OK",
}


def _env():
    env = child_env(ITERATIVE_SOLVER_DEVICE="cpu",
                    PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    build = tmp_path_factory.mktemp("torch_c")
    header = os.path.join(REPO, "include", "iterative_solver_c.h")
    with open(header, "rb") as fh:
        before = fh.read()
    out = subprocess.run(
        [sys.executable, "-m", "iterative_solver_torch.bindings.build_embedded",
         str(build / "lib")], cwd=str(build), env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert os.path.exists(out.stdout.strip().splitlines()[-1])
    with open(header, "rb") as fh:
        assert fh.read() == before  # the build leaves the header as it is
    return build


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_c_example_through_the_ports_library(library, example):
    exe = str(library / example)
    compiled = subprocess.run(
        ["gcc", "-O2", os.path.join(REPO, "examples", "c", f"{example}.c"),
         "-I", os.path.join(REPO, "include"), "-L", str(library / "lib"),
         "-literative_solver_torch_c", "-lm", "-o", exe],
        capture_output=True, text=True, timeout=120)
    assert compiled.returncode == 0, compiled.stderr
    env = _env()
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        [str(library / "lib"), sysconfig.get_config_var("LIBDIR") or ""])
    run = subprocess.run([exe], env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    assert EXAMPLES[example] in run.stdout
    # an exception inside the library is printed by cffi and the call
    # returns zeros: none may have happened
    assert "Traceback" not in run.stderr, run.stderr
