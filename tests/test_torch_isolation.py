"""The port imports nothing of JAX: no module of iterative_solver_torch/,
not chip_smoke.py, calibrate_sparse_cpu.py, calibrate_nonlinear_cpu.py,
calibrate_nonsym_cpu.py, calibrate_spill_cpu.py, calibrate_sharded_cpu.py or
the sharded tests' worker (tests/torch_shard_worker.py) imports ``jax``, ``jaxlib``
or ``iterative_solver_tpu`` (which would run iterative_solver_tpu/__init__.py
and import JAX)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "iterative_solver_tpu"}
PORT_FILES = sorted((ROOT / "iterative_solver_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "calibrate_sparse_cpu.py", ROOT / "compare_kernels.py",
    ROOT / "calibrate_nonlinear_cpu.py", ROOT / "calibrate_nonsym_cpu.py",
    ROOT / "calibrate_spill_cpu.py", ROOT / "calibrate_sharded_cpu.py",
    ROOT / "tests" / "torch_shard_worker.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"fused_davidson.py", "symm.py", "chain.py", "chip_smoke.py", "symm_int8.py",
            "fused_ppcg.py", "synthetic_fci.py", "spmv.py", "gram.py", "core.py",
            "factory.py", "calibrate_sparse_cpu.py", "compare_kernels.py",
            "fused_linear.py", "fused_cg.py", "refine.py", "precise.py",
            "linear_equations.py", "checkpoint.py", "fused_lbfgs.py", "fused_diis.py",
            "optimize.py", "nonlinear_diis.py", "interpolate.py", "implicit_diff.py",
            "calibrate_nonlinear_cpu.py", "fused_nonsym.py", "dense_int8.py",
            "calibrate_nonsym_cpu.py", "offload_store.py", "banded.py", "chebyshev.py",
            "calibrate_spill_cpu.py", "distribution.py", "distr_array.py", "mesh.py",
            "collectives.py", "sharded_symm.py", "sharded_bsr.py",
            "calibrate_sharded_cpu.py", "torch_shard_worker.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_PROBE = r"""
import importlib.abc, sys
FORBIDDEN = {"jax", "jaxlib", "iterative_solver_tpu"}
for name in list(sys.modules):
    if name.split(".")[0] in FORBIDDEN:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import iterative_solver_torch
import iterative_solver_torch.convert
import iterative_solver_torch.array.vector_ops
import iterative_solver_torch.ops.kernels._build
import iterative_solver_torch.ops.kernels.chain
import iterative_solver_torch.ops.kernels.symm
import iterative_solver_torch.ops.kernels.symm_int8
import iterative_solver_torch.ops.kernels.spmv
import iterative_solver_torch.ops.kernels.gram
import iterative_solver_torch.ops.dense
import iterative_solver_torch.config
import iterative_solver_torch.options
import iterative_solver_torch.problem
import iterative_solver_torch.factory
import iterative_solver_torch.array.basis_store
import iterative_solver_torch.models.synthetic_fci
import iterative_solver_torch.models.matrix_problem
import iterative_solver_torch.native.vecstore
import iterative_solver_torch.subspace.dimensions
import iterative_solver_torch.subspace.xspace
import iterative_solver_torch.subspace.solvers
import iterative_solver_torch.solvers._finite
import iterative_solver_torch.solvers._symmetry
import iterative_solver_torch.solvers.core
import iterative_solver_torch.solvers.fused_davidson
import iterative_solver_torch.solvers.fused_ppcg
import iterative_solver_torch.solvers.fused_linear
import iterative_solver_torch.solvers.fused_cg
import iterative_solver_torch.solvers.refine
import iterative_solver_torch.solvers.linear_equations
import iterative_solver_torch.solvers.optimize
import iterative_solver_torch.solvers.nonlinear_diis
import iterative_solver_torch.solvers.interpolate
import iterative_solver_torch.solvers.fused_lbfgs
import iterative_solver_torch.solvers.fused_diis
import iterative_solver_torch.solvers.implicit_diff
import iterative_solver_torch.ops.precise
import iterative_solver_torch.utils.checkpoint
import iterative_solver_torch.solvers.linear_eigensystem
import iterative_solver_torch.solvers.propose_rspace
import iterative_solver_torch.utils.logger
import iterative_solver_torch.utils.profiler
import iterative_solver_torch.utils.statistics
import iterative_solver_torch.array.distribution
import iterative_solver_torch.array.distr_array
import iterative_solver_torch.parallel
import iterative_solver_torch.parallel.mesh
import iterative_solver_torch.parallel.collectives
import iterative_solver_torch.parallel.sharded_symm
import iterative_solver_torch.parallel.sharded_bsr
import chip_smoke
import calibrate_sharded_cpu
sys.path.insert(0, "tests")
import torch_shard_worker
import calibrate_sparse_cpu
import calibrate_nonlinear_cpu
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print("ISOLATED")
"""


def test_port_imports_under_a_finder_that_refuses_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
