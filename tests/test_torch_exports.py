"""Each subpackage of the port exports the names its JAX counterpart exports.

The JAX ``__all__`` lists are read from the source with ``ast``, so the
check needs no JAX import. Left out, and listed here: the Pallas entry
points, which the port exports under its kernel wrappers' names instead."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("solvers", "array", "subspace", "native", "ops", "ops.kernels", "models",
               "utils", "parallel", "bindings")
# JAX name -> the port's name for it (None: waits for its ROADMAP item)
NOT_EXPORTED = {
    "ops.kernels": {"bsr_matmat_pallas": "bsr_matmat_kernel",
                    "masked_gram_pallas": "masked_gram_kernel"},
}


def _jax_all(subpackage: str) -> list:
    path = ROOT / "iterative_solver_tpu" / subpackage.replace(".", "/") / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_exports_the_jax_names(subpackage):
    port = importlib.import_module(f"iterative_solver_torch.{subpackage}")
    skipped = NOT_EXPORTED.get(subpackage, {})
    for name in _jax_all(subpackage):
        if name in skipped:
            mine = skipped[name]
            assert name not in port.__all__
            if mine is not None:
                assert mine in port.__all__ and callable(getattr(port, mine))
            continue
        assert name in port.__all__, f"iterative_solver_torch.{subpackage} lacks {name}"
        assert getattr(port, name) is not None


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_all_names_resolve(subpackage):
    port = importlib.import_module(f"iterative_solver_torch.{subpackage}")
    missing = [name for name in port.__all__ if not hasattr(port, name)]
    assert not missing


def test_reference_names_import_from_the_port():
    from iterative_solver_torch.solvers import (  # noqa: F401
        BandedEigensolver,
        EigenpairRefiner,
        RefineResult,
        estimate_spectral_bounds,
        make_chebyshev_davidson,
        make_chebyshev_expand,
    )
    from iterative_solver_torch.array.offload_store import (  # noqa: F401
        OffloadBasisStore,
        StreamedOffloadStore,
    )


def test_importing_the_subpackages_builds_nothing_and_needs_no_card():
    # a fresh interpreter: no CUDA, no nvcc or g++ run, no kernel library
    probe = (
        "import subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import iterative_solver_torch.solvers, iterative_solver_torch.array\n"
        "import iterative_solver_torch.subspace, iterative_solver_torch.native\n"
        "import iterative_solver_torch.parallel\n"
        "import iterative_solver_torch.bindings.build_embedded\n"
        "assert 'cffi' not in sys.modules\n"
        "import iterative_solver_torch.ops.kernels\n"
        "from iterative_solver_torch.ops.kernels import _build\n"
        "from iterative_solver_torch.native import vecstore\n"
        "assert not calls, calls\n"
        "assert vecstore._load.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'iterative_solver_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
