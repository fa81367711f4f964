"""The two twins whose JAX examples read the reference's hamiltonian files
(foreign_container, linear_eigensystem_multiroot) run as a user runs
them, on their synthetic operators, each in a fresh subprocess with
``--device cpu``, and are held against ``np.linalg.eigvalsh`` of those
operators (the rules in test_torch_examples.py)."""

import numpy as np
import pytest
from test_torch_examples import GROUPS, run_twin
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


@pytest.mark.parametrize("name", GROUPS["hamiltonian"])
def test_twin_runs_on_the_cpu(name):
    out = run_twin(name)
    assert out["example"] == name and out["device"] == "cpu"


def test_foreign_container_matches_eigvalsh():
    """Two synthetic operators, one and two roots, each against the dense
    f64 eigenvalues (the twin's operators, rebuilt here)."""
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_dense

    out = run_twin("foreign_container")
    assert [(r["n"], r["nroots"]) for r in out["runs"]] == [(512, 1), (512, 2), (768, 1),
                                                            (768, 2)]
    for run, seed in zip(out["runs"], (0, 0, 1, 1)):
        ref = np.linalg.eigvalsh(synthetic_fci_dense(run["n"], seed=seed))[:run["nroots"]]
        assert run["converged"]
        np.testing.assert_allclose(run["eigenvalues"], ref, rtol=0, atol=2e-9)


def test_multiroot_matches_eigvalsh():
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_dense

    out = run_twin("linear_eigensystem_multiroot")
    ref = np.linalg.eigvalsh(synthetic_fci_dense(1000, seed=0))[:4]
    assert out["converged"] and out["p_space"] == 6
    np.testing.assert_allclose(out["eigenvalues"], ref, rtol=0, atol=1e-9)
