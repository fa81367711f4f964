"""The solver twins (batched_scan, checkpoint_resume, distributed_eigensystem,
nonhermitian_eigen, ppcg_hard_spectrum, response_equations) run as a
user runs them: each in a fresh subprocess with ``--device cpu``, exiting
0 with its JSON line (the rules in test_torch_examples.py)."""

import pytest
from test_torch_examples import GROUPS, run_twin
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


@pytest.mark.parametrize("name", GROUPS["solvers"])
def test_twin_runs_on_the_cpu(name):
    out = run_twin(name)
    assert out["example"] == name and out["device"] == "cpu"
