"""The port's procedural C-ABI interface (iterative_solver_torch/bindings/
c_api.py) against the JAX package's (bindings/c_api.py) on the same inputs,
on the CPU in float64: the cases of tests/test_c_api.py that read no
hamiltonian (the stack-semantics case runs on a generated matrix), each
driven through both modules. Equal eigenvalues (within 1e-12), ``stats``,
iteration paths and stack semantics; and the device setting the embedded
library reads (``ITERATIVE_SOLVER_DEVICE``)."""

import numpy as np
import pytest
import torch

import iterative_solver_torch as T
import iterative_solver_tpu as J
from iterative_solver_torch import config
from iterative_solver_torch.bindings import c_api as tc
from iterative_solver_tpu.bindings import c_api as jc
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

APIS = {"jax": (jc, J), "torch": (tc, T)}


@pytest.fixture(autouse=True)
def clean_stacks(monkeypatch):
    monkeypatch.setenv("ITERATIVE_SOLVER_DEVICE", "cpu")
    yield
    for api in (jc, tc):
        while api._stack:
            api.IterativeSolverFinalize()


def _problem(mod, matrix):
    kw = {"device": "cpu"} if mod is T else {}
    return mod.models.MatrixProblem(matrix, **kw)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.05
    return a + a.T + np.diag(np.arange(1.0, n + 1.0))


def drive_linear(api, mod, problem, n, nroot, diagonals):
    """tests/test_c_api.py::drive_linear, the problem's vectors as tensors
    of the module's kind."""
    params = np.zeros((nroot, n))
    actions = np.zeros((nroot, n))
    for r, i in enumerate(np.argsort(diagonals)[:nroot]):
        params[r, i] = 1.0
    nwork = nroot
    path = []
    as_vec = (lambda a: torch.as_tensor(a)) if mod is T else (lambda a: a)
    for _ in range(api.IterativeSolverMaxIter()):
        actions[:nwork] = _host(problem.action(as_vec(params[:nwork])))
        nwork = api.IterativeSolverAddVector(nwork, params, actions)
        path.append(nwork)
        while api.IterativeSolverEndIterationNeeded():
            if nwork > 0:
                ev = np.zeros(nroot)
                api.IterativeSolverWorkingSetEigenvalues(ev)
                d = np.zeros(n)
                api.IterativeSolverDiagonals(d)
                actions[:nwork] = _host(problem.precondition(
                    as_vec(actions[:nwork]), ev[:nwork], as_vec(d)))
            nwork = api.IterativeSolverEndIteration(nwork, params, actions)
            path.append(nwork)
        if nwork < 1:
            break
    return nwork, path


def test_linear_eigensystem_stack_semantics_matches_jax():
    matrix = _sym(48, 3)
    n = matrix.shape[0]
    out = {}
    for name, (api, mod) in APIS.items():
        lo, hi = api.IterativeSolverLinearEigensystemInitialize(n, 2, hermitian=True)
        assert (lo, hi) == (0, n)
        api.IterativeSolverSetDiagonals(np.diag(matrix))
        assert api.IterativeSolverNonLinear() == 0
        assert api.IterativeSolverHasEigenvalues() == 1
        nwork, path = drive_linear(api, mod, _problem(mod, matrix), n, 2, np.diag(matrix))
        assert nwork == 0
        ev, errors = np.zeros(2), np.zeros(2)
        api.IterativeSolverEigenvalues(ev)
        api.IterativeSolverErrors(errors)
        p, r = np.zeros((2, n)), np.zeros((2, n))
        api.IterativeSolverSolution(2, np.asarray([0, 1], dtype=np.int32), p, r)
        out[name] = (ev, errors, p, path, str(api._top().solver.stats))
        api.IterativeSolverFinalize()
        assert not api._stack
    (jev, jerr, jp, jpath, jstats), (tev, terr, tp, tpath, tstats) = out["jax"], out["torch"]
    assert tpath == jpath and tstats == jstats
    np.testing.assert_allclose(tev, jev, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tev, np.linalg.eigvalsh(matrix)[:2], atol=2e-9)
    np.testing.assert_allclose(terr, jerr, rtol=0, atol=1e-12)
    assert terr.max() < 2e-8
    np.testing.assert_allclose(np.abs(np.sum(tp * jp, axis=1)), 1.0, atol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(matrix @ tp[0] - tev[0] * tp[0]), 0, atol=1e-7)


@pytest.mark.parametrize("api", [jc, tc], ids=["jax", "torch"])
def test_stack_of_instances(api):
    api.IterativeSolverLinearEigensystemInitialize(4, 1)
    api.IterativeSolverOptimizeInitialize(6)
    assert api.IterativeSolverNonLinear() == 1  # top is the optimizer
    assert api._top().dimension == 6
    api.IterativeSolverFinalize()
    assert api.IterativeSolverNonLinear() == 0  # back to the eigensolver
    assert api._top().dimension == 4


def test_optimize_through_c_api_matches_jax():
    n = 8
    hess = np.diag(np.arange(1.0, n + 1.0))
    out = {}
    for name, (api, mod) in APIS.items():
        kw = {"device": "cpu"} if mod is T else {}
        problem = mod.models.QuadraticOptimizeProblem(hess, b=np.ones(n), **kw)
        as_vec = (lambda a: torch.as_tensor(a)) if mod is T else (lambda a: a)
        api.IterativeSolverOptimizeInitialize(n, thresh=1e-9)
        api.IterativeSolverSetMaxIter(60)
        params, actions = np.zeros((1, n)), np.zeros((1, n))
        for _ in range(api.IterativeSolverMaxIter()):
            value, res = problem.residual(as_vec(params[0]))
            actions[0] = _host(res)
            nwork = api.IterativeSolverAddValue(value, params, actions)
            while api.IterativeSolverEndIterationNeeded():
                if nwork > 0:
                    actions[0] = _host(problem.precondition(
                        as_vec(actions), np.zeros(1), problem.diagonals()))[0]
                nwork = api.IterativeSolverEndIteration(1, params, actions)
            if nwork < 1:
                break
        out[name] = (api.IterativeSolverValue(), params.copy(), str(api._top().solver.stats))
    (jv, jx, js), (tv, tx, ts) = out["jax"], out["torch"]
    assert ts == js
    assert tv < 1e-12 and tv == pytest.approx(jv, abs=1e-14)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tx[0], np.ones(n), atol=1e-6)


def test_linear_equations_through_c_api_matches_jax():
    rng = np.random.default_rng(0)
    n = 10
    a = rng.standard_normal((n, n)) * 0.1
    matrix = a + a.T + np.diag(np.arange(3.0, n + 3.0))
    rhs = rng.standard_normal((1, n))
    out = {}
    for name, (api, mod) in APIS.items():
        api.IterativeSolverLinearEquationsInitialize(n, 1, rhs, thresh=1e-10)
        problem = _problem(mod, matrix)
        as_vec = (lambda a: torch.as_tensor(a)) if mod is T else (lambda a: a)
        api.IterativeSolverSetDiagonals(np.diag(matrix))
        params, actions = np.zeros((1, n)), np.zeros((1, n))
        params[0, 0] = 1.0
        nwork = 1
        for _ in range(50):
            actions[:nwork] = _host(problem.action(as_vec(params[:nwork])))
            nwork = api.IterativeSolverAddVector(nwork, params, actions)
            while api.IterativeSolverEndIterationNeeded():
                if nwork > 0:
                    actions[:nwork] = _host(problem.precondition(
                        as_vec(actions[:nwork]), np.zeros(nwork), problem.diagonals()))
                nwork = api.IterativeSolverEndIteration(nwork, params, actions)
            if nwork < 1:
                break
        p, r = np.zeros((1, n)), np.zeros((1, n))
        api.IterativeSolverSolution(1, np.asarray([0], dtype=np.int32), p, r)
        out[name] = (p, str(api._top().solver.stats))
    assert out["torch"][1] == out["jax"][1]
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(matrix @ out["torch"][0][0], rhs[0], atol=1e-7)


@pytest.mark.parametrize("api", [jc, tc], ids=["jax", "torch"])
def test_suggest_p_through_c_api(api):
    """tests/test_c_api.py::test_suggest_p_through_c_api, in both modules."""
    n = 12
    api.IterativeSolverLinearEigensystemInitialize(n, 2)
    solution, residual = np.zeros((2, n)), np.zeros((2, n))
    solution[0, 3], residual[0, 3] = 1.0, 0.5
    solution[1, 7], residual[1, 7] = 0.6, 0.5
    solution[0, 1], residual[0, 1] = 1e-4, 1e-4
    idx = np.zeros(4, dtype=np.uint64)
    cnt = api.IterativeSolverSuggestP(solution, residual, 4, 1e-3, idx)
    assert cnt == 2
    assert set(int(i) for i in idx[:cnt]) == {3, 7}
    idx1 = np.zeros(1, dtype=np.uint64)
    cnt1 = api.IterativeSolverSuggestP(solution, residual, 1, 1e-3, idx1)
    assert cnt1 == 1 and int(idx1[0]) == 3


@pytest.mark.parametrize("api", [jc, tc], ids=["jax", "torch"])
def test_suggest_p_writes_through_list_buffer(api):
    n = 8
    api.IterativeSolverLinearEigensystemInitialize(n, 1)
    solution, residual = np.zeros((1, n)), np.zeros((1, n))
    solution[0, 5] = residual[0, 5] = 1.0
    buf = [0, 0, 0]
    assert api.IterativeSolverSuggestP(solution, residual, 3, 1e-6, buf) == 1
    assert buf[0] == 5


def test_device_setting(monkeypatch):
    """device=None reads ITERATIVE_SOLVER_DEVICE: "cpu" runs on the host in
    float64, an explicit device wins, an unknown value raises, and unset
    means the card (which raises where CUDA is absent)."""
    tc.IterativeSolverLinearEigensystemInitialize(6, 1)
    solver = tc._top().solver
    assert solver.device.type == "cpu" and solver.dtype == torch.float64
    monkeypatch.setenv("ITERATIVE_SOLVER_DEVICE", "tpu")
    with pytest.raises(ValueError, match="ITERATIVE_SOLVER_DEVICE"):
        tc.IterativeSolverOptimizeInitialize(6)
    monkeypatch.setenv("ITERATIVE_SOLVER_DEVICE", "not a device")
    with pytest.raises(ValueError, match="ITERATIVE_SOLVER_DEVICE"):
        tc.IterativeSolverNonLinearEquationsInitialize(6)
    tc.IterativeSolverNonLinearEquationsInitialize(6, device="cpu")
    assert tc._top().solver.device.type == "cpu"
    monkeypatch.delenv("ITERATIVE_SOLVER_DEVICE")
    assert config.get_option("DEVICE") == ""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.IterativeSolverLinearEigensystemInitialize(6, 1)
