"""The float64 twins of the differentiable solves, of the create_*
factories and of checkpoint_resume against their JAX examples, on the
CPU, and the twin notebook against the JAX notebook (the rules in
test_torch_examples_parity.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
from test_torch_examples_parity import HIGHEST, close, guess, twin

import iterative_solver_tpu as its_j
from examples_torch import _cli
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _theta_operators(n, seed, t_top, extra=False):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    T = jnp.asarray(t + t.T + np.diag(np.linspace(0.0, t_top, n)))
    v = rng.standard_normal((n, n)) * (0.3 / np.sqrt(n))
    V = jnp.asarray(v + v.T)
    if not extra:
        return T, V
    m = rng.standard_normal((n, n)) * (1.0 / np.sqrt(n))
    return T, V, jnp.asarray(m + m.T)


def test_differentiable_eigenvalues():
    n = 200
    T, V = _theta_operators(n, 0, 15.0)
    eigfn = its_j.make_differentiable_eigenvalues(
        lambda x, op: jnp.matmul(x, (T + op[0] * V).T, precision=HIGHEST), 1, 8,
        tol=1e-11, max_iter=300)
    v0 = jnp.zeros((1, n)).at[0, 0].set(1.0)

    def energy(theta):
        return eigfn(v0, (theta,), jnp.diagonal(T))[0]

    out = twin("differentiable_eigenvalues")
    for point in out["points"]:
        theta = point["theta"]
        close(point["energy"], float(energy(theta)), 1e-10)
        close(point["force"], float(jax.grad(lambda th: -energy(th))(theta)), 1e-8)


def test_eigenvector_adjoint():
    from iterative_solver_tpu.solvers.implicit_diff import make_differentiable_eigenpairs

    n = 160
    T, V, M = _theta_operators(n, 3, 12.0, extra=True)
    pairs = make_differentiable_eigenpairs(
        lambda x, op: jnp.matmul(x, (T + op[0] * V).T, precision=HIGHEST), nroots=1,
        m_max=12, tol=1e-11, max_iter=400, response_tol=1e-10, response_max_iter=400)
    v0 = jnp.zeros((1, n)).at[0, 0].set(1.0)

    def prop(theta):
        _, x = pairs(v0, (theta,), jnp.diagonal(T))
        return x[0] @ (M @ x[0])

    out = twin("eigenvector_adjoint")
    for point in out["points"]:
        close(point["property"], float(prop(point["theta"])), 1e-10)
        close(point["gradient"], float(jax.grad(prop)(point["theta"])), 1e-8)


def test_checkpoint_resume(tmp_path):
    from iterative_solver_tpu import FusedNonSymDavidson
    from iterative_solver_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    n = 200
    problem = its_j.models.ExampleProblem(n)
    matrix = np.asarray(problem.matrix, dtype=np.float64)
    solver = its_j.create_linear_eigensystem(n, 2, "Davidson")
    solver.set_hermiticity(True)
    solver.verbosity = its_j.Verbosity.NONE
    params = jnp.zeros((2, n)).at[0, 0].set(1.0).at[1, 1].set(1.0)
    nwork = 2
    for _ in range(3):
        actions = problem.action(params[:nwork])
        nwork, params, actions = solver.add_vector(params, actions)
        while solver.end_iteration_needed:
            if nwork > 0:
                actions = problem.precondition(actions[:nwork],
                                               solver.working_set_eigenvalues()[:nwork],
                                               problem.diagonals())
            nwork, params, actions = solver.end_iteration(params, actions)
    interrupted = np.asarray(solver.errors)
    save_checkpoint(solver, str(tmp_path / "davidson.npz"))
    resumed = load_checkpoint(str(tmp_path / "davidson.npz"))
    resumed.solve(np.asarray(resumed.solution_params([0, 1])), problem=problem)
    mns = matrix.copy()
    mns[np.tril_indices(n, -1)] *= 0.9
    v0 = guess(np.diag(mns), 2)
    path = str(tmp_path / "nonsym.npz")
    _, _, _, it_i = FusedNonSymDavidson.from_dense(
        mns, 2, convergence_threshold=1e-9, max_iter=4, chunk_iters=2, rr="device",
        m_max=12).solve(v0, checkpoint_path=path)
    evals_ns, _, _, it = FusedNonSymDavidson.from_dense(
        mns, 2, convergence_threshold=1e-9, max_iter=200, rr="device",
        m_max=12).resume(path)
    out = twin("checkpoint_resume")
    close(out["interrupted_errors"], interrupted, 1e-10)
    assert out["iterations"] == resumed.stats.iterations
    close(out["eigenvalues"], np.asarray(resumed.eigenvalues())[:2], 1e-10)
    assert out["nonsym"]["interrupted_at"] == int(it_i)
    assert out["nonsym"]["iterations"] == int(it)
    close(out["nonsym"]["eigenvalues"], np.sort(np.asarray(evals_ns).real), 1e-10)


def test_linear_eigensystem():
    problem = its_j.models.ExampleProblem(100)
    solver = its_j.create_linear_eigensystem(100, 1, "Davidson")
    solver.set_hermiticity(True)
    solver.solve(np.zeros((1, 100)), problem=problem, generate_initial_guess=True)
    out = twin("linear_eigensystem")
    assert out["iterations"] == solver.stats.iterations
    assert out["matvecs"] == problem.n_actions
    close(out["eigenvalue"], float(solver.eigenvalues()[0]), 1e-10)


def test_linear_equations():
    n, nrhs = 50, 2
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * 0.05
    matrix = a + a.T + np.diag(np.arange(2.0, n + 2.0))
    rhs = rng.standard_normal((nrhs, n))
    solver = its_j.create_linear_equations(n, nrhs)
    solver.add_equations(rhs)
    solver.solve(np.zeros((nrhs, n)), problem=its_j.models.MatrixProblem(matrix),
                 generate_initial_guess=True)
    x = np.asarray(solver.solution_params(list(range(nrhs))))
    out = twin("linear_equations")
    assert out["iterations"] == solver.stats.iterations
    close(out["x_norms"], np.linalg.norm(x, axis=1), 1e-8)


def test_nonlinear_equations():
    problem = its_j.models.TrigNonlinearProblem(30)
    solver = its_j.create_nonlinear_equations(30, "DIIS", "max_size_qspace=8")
    _, x, _ = solver.solve(np.zeros((1, 30)), problem=problem)
    out = twin("nonlinear_equations")
    assert out["iterations"] == solver.stats.iterations
    close(out["x"], np.asarray(x)[0], 1e-8)


def _optimize_jax():
    n = 20
    hessian = np.diag(np.arange(1.0, n + 1.0))
    hessian[0, n - 1] = hessian[n - 1, 0] = 0.5
    solver = its_j.create_optimize(n, "BFGS", "max_size_qspace=6")
    _, x, _ = solver.solve(np.zeros((1, n)),
                           problem=its_j.models.QuadraticOptimizeProblem(hessian,
                                                                         b=np.ones(n)))
    return hessian, solver, np.asarray(x)[0]


def test_optimize():
    _, solver, x = _optimize_jax()
    out = twin("optimize")
    assert out["iterations"] == solver.stats.iterations
    assert out["stats"] == str(solver.stats)
    close(out["solution_error"], np.abs(x - 1.0).max(), 1e-8)


def test_optimize_notebook(monkeypatch):
    """The notebook's cells in this process (EXAMPLES_DEVICE=cpu) against
    the JAX notebook's BFGS and FusedLBFGS."""
    from iterative_solver_tpu.solvers.fused_lbfgs import FusedLBFGS

    hessian, solver, _ = _optimize_jax()
    hd, ones = jnp.asarray(hessian), jnp.ones(20)

    def value_and_grad(x, operand):
        g = jnp.matmul(operand, x - ones, precision=HIGHEST)
        return 0.5 * jnp.matmul(x - ones, g), g

    _, f, _, iters = FusedLBFGS(value_and_grad, 20, history=8, operand=hd).run(np.zeros(20))
    monkeypatch.setenv("EXAMPLES_DEVICE", "cpu")
    out = _cli.run_notebook(os.path.join(REPO, "examples_torch", "OptimizeExample.ipynb"))
    assert out["bfgs_iterations"] == solver.stats.iterations
    assert out["fused_iterations"] == int(iters)
    close(out["fused_value"], float(f), 1e-12)
