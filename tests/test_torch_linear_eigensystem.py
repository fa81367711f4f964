"""The port's parity entry point, ``create_linear_eigensystem`` and the
solvers under it (iterative_solver_torch/factory.py, solvers/core.py,
solvers/linear_eigensystem.py, solvers/propose_rspace.py,
subspace/xspace.py, array/basis_store.py, problem.py,
models/matrix_problem.py, native/vecstore.py), against the JAX package's
on the CPU in float64 with the same problems.

Both packages take the same host decisions on the same small matrices, so
each case must give eigenvalues within 1e-10 of the JAX package's, the same
iteration count and the same ``stats`` counters. No hamiltonian file is
read: the operators are ExampleProblem, seeded random matrices and
``synthetic_fci_bsr``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import iterative_solver_torch as T
import iterative_solver_tpu as J
from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr as t_fci_bsr
from iterative_solver_torch.ops.kernels import spmv as tspmv
from iterative_solver_tpu.models.synthetic_fci import synthetic_fci_bsr as j_fci_bsr
from iterative_solver_tpu.ops.kernels import spmv_pallas as jspmv
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def _sym(n, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    off = rng.standard_normal((n, n)) * scale
    m = off + off.T
    np.fill_diagonal(m, np.arange(1.0, n + 1.0))
    return m


def _nonsym(n, seed, factor=0.1):
    rng = np.random.default_rng(seed)
    skew = rng.standard_normal((n, n))
    return _sym(n, seed + 1) + factor * (skew - skew.T) / np.sqrt(n)


def _bsr_problems(n=512, block=32):
    jb, dense = j_fci_bsr(n, block=block, density=0.3, seed=2)
    tb, _ = t_fci_bsr(n, block=block, density=0.3, seed=2, device="cpu")

    class JBSR(J.Problem):
        def action(self, parameters):
            return jspmv.bsr_matmat(parameters, jb)

        def diagonals(self):
            return jb.diagonal

    class TBSR(T.Problem):
        def action(self, parameters):
            return tspmv.bsr_matmat_kernel(parameters, tb)

        def diagonals(self):
            return tb.diagonal

    return JBSR(), TBSR(), dense


def _solve(mod, problem, n, nroot, options="", method="Davidson", hermitian=True,
           nrows=None, **kw):
    solver = mod.create_linear_eigensystem(n, nroot, method, options, **kw)
    if method == "Davidson":
        solver.set_hermiticity(hermitian)
    solver.verbosity = mod.Verbosity.NONE
    conv, x, r = solver.solve(np.zeros((nrows or nroot, n)), problem=problem,
                              generate_initial_guess=True)
    return solver, conv, x


def _compare(jres, tres, ref=None, nroot=None):
    js, jconv, jx = jres
    ts, tconv, tx = tres
    assert tconv == jconv
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float64
    te, je = ts.eigenvalues(), np.asarray(js.eigenvalues())
    assert te.shape == je.shape
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-10)
    assert ts.stats.iterations == js.stats.iterations
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    np.testing.assert_allclose(ts.errors, js.errors, rtol=1e-6, atol=1e-12)
    assert ts.working_set == js.working_set
    if ref is not None:
        np.testing.assert_allclose(np.sort(te[:nroot]), ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("nroot", [1, 3])
def test_example_problem(nroot):
    n = 40
    jres = _solve(J, J.models.ExampleProblem(n), n, nroot)
    tres = _solve(T, T.models.ExampleProblem(n, device="cpu"), n, nroot, device="cpu")
    ref = np.linalg.eigvalsh(np.asarray(T.models.ExampleProblem(n, device="cpu").matrix))
    _compare(jres, tres, ref[:nroot], nroot)
    assert jres[1]


@pytest.mark.parametrize("options", ["", "max_size_qspace=4", "reset_D=3,max_size_qspace=6",
                                     "max_p=8", "max_p=8,p_threshold=2.5",
                                     "convergence_threshold=1e-6,max_iter=3"])
def test_random_symmetric_matrix(options):
    n, nroot = 64, 3
    m = _sym(n, 3)
    jres = _solve(J, J.models.MatrixProblem(m), n, nroot, options)
    tres = _solve(T, T.models.MatrixProblem(m, device="cpu"), n, nroot, options, device="cpu")
    converged = "max_iter=3" not in options
    _compare(jres, tres, np.linalg.eigvalsh(m)[:nroot] if converged else None, nroot)
    if "max_size_qspace=4" in options:
        assert tres[0].stats.q_deletions > 0 and tres[0].stats.d_creations > 0
    if "max_p" in options:
        assert tres[0].xspace.dimensions.nP > 0


def test_bsr_problem():
    """A BSR ``Problem`` (the port's action is K6's wrapper, which takes the
    plain version on the CPU) on synthetic_fci_bsr(512, 32)."""
    jp, tp, dense = _bsr_problems()
    launches = tspmv.LAUNCHES["bsr"]
    jres = _solve(J, jp, 512, 4, "convergence_threshold=1e-9")
    tres = _solve(T, tp, 512, 4, "convergence_threshold=1e-9", device="cpu")
    _compare(jres, tres, np.linalg.eigvalsh(dense)[:4], 4)
    assert tres[1] and tspmv.LAUNCHES["bsr"] == launches


@pytest.mark.parametrize("factor", [0.0, 0.1])
def test_nonhermitian_matrix(factor):
    n, nroot = 48, 2
    m = _nonsym(n, 4, factor)
    jres = _solve(J, J.models.MatrixProblem(m), n, nroot, hermitian=False)
    tres = _solve(T, T.models.MatrixProblem(m, device="cpu"), n, nroot, hermitian=False,
                  device="cpu")
    ref = np.sort(np.linalg.eigvals(m).real)[:nroot]
    _compare(jres, tres, ref, nroot)


@pytest.mark.parametrize("nroot,nrows", [(6, 2), (4, 1)])
def test_more_roots_than_working_rows(nroot, nrows):
    """The batched construction (core.py, ``_solve_working_set_batched``)
    spills each batch to the native VecStore."""
    n = 64
    m = _sym(n, 7)
    opts = "convergence_threshold=1e-9,max_iter=300"
    jres = _solve(J, J.models.MatrixProblem(m), n, nroot, opts, nrows=nrows)
    tres = _solve(T, T.models.MatrixProblem(m, device="cpu"), n, nroot, opts, nrows=nrows,
                  device="cpu")
    _compare(jres, tres, np.linalg.eigvalsh(m)[:nroot], nroot)
    assert tres[0].stats.q_creations >= 2 * nroot
    np.testing.assert_allclose(tres[2].numpy(), np.asarray(jres[2]), rtol=0, atol=1e-8)


@pytest.mark.parametrize("lam", [0.05, 0.1])
def test_rspt(lam):
    n = 10
    rng = np.random.default_rng(0)
    v = rng.standard_normal((n, n)) * 0.2
    h = np.diag(np.arange(1.0, n + 1.0)) + lam * (v + v.T)
    opts = "convergence_threshold=1e-12,max_iter=40"
    js, jconv, _ = _solve(J, J.models.MatrixProblem(h), n, 1, opts, method="RSPT")
    ts, tconv, _ = _solve(T, T.models.MatrixProblem(h, device="cpu"), n, 1, opts,
                          method="RSPT", device="cpu")
    assert tconv == jconv
    np.testing.assert_allclose(ts.rspt_values, js.rspt_values, rtol=0, atol=1e-10)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert abs(sum(ts.rspt_values) - np.linalg.eigvalsh(h)[0]) < 1e-4


def test_solution_and_p_space_suggestion():
    n, nroot = 40, 2
    m = _sym(n, 8)
    js, _, jx = _solve(J, J.models.MatrixProblem(m), n, nroot)
    ts, _, tx = _solve(T, T.models.MatrixProblem(m, device="cpu"), n, nroot, device="cpu")
    tp, tr = ts.solution([0, 1])
    jp, jr = js.solution([0, 1])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-10)
    explicit = tp.numpy() @ m.T - ts.eigenvalues()[:2, None] * tp.numpy()
    np.testing.assert_allclose(tr.numpy(), explicit, rtol=0, atol=1e-8)
    assert ts.suggest_p(tp, tr, 3, 0.0) == js.suggest_p(jp, jr, 3, 0.0)


def test_problem_self_test_and_precondition():
    m = _sym(12, 9)
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        problem = mod.models.MatrixProblem(m, **kw)
        problem.test_parameters = lambda i: None if i > 2 else np.random.default_rng(i).standard_normal(12)
        solver = mod.create_linear_eigensystem(12, 1, **kw)
        assert solver.test_problem(problem)
    r = np.random.default_rng(10).standard_normal((2, 12))
    tp = T.models.MatrixProblem(m, device="cpu").precondition(
        torch.as_tensor(r), np.array([0.5, 1.5]))
    jp = J.models.MatrixProblem(m).precondition(r, np.array([0.5, 1.5]))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("bad", ["max_iter=3,oops", "max_size_qspace"])
def test_malformed_options_raise_as_jax(bad):
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="malformed option"):
            mod.create_linear_eigensystem(8, 1, "Davidson", bad, **kw)


def test_unknown_method_raises_as_jax():
    errors = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.create_linear_eigensystem(8, 1, "Lanczos", **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "Unknown LinearEigensystem method: Lanczos"


def test_unported_entry_points_name_their_item():
    # linear equations (ROADMAP item 3) and the nonlinear families (item 4)
    # are ported; every family's sharding is too (items 6b and 6c, held
    # against JAX in tests/test_torch_sharded_solvers.py and
    # _sharded_families.py) and takes a parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        T.create_linear_equations(8, 1, sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="Sharding"):
        T.create_optimize(8, "BFGS", sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="Sharding"):
        T.create_nonlinear_equations(8, sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="Sharding"):
        T.create_linear_eigensystem(8, 1, sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="Sharding"):
        T.create_linear_eigensystem(8, 1, "RSPT", sharding=object(), device="cpu")
    # the offload store (item 6a) is ported: offload=True now builds it
    from iterative_solver_torch.array.offload_store import OffloadBasisStore

    solver = T.create_linear_eigensystem(8, 1, offload=True, device="cpu")
    assert isinstance(solver.xspace.store_v, OffloadBasisStore)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.create_linear_eigensystem(8, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.models.MatrixProblem(np.eye(8))


def test_vecstore_round_trip(tmp_path):
    from iterative_solver_torch.native.vecstore import VecStore

    rng = np.random.default_rng(11)
    rows = rng.standard_normal((5, 33))
    store = VecStore(6, 33)
    try:
        slots = [store.append(r) for r in rows]
        np.testing.assert_array_equal(store.get(slots[2]), rows[2])
        x = rng.standard_normal((2, 33))
        np.testing.assert_allclose(store.gram(x, slots), x @ rows.T, rtol=1e-13)
        c = rng.standard_normal((3, 5))
        np.testing.assert_allclose(store.combine(c, slots), c @ rows, rtol=1e-13, atol=1e-13)
        store.axpy(slots[0], 2.0, rows[1])
        store.scale(slots[0], 0.5)
        np.testing.assert_allclose(store.get(slots[0]), 0.5 * (rows[0] + 2.0 * rows[1]))
        assert store.dot(slots[1], slots[1]) == pytest.approx(rows[1] @ rows[1])
        with pytest.raises(ValueError):
            store.put(slots[0], rows[0][:5])
    finally:
        store.close()
