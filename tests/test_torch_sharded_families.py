"""The port's remaining families under ``sharding=`` against the JAX
package's: FusedLBFGS, FusedDIIS, EigenpairRefiner over a sharded
SplitOperator, FusedNonSymDavidson / FusedNonSymLinearEquations (a
row-sharded dense operator, and DenseInt8Split.shard), RSPT, OptimizeBFGS,
OptimizeSD, NonLinearEquationsDIIS, BandedEigensolver, the
Chebyshev-filtered Davidson and the parity solve through sharded offload
stores; and the reducing vector_ops (select_max_dot, fused_dot, the
optimiser's two-loop dots).

The port runs in 4 gloo ranks spawned once for this file
(tests/torch_shard_worker.py, torch only, float64 on the CPU unless a case
says otherwise); the JAX side runs here on 4 devices of the conftest's CPU
mesh, with the JAX files' own sharded cases where they have one
(test_fused_diis.py:143-163, test_dense_int8.py:141-165,
test_chebyshev.py:139-156, test_offload_store.py's streamed store) and the
same solve on ``block_sharding`` where they have none. Every rank returns
the same bits. Tolerances: iteration counts and ``stats`` equal JAX's,
eigenvalues and solutions within 1e-10, except the float32 int8 device-RR
solve (ROADMAP.md Queue 3: float32 counts split at the two-plane floor),
held to the JAX test's bounds and to the unsharded port's eigenvalues.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import iterative_solver_tpu as its
import torch_shard_worker as W
from iterative_solver_tpu.parallel import block_sharding, make_mesh, matrix_row_sharding
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

WORLD = 4
CASES = ["family_vector_ops", "family_lbfgs", "family_diis", "family_refine",
         "family_nonsym_int8", "family_nonsym", "family_parity", "family_banded",
         "family_chebyshev", "family_offload"]
PREC = jax.lax.Precision.HIGHEST


def _matvec(x, op):
    return jnp.matmul(x, op.T, precision=PREC)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_families")
    W.run_workers(out, WORLD, CASES)
    return {c: [W.load(out, c, r) for r in range(WORLD)] for c in CASES}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def _same_on_every_rank(results):
    for res in results[1:]:
        for k in results[0]:
            np.testing.assert_array_equal(res[k], results[0][k], err_msg=k)


def _stats(solver):
    return [getattr(solver.stats, f) for f in W.STAT_FIELDS]


@pytest.mark.parametrize("case", CASES)
def test_every_rank_has_the_same_bits(ranks, case):
    _same_on_every_rank(ranks[case])


def test_select_max_dot_fused_dot_and_two_loop_dots(ranks):
    res = ranks["family_vector_ops"][0]
    for n in (32, 30):
        rng = np.random.default_rng(n)
        x, y = rng.standard_normal(n), rng.standard_normal(n)
        y[3] = x[3] = 2.0
        x[17], y[17] = 4.0, 1.0
        prod = np.abs(x * y)
        # largest first, ties to the lower index (30: uneven chunks of 8)
        want = np.lexsort((np.arange(n), -prod))[:5]
        np.testing.assert_array_equal(res[f"smd{n}_idx"], want)
        np.testing.assert_array_equal(res[f"smd{n}_vals"], prod[want])
    np.testing.assert_allclose(res["fused_dot"], res["fused_dot_single"], rtol=0, atol=1e-13)
    for key in ("fwd", "alphas", "bwd"):
        np.testing.assert_allclose(res[key], res[f"{key}_single"], rtol=0, atol=1e-11)


def test_fused_lbfgs_sharded_matches_jax(ranks, mesh):
    from iterative_solver_tpu.solvers.fused_lbfgs import FusedLBFGS

    n = 64
    hess = W.spd_hessian(n, seed=4)
    b = jnp.asarray(np.linspace(0.5, 1.5, n))

    def vg(x, h):
        d = x - b
        g = jnp.matmul(h, d, precision=PREC)
        return 0.5 * jnp.matmul(d, g, precision=PREC), g

    solver = FusedLBFGS(vg, n, operand=jax.device_put(jnp.asarray(hess),
                                                      matrix_row_sharding(mesh)),
                        sharding=block_sharding(mesh), convergence_threshold=1e-6)
    x, f, gnorm, iters = solver.run(np.zeros(n))
    res = ranks["family_lbfgs"][0]
    assert int(res["sharded_iters"][0]) == int(iters) == int(res["single_iters"][0])
    np.testing.assert_allclose(res["sharded_x"], x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["sharded_f"], f, rtol=0, atol=1e-10)
    assert float(res["sharded_gnorm"][0]) <= 1e-6


def test_fused_diis_sharded_matches_jax(ranks, mesh):
    """test_fused_diis.py::test_sharded_matches_single_device on 4 devices."""
    from iterative_solver_tpu.solvers.fused_diis import FusedDIIS

    n = 256
    mat, b = W.quad_operand(n, seed=11)

    def residual(x, op):
        m, eps, bb = op
        return jnp.matmul(m, x, precision=PREC) + eps * x**2 - bb

    cols = block_sharding(mesh)
    solver = FusedDIIS(residual, n, diagonals=np.diag(mat), sharding=cols,
                       operand=(jax.device_put(jnp.asarray(mat), cols), jnp.asarray(0.05),
                                jnp.asarray(b)), convergence_threshold=1e-10)
    x, err, iters = solver.run(np.zeros(n))
    res = ranks["family_diis"][0]
    assert int(res["sharded_iters"][0]) == int(iters) == int(res["single_iters"][0])
    np.testing.assert_allclose(res["sharded_x"], x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["sharded_x"], res["single_x"], rtol=0, atol=1e-9)
    assert float(res["sharded_err"][0]) < 1e-10


def test_refiner_over_sharded_split_operator_matches_jax(ranks, mesh):
    from iterative_solver_tpu.ops.precise import SplitOperator, precise_matvec_fn
    from iterative_solver_tpu.solvers.refine import EigenpairRefiner

    n, nroots = 128, 3
    mat = W.davidson_matrix(n, seed=8)
    op = SplitOperator.from_dense(mat, n_chunks=8, sharding=matrix_row_sharding(mesh))
    ref = EigenpairRefiner(lambda x: x @ mat.T, precise_matvec_fn(op), op.operand(),
                           np.diag(mat), n, nroots, sharding=block_sharding(mesh))
    got = ref.refine(W.refine_start(mat, nroots), tol=1e-11)
    res = ranks["family_refine"][0]
    assert int(res["passes"][0]) == got.passes and bool(res["converged"][0]) == got.converged
    # the residual after each pass; the passes below 1e-9 differ in the CG's
    # rounding (sums over ranks, the split-K chunks' order)
    np.testing.assert_allclose(res["history"], got.history, rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(res["evals"], got.eigenvalues, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["evals"], np.linalg.eigvalsh(mat)[:nroots], atol=1e-10)
    assert float(res["resn"].max()) <= 1e-11
    overlap = np.abs(np.sum(res["x"] * got.x, axis=1))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-10)
    # the rank keeps its rows; the sharded split-K action gives x Aᵀ
    assert tuple(res["hi_rows"]) == (n // WORLD, n)
    xs = np.random.default_rng(3).standard_normal((2, n))
    np.testing.assert_allclose(res["y"], xs @ mat.T, rtol=0, atol=1e-12)


def test_sharded_int8_device_rr_solve(ranks, mesh):
    """test_dense_int8.py::test_sharded_int8_device_rr_solve on 4 devices.
    Float32 at tol 5e-5 sits on the two-plane floor, where iteration
    counts split (ROADMAP.md Queue 3): the counts are reported, the bounds
    are the JAX test's, and the sharded action equals the unsharded one
    bit for bit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iterative_solver_tpu.ops.kernels.dense_int8 import (
        DenseInt8Split,
        dense_int8_matvec_split,
    )
    from iterative_solver_tpu.solvers.fused_nonsym import FusedNonSymDavidson

    m = W.nonsym_op(512, seed=9)
    r = 3
    op = DenseInt8Split.from_dense(m)
    sol = FusedNonSymDavidson(
        lambda x, t: dense_int8_matvec_split(x, t), np.diag(m), m.shape[0], r, m_max=12,
        sharding=NamedSharding(mesh, P(None, "data")), operand=op.shard(mesh),
        convergence_threshold=5e-5, max_iter=100, rr="device", dtype=jnp.float32)
    ev, _, errs, _ = sol.solve(W.unit_guess(np.diag(m), r))
    assert errs.max() <= 5e-5
    res = ranks["family_nonsym_int8"][0]
    ref = np.sort(scipy.linalg.eigvals(m).real)[:r]
    for tag in ("sharded", "single"):
        assert float(res[f"{tag}_errors"].max()) <= 5e-5, tag
        np.testing.assert_array_equal(res[f"{tag}_evals_im"], 0.0)
        assert np.max(np.abs(np.sort(res[f"{tag}_evals_re"]) - ref)) < 1e-4, tag
    np.testing.assert_allclose(res["sharded_evals_re"], np.sort(np.asarray(ev).real),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["sharded_evals_re"], res["single_evals_re"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(res["one_y"], res["one_y_single"])
    np.testing.assert_array_equal(res["two_y"], res["two_y_single"])


@pytest.mark.parametrize("rr", ["host", "device"])
def test_nonsym_families_sharded_match_jax(ranks, mesh, rr):
    from iterative_solver_tpu.solvers.fused_nonsym import (
        FusedNonSymDavidson,
        FusedNonSymLinearEquations,
    )

    m = W.nonsym_op(128, seed=3)
    n, r = m.shape[0], 3
    rows = jax.device_put(jnp.asarray(m), matrix_row_sharding(mesh))
    sh = block_sharding(mesh)
    res = ranks["family_nonsym"][0]
    sol = FusedNonSymDavidson(_matvec, np.diag(m), n, r, m_max=16, operand=rows, sharding=sh,
                              convergence_threshold=1e-9, rr=rr)
    ev, x, errors, iters = sol.solve(W.unit_guess(np.diag(m), r))
    assert int(res[f"eig_{rr}_iters"][0]) == int(iters)
    np.testing.assert_allclose(res[f"eig_{rr}_evals_re"], np.real(ev), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[f"eig_{rr}_evals_im"], np.imag(ev), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[f"eig_{rr}_errors"], errors, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.abs(np.sum(res[f"eig_{rr}_x"] * np.asarray(x), axis=1)),
                               np.sum(np.asarray(x) ** 2, axis=1), rtol=0, atol=1e-8)
    b = np.random.default_rng(5).standard_normal((2, n))
    lin = FusedNonSymLinearEquations(_matvec, np.diag(m), n, 2, m_max=12, operand=rows,
                                     sharding=sh, convergence_threshold=1e-9, rr=rr)
    x, errors, iters = lin.solve(b)
    assert int(res[f"lin_{rr}_iters"][0]) == int(iters)
    np.testing.assert_allclose(res[f"lin_{rr}_x"], np.asarray(x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[f"lin_{rr}_x"] @ m.T, b, atol=1e-8)
    if rr == "device":
        # the checkpointed device-tier solve, resumed under sharding, takes
        # the uninterrupted solve's path
        assert int(res["resumed_iters"][0]) == int(res["eig_device_iters"][0])
        np.testing.assert_array_equal(res["resumed_evals_re"], res["eig_device_evals_re"])


def _jax_parity_optimize(method, n, mesh):
    hess = W.optimize_hessian(n, 0.1 if method == "BFGS" else 0.01)
    b = np.linspace(0.5, 1.5, n)
    solver = its.create_optimize(n, method, "max_size_qspace=8" if method == "BFGS" else "",
                                 sharding=block_sharding(mesh))
    solver.verbosity = its.Verbosity.NONE
    solver.convergence_threshold = 1e-10
    solver.max_iter = 300
    conv, x, _ = solver.solve(np.zeros((1, n)),
                              problem=its.models.QuadraticOptimizeProblem(hess, b))
    return solver, conv, np.asarray(x)[0]


@pytest.mark.parametrize("family", ["rspt", "BFGS", "SD", "diis"])
def test_parity_families_sharded_match_jax(ranks, mesh, family):
    """JAX's run of the same problem on ``block_sharding`` of the mesh (the
    JAX files have no sharded case of these families); the port's ranks
    hold their slices and write the problems per slice."""
    res = ranks["family_parity"][0]
    if family == "rspt":
        n = 16
        h = W.rspt_matrix(n)
        solver = its.create_linear_eigensystem(n, 1, "RSPT",
                                               "convergence_threshold=1e-12,max_iter=40",
                                               sharding=block_sharding(mesh))
        solver.verbosity = its.Verbosity.NONE
        conv, _, _ = solver.solve(
            np.zeros((1, n)), problem=its.models.MatrixProblem(
                h, sharding=matrix_row_sharding(mesh)), generate_initial_guess=True)
        assert bool(res["rspt_conv"][0]) == bool(conv)
        np.testing.assert_array_equal(res["rspt_stats"], _stats(solver))
        np.testing.assert_allclose(res["rspt_values"], solver.rspt_values, rtol=0, atol=1e-10)
        assert abs(res["rspt_values"].sum() - np.linalg.eigvalsh(h)[0]) < 1e-4
        return
    n = 32
    if family in ("BFGS", "SD"):
        solver, conv, x = _jax_parity_optimize(family, n, mesh)
        assert bool(res[f"{family}_conv"][0]) and conv
        np.testing.assert_array_equal(res[f"{family}_stats"], _stats(solver))
        np.testing.assert_array_equal(res[f"{family}_ls"], [solver.stats.line_searches,
                                                            solver.stats.line_search_steps])
        np.testing.assert_allclose(res[f"{family}_x"][0], x, rtol=0, atol=1e-10)
        assert float(res[f"{family}_value"][0]) == pytest.approx(solver.value, abs=1e-12)
        return
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)) * 0.1
    mat = jnp.asarray(a + a.T + np.diag(np.arange(2.0, n + 2.0)))
    b = jnp.asarray(rng.standard_normal(n))

    class Problem(its.Problem):
        def __init__(self):
            super().__init__()
            self.dimension = n

        def residual(self, x):
            return 0.0, jnp.matmul(mat, x, precision=PREC) + 0.05 * x**2 - b

        def diagonals(self):
            return jnp.diagonal(mat)

    solver = its.create_nonlinear_equations(n, "DIIS", sharding=block_sharding(mesh))
    solver.verbosity = its.Verbosity.NONE
    solver.convergence_threshold = 1e-8
    conv, x, _ = solver.solve(np.zeros((1, n)), problem=Problem())
    assert bool(res["diis_conv"][0]) and conv
    np.testing.assert_array_equal(res["diis_stats"], _stats(solver))
    assert int(res["diis_nq"][0]) == solver.xspace.dimensions.nQ
    np.testing.assert_allclose(res["diis_x"][0], np.asarray(x)[0], rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["device", "streamed"])
def test_banded_sharded_matches_jax(ranks, mesh, mode):
    from iterative_solver_tpu.solvers.banded import BandedEigensolver

    n = 128
    m = W.banded_matrix(n, nlow=12, seed=3)
    solver = BandedEigensolver(_matvec, np.diag(m), n, band=4, m_max=16,
                               convergence_threshold=1e-9, deflate=mode, store_block_rows=3,
                               operand=jax.device_put(jnp.asarray(m),
                                                      matrix_row_sharding(mesh)),
                               sharding=block_sharding(mesh))
    vals, vecs, errs = solver.solve(8)
    res = ranks["family_banded"][0]
    np.testing.assert_allclose(res[f"{mode}_sharded_vals"], vals, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[f"{mode}_sharded_vals"], np.linalg.eigvalsh(m)[:8],
                               atol=1e-9)
    np.testing.assert_allclose(np.abs(np.sum(res[f"{mode}_sharded_vecs"] * vecs, axis=1)),
                               1.0, atol=1e-8)
    # the fused solves' (rows, iterations), sharded as unsharded
    np.testing.assert_array_equal(res[f"{mode}_sharded_runs"], res[f"{mode}_single_runs"])
    np.testing.assert_allclose(res[f"{mode}_sharded_vals"], res[f"{mode}_single_vals"],
                               rtol=0, atol=1e-10)


def test_chebyshev_sharded_mesh_matches_jax(ranks, mesh):
    """test_chebyshev.py::test_chebyshev_sharded_mesh on 4 devices."""
    from iterative_solver_tpu.solvers.chebyshev import make_chebyshev_davidson

    n = 128
    rng = np.random.default_rng(6)
    a = rng.standard_normal((n, n)) * 0.01
    m = a + a.T + np.diag(np.linspace(1.0, 10.0, n))
    solver = make_chebyshev_davidson(
        _matvec, np.diag(m), n, nroots=2, degree=3, m_max=14,
        operand=jax.device_put(jnp.asarray(m), matrix_row_sharding(mesh)),
        sharding=block_sharding(mesh))
    evals, x, errors, iters = solver.run(W.unit_guess(np.diag(m), 2))
    res = ranks["family_chebyshev"][0]
    assert int(res["iters"][0]) == int(iters)
    assert int(res["matvecs"][0]) == solver.matvecs
    np.testing.assert_allclose(res["evals"], np.asarray(evals), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res["evals"], np.linalg.eigvalsh(m)[:2], atol=1e-8)
    assert np.all(res["errors"] <= solver.tol)
    np.testing.assert_allclose(res["bounds"], res["bounds_single"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("store", ["host", "streamed"])
def test_parity_solve_through_sharded_offload_store_matches_jax(ranks, mesh, store):
    """The parity Davidson through a sharded OffloadBasisStore and
    StreamedOffloadStore (test_offload_store.py's streamed case, block_rows
    3), against JAX's solve through the same store form: sharded for the
    host store; unsharded for the streamed one, whose sharded ``combine``
    in the JAX package puts its (m, k) coefficients on the block sharding
    and raises unless k divides by the mesh (ROADMAP.md Queue 3; the port
    keeps them replicated)."""
    from iterative_solver_tpu.array.offload_store import StreamedOffloadStore

    n = 64
    m = W.davidson_matrix(n, seed=4)
    offload = True if store == "host" else (
        lambda capacity, nn, dtype, sharding, name="params":
        StreamedOffloadStore(capacity, nn, dtype=dtype, sharding=sharding, name=name,
                             block_rows=3))
    on_mesh = store == "host"
    solver = its.LinearEigensystemDavidson(
        n, 2, sharding=block_sharding(mesh) if on_mesh else None, offload=offload)
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    conv, _, _ = solver.solve(np.zeros((2, n)), problem=its.models.MatrixProblem(
        m, sharding=matrix_row_sharding(mesh) if on_mesh else None),
        generate_initial_guess=True)
    res = ranks["family_offload"][0]
    assert bool(res[f"{store}_conv"][0]) == bool(conv)
    np.testing.assert_array_equal(res[f"{store}_stats"], _stats(solver))
    np.testing.assert_allclose(res[f"{store}_evals"], np.asarray(solver.eigenvalues())[:2],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[f"{store}_evals"], np.linalg.eigvalsh(m)[:2], atol=1e-9)
    # the store's block numerics, sharded against unsharded on a rank
    tag = "hoststore" if store == "host" else "streamstore"
    for key in ("gram_block", "mgs", "combine", "rows"):
        np.testing.assert_allclose(res[f"{tag}_sharded_{key}"], res[f"{tag}_single_{key}"],
                                   rtol=0, atol=1e-13, err_msg=key)


def test_stats_fields_are_the_jax_package_s():
    from iterative_solver_tpu.utils.statistics import Statistics

    names = {f.name for f in dataclasses.fields(Statistics)}
    assert set(W.STAT_FIELDS) <= names
