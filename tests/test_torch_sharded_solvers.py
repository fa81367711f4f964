"""The port's sharded solvers against the JAX package's: FusedDavidson,
FusedPPCG, FusedLinearEquations and FusedBlockCG under ``sharding=`` with a
row-sharded dense or packed action, the parity eigensolver and linear
equations with sharded stores, sharded checkpoints (read back by the JAX
package), and the multi-host phases (tests/multihost_worker.py) over 2
ranks.

The port runs in gloo ranks spawned once for this file
(tests/torch_shard_worker.py, torch only, float64 on the CPU): 4 ranks for
the solver cases, 2 for the multi-host ones. The JAX side runs here on as
many devices of the conftest's 8-device CPU mesh (the cases of
tests/test_fused_davidson.py:62-114, test_fused_ppcg.py:196-217,
test_fused_cg.py:95-117 and test_multihost.py). Every rank returns the
same bits; iteration counts and ``stats`` equal JAX's; eigenvalues within
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import iterative_solver_tpu as its
import torch_shard_worker as W
from iterative_solver_tpu.parallel import block_sharding, make_mesh, matrix_row_sharding
from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson
from iterative_solver_tpu.solvers.fused_ppcg import FusedPPCG

WORLD = 4
CASES = ["dense_davidson", "dense_davidson_rr", "ppcg", "parity_eigen", "parity_lineq",
         "fused_cg", "fused_linear", "checkpoint"]
PREC = jax.lax.Precision.HIGHEST


def _matvec(x, op):
    return jnp.matmul(x, op.T, precision=PREC)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_solvers")
    W.run_workers(out, WORLD, CASES)
    W.run_workers(out, 2, ["multihost"])
    res = {c: [W.load(out, c, r) for r in range(WORLD)] for c in CASES}
    res["multihost"] = [W.load(out, "multihost", r) for r in range(2)]
    res["out"] = out
    return res


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def _same_on_every_rank(results, *keys):
    for res in results[1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], results[0][k], err_msg=k)


def test_fused_davidson_sharded_matches_jax(ranks, mesh):
    n, nroots = 128, 2
    mat = W.davidson_matrix(n, seed=3)
    op = jax.device_put(jnp.asarray(mat), matrix_row_sharding(mesh))
    solver = FusedDavidson(_matvec, np.diag(mat), n, nroots, m_max=16,
                           sharding=block_sharding(mesh), operand=op)
    evals, x, errors, iters = solver.run(W.unit_guess(np.diag(mat), nroots))
    res = ranks["dense_davidson"]
    _same_on_every_rank(res, "evals", "errors", "x")
    first = res[0]
    assert int(first["iters"][0]) == int(iters)
    assert int(first["matvecs"][0]) == solver.matvecs
    np.testing.assert_allclose(first["evals"], np.asarray(evals), rtol=0, atol=1e-10)
    np.testing.assert_allclose(first["evals"], np.linalg.eigvalsh(mat)[:nroots], atol=1e-9)
    assert np.all(first["errors"] <= 1e-8)
    # x comes back gathered, as np.asarray of JAX's global array
    assert first["x"].shape == (nroots, n)
    overlap = np.abs(np.sum(first["x"] * np.asarray(x), axis=1))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-8)


@pytest.mark.parametrize("tag", ["window3", "pspace", "anchored"])
def test_fused_davidson_sharded_modes_match_one_rank(ranks, tag):
    for res in ranks["dense_davidson_rr"]:
        assert int(res[f"{tag}_sharded_iters"][0]) == int(res[f"{tag}_single_iters"][0])
        np.testing.assert_allclose(res[f"{tag}_sharded_evals"], res[f"{tag}_single_evals"],
                                   rtol=0, atol=1e-10)
    _same_on_every_rank(ranks["dense_davidson_rr"], f"{tag}_sharded_evals")


def test_fused_ppcg_sharded_matches_jax(ranks, mesh):
    n, r = 256, 4
    mat = W.ppcg_matrix(n, seed=10)
    mshard = jax.device_put(jnp.asarray(mat), NamedSharding(mesh, P(None, "data")))
    sharded = FusedPPCG(_matvec, np.diag(mat), n, r, rr_every=5, convergence_threshold=1e-10,
                        max_iter=300, operand=mshard,
                        sharding=NamedSharding(mesh, P(None, "data")))
    ev, x, err, it = sharded.run(W.unit_guess(np.diag(mat), r))
    res = ranks["ppcg"]
    _same_on_every_rank(res, "sharded_evals", "sharded_errors", "sharded_x")
    first = res[0]
    assert int(first["sharded_iters"][0]) == int(it) == int(first["single_iters"][0])
    np.testing.assert_allclose(first["sharded_evals"], np.asarray(ev), rtol=0, atol=1e-10)
    np.testing.assert_allclose(first["sharded_evals"], first["single_evals"], rtol=0,
                               atol=1e-10)
    assert first["sharded_x"].shape == (r, n)


def test_parity_eigensolver_sharded_matches_jax(ranks, mesh):
    n = 64
    mat = W.davidson_matrix(n, seed=4)
    problem = its.models.MatrixProblem(mat, sharding=matrix_row_sharding(mesh))
    solver = its.create_linear_eigensystem(n, 2, "Davidson", sharding=block_sharding(mesh))
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    conv, *_ = solver.solve(np.zeros((2, n)), problem=problem, generate_initial_guess=True)
    assert conv
    res = ranks["parity_eigen"]
    _same_on_every_rank(res, "evals", "errors", "stats")
    first = res[0]
    assert bool(first["conv"][0])
    np.testing.assert_array_equal(
        first["stats"], [getattr(solver.stats, f) for f in W.STAT_FIELDS])
    np.testing.assert_allclose(first["evals"][:2], solver.eigenvalues()[:2], rtol=0, atol=1e-10)
    np.testing.assert_allclose(first["evals"][:2], np.linalg.eigvalsh(mat)[:2], atol=2e-9)
    # the returned blocks are each rank's slices
    assert tuple(first["x_width"]) == (2, n // WORLD)


def test_parity_linear_equations_sharded_matches_jax(ranks):
    n = 64
    mat = W.spd_matrix(n, seed=8)
    b = np.random.default_rng(9).standard_normal((2, n))
    solver = its.create_linear_equations(n, 2, "Davidson", "max_p=4")
    solver.add_equations(b)
    solver.verbosity = its.Verbosity.NONE
    conv, *_ = solver.solve(np.zeros((2, n)), problem=its.models.MatrixProblem(mat),
                            generate_initial_guess=True)
    want = np.asarray(solver.solution_params([0, 1]))
    res = ranks["parity_lineq"]
    _same_on_every_rank(res, "x", "errors", "stats")
    first = res[0]
    assert bool(first["conv"][0]) == bool(conv)
    np.testing.assert_array_equal(
        first["stats"], [getattr(solver.stats, f) for f in W.STAT_FIELDS])
    np.testing.assert_allclose(first["x"], want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(first["x"] @ mat, b, atol=1e-7)


def test_two_rank_multihost_phases(ranks):
    """multihost_worker.py's phases on two ranks: the dense row-sharded
    solve (its iteration count against JAX's on a 2-device mesh), the packed
    sharded action and the int8 sharded BSR action."""
    from iterative_solver_tpu.solvers.fused_davidson import make_davidson_init, make_davidson_solve

    n, nroots, m_max = 512, 4, 16
    mat = W.multihost_matrix(n)
    jmesh = make_mesh(jax.devices()[:2])
    cols = NamedSharding(jmesh, P(None, "data"))
    mj = jax.device_put(jnp.asarray(mat), cols)
    diag = jax.device_put(jnp.diagonal(jnp.asarray(mat)), NamedSharding(jmesh, P("data")))
    v0 = jax.device_put(jnp.asarray(W.unit_guess(np.diag(mat), nroots)), cols)
    final, iters = make_davidson_solve(_matvec, nroots, m_max)(
        make_davidson_init(_matvec, nroots, m_max)(v0, mj), mj, diag, 1e-10, 200)
    res = ranks["multihost"]
    _same_on_every_rank(res, "evals", "errors", "iters")
    first = res[0]
    assert int(first["iters"][0]) == int(iters)
    np.testing.assert_allclose(first["evals"], np.asarray(final.evals), rtol=0, atol=1e-10)
    assert np.max(np.abs(np.sort(first["evals"]) - np.linalg.eigvalsh(mat)[:nroots])) < 1e-9
    assert float(first["errors"].max()) <= 1e-10
    assert float(first["packed_err"][0]) < 1e-10
    assert float(first["int8_err"][0]) <= 1e-4 * float(first["int8_scale"][0])


def test_fused_cg_sharded_matches_jax(ranks, mesh):
    from iterative_solver_tpu.solvers.fused_cg import FusedBlockCG

    n, nrhs = 256, 2
    mat = W.spd_matrix(n, seed=9)
    b = np.random.default_rng(10).standard_normal((nrhs, n))
    cols = NamedSharding(mesh, P(None, "data"))
    solver = FusedBlockCG(_matvec, np.diag(mat), n, nrhs, convergence_threshold=1e-11,
                          operand=jax.device_put(jnp.asarray(mat), cols), sharding=cols)
    x, errors, iters = solver.solve(b)
    res = ranks["fused_cg"]
    _same_on_every_rank(res, "x", "errors", "iters")
    assert int(res[0]["iters"][0]) == int(iters)
    np.testing.assert_allclose(res[0]["x"], np.asarray(x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[0]["x"] @ mat, b, atol=1e-9)


def test_fused_linear_sharded_matches_jax(ranks):
    from iterative_solver_tpu.solvers.fused_linear import FusedLinearEquations

    n, nrhs = 256, 2
    mat = W.spd_matrix(n, seed=9)
    b = np.random.default_rng(10).standard_normal((nrhs, n))
    p_idx = [3, 17, 40]
    packed = FusedLinearEquations.from_dense_symmetric(
        mat, nrhs, tier="exact", b=32, m_max=12, convergence_threshold=1e-10)
    dense = FusedLinearEquations(_matvec, np.diag(mat), n, nrhs, m_max=14,
                                 convergence_threshold=1e-10, operand=jnp.asarray(mat),
                                 p_space=[{i: 1.0} for i in p_idx], p_actions=mat[p_idx])
    res = ranks["fused_linear"]
    for tag, solver in (("packed", packed), ("pspace", dense)):
        x, errors, iters = solver.solve(b)
        _same_on_every_rank(res, f"{tag}_x", f"{tag}_errors")
        assert int(res[0][f"{tag}_iters"][0]) == int(iters), tag
        np.testing.assert_allclose(res[0][f"{tag}_x"], np.asarray(x), rtol=0, atol=1e-9)


def test_sharded_checkpoints_resume_and_load_in_jax(ranks):
    from iterative_solver_tpu.utils.checkpoint import load_checkpoint, load_fused_state

    res = ranks["checkpoint"]
    _same_on_every_rank(res, "evals", "whole_evals", "parity_s")
    first = res[0]
    # the interrupted and resumed run takes the uninterrupted run's path
    assert int(first["iters"][0]) == int(first["whole_iters"][0])
    np.testing.assert_array_equal(first["evals"], first["whole_evals"])
    n = 128
    np.testing.assert_allclose(first["evals"], np.linalg.eigvalsh(W.davidson_matrix(n, 6))[:2],
                               atol=1e-9)
    # rank 0 wrote the gathered state: whole stacks, in the JAX layout
    state, meta = load_fused_state(str(ranks["out"] / "fused_ck.npz"))
    assert state.v.shape == (8, n) and state.x.shape == (2, n)
    assert meta["nroots"] == 2
    jax_solver = load_checkpoint(str(ranks["out"] / "parity_ck.npz"))
    np.testing.assert_allclose(jax_solver.xspace.s, first["parity_s"], rtol=0, atol=1e-14)
    # the loaded sharded stores hold each rank's slice
    for r, out in enumerate(res):
        assert int(out["parity_width"][0]) == n // WORLD
        q = np.asarray(jax_solver.xspace.store_v.rows(
            [s_[0] for s_ in jax_solver.xspace.q_slots]))
        np.testing.assert_array_equal(out["parity_q"], q[:, r * n // WORLD:(r + 1) * n // WORLD])
