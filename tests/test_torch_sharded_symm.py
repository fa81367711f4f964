"""The port's sharded packed-triangle action (parallel/sharded_symm.py)
against the JAX package's on a 4-device mesh.

The port runs in 4 gloo ranks spawned once for this file
(tests/torch_shard_worker.py, torch only, CPU). Each rank's tiles, ii and
jj equal the JAX shard's rows [r max_p, r max_p + k_r) (the port drops the
zero padding); the actions match JAX's (float64 within 1e-12, int8 bit for
bit); the sharded solves take JAX's iteration counts (the cases of
tests/test_sharded_symm.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_shard_worker as W
from iterative_solver_tpu.ops.kernels.symm_int8 import (
    SymmetricBlockedInt8,
    SymmetricBlockedInt8Split,
)
from iterative_solver_tpu.ops.kernels.symm_pallas import SymmetricBlocked, SymmetricBlockedSplit
from iterative_solver_tpu.parallel import make_mesh
from iterative_solver_tpu.parallel.sharded_symm import ShardedSymmetric
from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

WORLD = 4
CASES = ["symm_f64", "symm_split", "symm_int8", "symm_int8_split", "symm_int8_diag_once",
         "symm_refusals", "symm_davidson", "symm_int8_davidson", "symm_from_dense_tiers"]
N, B = 256, 32


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_symm")
    W.run_workers(out, WORLD, CASES)
    return {c: [W.load(out, c, r) for r in range(WORLD)] for c in CASES}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def _jax_case(mesh, tier):
    seed = {"symm_f64": 0, "symm_split": 5, "symm_int8": 10, "symm_int8_split": 10}[tier]
    mat = W.dense_problem(N, seed=seed)
    if tier == "symm_f64":
        s = ShardedSymmetric.from_symmetric(SymmetricBlocked.from_dense(mat, b=B), mesh)
        x = np.random.default_rng(1).standard_normal((3, N))
    elif tier == "symm_split":
        s = ShardedSymmetric.from_split(SymmetricBlockedSplit.from_dense(mat, b=B), mesh)
        x = np.random.default_rng(6).standard_normal((3, N)).astype(np.float32)
    else:
        cls = SymmetricBlockedInt8Split if tier == "symm_int8_split" else SymmetricBlockedInt8
        s = ShardedSymmetric.from_int8(cls.from_dense(mat, b=B), mesh)
        x = np.random.default_rng(11).standard_normal((3, N)).astype(np.float32)
    matvec, op = s.matvec_fn()
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, s.axis)))
    y = np.asarray(jax.jit(matvec)(xs, op), dtype=np.float64)
    return s, y, x, mat


TIERS = ["symm_f64", "symm_split", "symm_int8", "symm_int8_split"]


@pytest.mark.parametrize("tier", TIERS)
def test_rank_tiles_equal_the_jax_shard(ranks, mesh, tier):
    s, _, _, _ = _jax_case(mesh, tier)
    max_p = s.pairs_per_dev
    values = np.asarray(s.values.astype(jnp.float32) if s.gq is None else s.values)
    ii, jj = np.asarray(s.ii), np.asarray(s.jj)
    n_pairs = (N // B) * (N // B + 1) // 2
    diag = np.asarray(s.diagonal, dtype=np.float64)
    for r, res in enumerate(ranks[tier]):
        k = len(range(r, n_pairs, WORLD))
        rows = slice(r * max_p, r * max_p + k)
        assert int(res["max_p"][0]) == max_p and res["values"].shape[0] == k
        np.testing.assert_array_equal(res["values"], values[rows])
        np.testing.assert_array_equal(res["ii"], ii[rows])
        np.testing.assert_array_equal(res["jj"], jj[rows])
        np.testing.assert_array_equal(res["diagonal"], diag[r * N // WORLD:(r + 1) * N // WORLD])
        if s.lo is not None:
            lo = np.asarray(s.lo.astype(jnp.float32) if s.gq is None else s.lo)
            np.testing.assert_array_equal(res["lo"], lo[rows])
        if s.gq is not None:
            np.testing.assert_array_equal(res["gq"], np.asarray(s.gq))


@pytest.mark.parametrize("tier", ["symm_f64", "symm_split"])
def test_rank_walk_lists_come_from_its_own_pairs(ranks, tier):
    """K1/K3's work and sum lists are built with the shard, from the rank's
    own pairs (not padded to max_p), so no matvec rebuilds them."""
    from iterative_solver_torch.ops.kernels.symm import square_sum_list, square_work_list

    for res in ranks[tier]:
        work = square_work_list(res["ii"], res["jj"], B)
        np.testing.assert_array_equal(res["work"], work)
        np.testing.assert_array_equal(res["sums"],
                                      square_sum_list(work, res["ii"], res["jj"], B, N))


@pytest.mark.parametrize("tier", TIERS)
def test_sharded_action_matches_jax(ranks, mesh, tier):
    _, y, x, mat = _jax_case(mesh, tier)
    for r, res in enumerate(ranks[tier]):
        if tier == "symm_f64":
            np.testing.assert_allclose(res["y"], y, rtol=0, atol=1e-12)
            np.testing.assert_allclose(res["y"], x @ mat, rtol=0, atol=1e-10)
        elif tier == "symm_split":
            # float32 sums in another order than XLA's
            np.testing.assert_allclose(res["y"], y, rtol=0, atol=1e-5 * np.abs(y).max())
            ref = x.astype(np.float64) @ mat
            assert np.abs(res["y"] - ref).max() / np.abs(ref).max() < 1e-4
        else:
            # the ranks' float32 parts are added in another order than
            # XLA's reduce-scatter: within a few ulps of JAX's y
            np.testing.assert_allclose(res["y"], y, rtol=1e-6, atol=1e-6 * np.abs(y).max())


@pytest.mark.parametrize("tier", ["symm_int8", "symm_int8_split"])
def test_sharded_int8_partials_equal_jax_bit_for_bit(ranks, mesh, tier):
    """Each rank's partial sum before the reduction: exact int32 sums over
    the JAX shard's pairs, dequantised by the same float32 operations."""
    from iterative_solver_tpu.ops.kernels.symm_int8 import (
        _symm_matmat_int8_xla,
        quantize_rows,
        quantize_rows_split,
    )

    s, _, x, _ = _jax_case(mesh, tier)
    nb, max_p = N // B, s.pairs_per_dev
    xf = jnp.asarray(x, jnp.float32)
    gq = s.gq
    n_pairs = nb * (nb + 1) // 2
    for r, res in enumerate(ranks[tier]):
        k = len(range(r, n_pairs, WORLD))
        rows = slice(r * max_p, r * max_p + k)
        ii, jj = s.ii[rows], s.jj[rows]
        if s.lo is not None:
            p1, p2, sx = quantize_rows_split(xf * gq[None, :])
            a1 = _symm_matmat_int8_xla(p1, s.values[rows], (ii, jj), B, nb)
            a2 = _symm_matmat_int8_xla(p1, s.lo[rows], (ii, jj), B, nb)
            a2 = a2 + _symm_matmat_int8_xla(p2, s.values[rows], (ii, jj), B, nb)
            want = (a1.astype(jnp.float32) + a2.astype(jnp.float32) * (1.0 / 254.0)) \
                * sx * gq[None, :]
        else:
            qx, sx = quantize_rows(xf * gq[None, :])
            acc = _symm_matmat_int8_xla(qx, s.values[rows], (ii, jj), B, nb)
            want = acc.astype(jnp.float32) * sx * gq[None, :]
        np.testing.assert_array_equal(res["partial"], np.asarray(want, np.float64),
                                      err_msg=f"rank {r}")


def test_int8_diagonal_applies_once(ranks):
    n = 128
    d = np.linspace(-2.0, 30.0, n)
    x = np.random.default_rng(12).standard_normal((2, n)).astype(np.float32)
    for res in ranks["symm_int8_diag_once"]:
        np.testing.assert_allclose(res["y"], x.astype(np.float64) * d, rtol=2e-6)
        assert tuple(res["width"]) == (2, n // WORLD)


def test_indivisible_dimension_is_refused(ranks):
    for res in ranks["symm_refusals"]:
        assert int(res["raised"][0]) == 1 and "must divide over 4 devices" in str(res["msg"])


def _jax_davidson(mesh, int8):
    n, nroots = N, 3
    mat = W.dense_problem(n, seed=13 if int8 else 4)
    if int8:
        s = ShardedSymmetric.from_int8(SymmetricBlockedInt8Split.from_dense(mat, b=B), mesh)
    else:
        s = ShardedSymmetric.from_symmetric(SymmetricBlocked.from_dense(mat, b=B), mesh)
    matvec, op = s.matvec_fn()
    kw = (dict(m_max=24, dtype=jnp.float32, convergence_threshold=1e-4) if int8
          else dict(m_max=6 * nroots, convergence_threshold=1e-9))
    solver = FusedDavidson(matvec, np.diag(mat), n, nroots, max_iter=200, operand=op,
                           sharding=NamedSharding(mesh, P(None, s.axis)), **kw)
    v0 = W.unit_guess(np.diag(mat), nroots)
    evals, x, errors, iters = solver.run_on_device(v0) if int8 else solver.run(v0)
    return np.asarray(evals), int(iters), solver.matvecs, mat


def test_sharded_davidson_matches_jax(ranks, mesh):
    evals, iters, matvecs, mat = _jax_davidson(mesh, False)
    first = ranks["symm_davidson"][0]
    for res in ranks["symm_davidson"]:
        assert int(res["iters"][0]) == iters and int(res["matvecs"][0]) == matvecs
        np.testing.assert_allclose(res["evals"], evals, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(res["evals"], first["evals"])   # every rank alike
        np.testing.assert_array_equal(res["x"], first["x"])
    assert np.max(first["errors"]) < 1e-9
    np.testing.assert_allclose(np.sort(first["evals"]), np.linalg.eigvalsh(mat)[:3], atol=1e-8)


def test_sharded_int8_davidson_matches_jax(ranks, mesh):
    evals, iters, _, mat = _jax_davidson(mesh, True)
    first = ranks["symm_int8_davidson"][0]
    for res in ranks["symm_int8_davidson"]:
        np.testing.assert_array_equal(res["evals"], first["evals"])
    # float32 sums in another order: the iteration count within 2 of JAX's
    assert abs(int(first["iters"][0]) - iters) <= 2
    assert np.max(first["errors"]) < 1e-4
    np.testing.assert_allclose(first["evals"], evals, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.sort(first["evals"]), np.linalg.eigvalsh(mat)[:3], atol=1e-4)


@pytest.mark.parametrize("tier,atol", [("exact", 1e-10), ("fast", 1e-3), ("precise", 1e-6),
                                       ("int8", 1e-3), ("int8_precise", 1e-6)])
def test_from_dense_symmetric_sharded_matches_single_rank(ranks, tier, atol):
    for res in ranks["symm_from_dense_tiers"]:
        s_it = int(res[f"{tier}_sharded_iters"][0])
        o_it = int(res[f"{tier}_single_iters"][0])
        assert abs(s_it - o_it) <= (0 if tier == "exact" else 2), (s_it, o_it)
        np.testing.assert_allclose(res[f"{tier}_sharded_evals"], res[f"{tier}_single_evals"],
                                   rtol=0, atol=atol)
