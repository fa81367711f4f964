"""The port's row-block-sharded BSR actions (parallel/sharded_bsr.py)
against the JAX package's on a 4-device mesh.

The port runs in 4 gloo ranks spawned once for this file
(tests/torch_shard_worker.py, torch only, CPU). Each rank's padded block
lists equal the JAX shard's; the float action matches JAX's within 1e-12
(even and uneven row-block counts), the int8 action's int32 sums exactly, and the
distributed sparse Davidson takes JAX's iteration count (the cases of
tests/test_sharded_bsr.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_shard_worker as W
from iterative_solver_tpu.models.synthetic_fci import synthetic_fci_bsr
from iterative_solver_tpu.ops.kernels.spmv_pallas import BSRMatrix, BSRMatrixInt8
from iterative_solver_tpu.parallel import block_sharding, make_mesh
from iterative_solver_tpu.parallel.sharded_bsr import ShardedBSR, ShardedBSRInt8
from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson

WORLD = 4
CASES = ["bsr_arrays", "bsr_int8", "bsr_davidson"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_bsr")
    W.run_workers(out, WORLD, CASES)
    return {c: [W.load(out, c, r) for r in range(WORLD)] for c in CASES}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def _jax_float(mesh, tag):
    n, block, seed = (512, 16, 1) if tag == "even" else (336, 16, 2)
    bsr, dense = synthetic_fci_bsr(n, block=block, seed=seed)
    s = ShardedBSR.from_bsr(bsr, mesh)
    matvec, op = s.matvec_fn()
    rng = np.random.default_rng(0 if tag == "even" else 1)
    x = np.zeros((4 if tag == "even" else 2, s.n))
    x[:, :n] = rng.standard_normal((x.shape[0], n))
    y = np.asarray(matvec(jax.device_put(jnp.asarray(x), block_sharding(mesh)), op))
    return s, y, x, dense, n


def _rank_rows(arr, r):
    per = arr.shape[0] // WORLD
    return np.asarray(arr)[r * per:(r + 1) * per]


@pytest.mark.parametrize("tag", ["even", "uneven"])
def test_rank_blocks_equal_the_jax_shard(ranks, mesh, tag):
    s, _, _, _, _ = _jax_float(mesh, tag)
    for r, res in enumerate(ranks["bsr_arrays"]):
        assert tuple(res[f"{tag}_n"]) == (s.n, s.rb_per_dev)
        for f in ("loc_values", "loc_col", "loc_row", "rem_values", "rem_col", "rem_row",
                  "diagonal"):
            np.testing.assert_array_equal(res[f"{tag}_{f}"], _rank_rows(getattr(s, f), r),
                                          err_msg=f"{f}, rank {r}")


@pytest.mark.parametrize("tag", ["even", "uneven"])
def test_sharded_action_matches_jax(ranks, mesh, tag):
    s, y, x, dense, n = _jax_float(mesh, tag)
    for res in ranks["bsr_arrays"]:
        np.testing.assert_allclose(res[f"{tag}_y"], y, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res[f"{tag}_y"][:, :n], x[:, :n] @ dense.T, atol=1e-10)
        # the padded row range stays zero
        np.testing.assert_allclose(res[f"{tag}_y"][:, n:], 0.0, atol=1e-12)


def test_int8_blocks_and_action_match_jax(ranks, mesh):
    mat = W.multihost_matrix(512)
    bsr_q = BSRMatrixInt8.from_bsr(BSRMatrix.from_dense(mat, bm=16, bn=16, tol=0.0))
    s = ShardedBSRInt8.from_int8(bsr_q, mesh)
    mv, op = s.matvec_fn()
    x = np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "data")))
    y = np.asarray(mv(xs, op), dtype=np.float64)
    for r, res in enumerate(ranks["bsr_int8"]):
        for f in ("loc_q", "loc_col", "loc_row", "rem_q", "rem_col", "rem_row", "rq", "cq",
                  "diagonal"):
            np.testing.assert_array_equal(res[f], _rank_rows(getattr(s, f), r),
                                          err_msg=f"{f}, rank {r}")
        # XLA may fuse the dequantisation's multiply-add: a few ulps
        np.testing.assert_allclose(res["y"], y, rtol=1e-6, atol=1e-6 * np.abs(y).max())
        # the int32 sums are exact: the global row scales' int8 x against
        # the dense int8 operator, in integers
        sx = res["sx"]
        assert sx.shape == (3, 1) and np.all(sx > 0)
        np.testing.assert_array_equal(res["acc"], _exact_int8_acc(bsr_q, x, sx))


def _exact_int8_acc(bsr_q, x, sx):
    """acc = qx Qᵀ over the blocks in int64, qx quantized with the given
    (global) row scales as the port and the JAX package quantize."""
    import torch

    xs = torch.as_tensor(x) * torch.as_tensor(np.array(bsr_q.cq))[None, :]
    # the scale of a row is its max over the whole row, on every rank
    np.testing.assert_array_equal(sx[:, 0], (torch.amax(torch.abs(xs), 1) / 127.0).numpy())
    qx = torch.clamp(torch.round(xs / torch.as_tensor(sx)), -127, 127).numpy().astype(np.int64)
    q = np.asarray(bsr_q.q).astype(np.int64)
    rows, cols = np.asarray(bsr_q.row_idx), np.asarray(bsr_q.col_idx)
    bm, bn = bsr_q.bm, bsr_q.bn
    acc = np.zeros((x.shape[0], bsr_q.shape[0]), dtype=np.int64)
    for k in range(q.shape[0]):
        acc[:, rows[k] * bm:(rows[k] + 1) * bm] += qx[:, cols[k] * bn:(cols[k] + 1) * bn] @ q[k].T
    return acc


def test_distributed_sparse_davidson_matches_jax(ranks, mesh):
    n, nroots = 1024, 4
    bsr, dense = synthetic_fci_bsr(n, block=32, seed=3)
    s = ShardedBSR.from_bsr(bsr, mesh)
    matvec, operand = s.matvec_fn()
    diag = np.asarray(s.diagonal)
    solver = FusedDavidson(matvec, diag, s.n, nroots, m_max=24, sharding=block_sharding(mesh),
                           operand=operand, max_iter=100)
    evals, _, errors, iters = solver.run_on_device(W.unit_guess(diag[:n], nroots))
    first = ranks["bsr_davidson"][0]
    for res in ranks["bsr_davidson"]:
        assert int(res["iters"][0]) == int(iters)
        np.testing.assert_array_equal(res["evals"], first["evals"])
        np.testing.assert_allclose(res["evals"], np.asarray(evals), rtol=0, atol=1e-10)
    np.testing.assert_allclose(first["evals"], np.linalg.eigvalsh(dense)[:nroots], atol=1e-8)
    assert np.all(first["errors"] <= 1e-8)
