"""The port's distribution layer against the JAX package's: Distribution,
DistrArray, the mesh helpers and the explicit collectives.

The port runs in 4 gloo ranks spawned once for this file
(tests/torch_shard_worker.py, torch only, float64 on the CPU); the JAX side
runs here on 4 devices of the conftest's 8-device CPU mesh, with the same
seed-made inputs (the cases of tests/test_distr_array.py and
test_fused_davidson.py::test_sharded_collectives_match_local)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_shard_worker as W
from iterative_solver_torch.array import distribution as tdist
from iterative_solver_tpu.array import distribution as jdist
from iterative_solver_tpu.array.distr_array import DistrArray as JDistrArray
from iterative_solver_tpu.parallel import block_sharding as jblock_sharding
from iterative_solver_tpu.parallel import collectives as jcoll
from iterative_solver_tpu.parallel import make_mesh as jmake_mesh
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

WORLD = 4
CASES = ["distr_array", "collectives"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distribution")
    W.run_workers(out, WORLD, CASES)
    return {c: [W.load(out, c, r) for r in range(WORLD)] for c in CASES}


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(jax.devices()[:WORLD])


@pytest.mark.parametrize("n,k", [(10, 3), (16, 4), (7, 4), (3, 4), (100, 7)])
def test_spread_remainder_matches_jax(n, k):
    t, j = tdist.spread_remainder(n, k), jdist.spread_remainder(n, k)
    assert t.chunk_borders == j.chunk_borders
    assert [t.range(r) for r in range(k)] == [j.range(r) for r in range(k)]
    assert [t.cover(i) for i in range(n)] == [j.cover(i) for i in range(n)]
    assert t.cover(1, n) == j.cover(1, n) and t.border == j.border
    assert t.compatible(tdist.spread_remainder(n, k))


def _jax_distr_array(mesh):
    def make(n, data=None):
        return JDistrArray(n, mesh=mesh, data=data)

    out = {}
    a = make(24)
    a.fill(2.0)
    out["fill"] = a.gather_all()
    a.put(3, np.arange(4.0))
    out["put"] = a.get(3, 7)
    a.acc(3, np.ones(4))
    out["acc"] = a.get(3, 7)
    b = make(16, np.arange(16.0))
    out["gather"] = b.gather([1, 5, 9])
    b.scatter([0, 2], [10.0, 20.0])
    out["scatter"] = np.array([b.at(0), b.at(2)])
    b.scatter_acc([0], [1.0])
    out["scatter_acc"] = np.array([b.at(0)])
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(32), rng.standard_normal(32)
    c, d = make(32, x), make(32, y)
    c.axpy(0.5, d)
    out["axpy"] = c.gather_all()
    c.scal(2.0)
    out["scal"] = c.gather_all()
    d.times(c)
    out["times"] = d.gather_all()
    e, f, g = make(8, np.arange(1.0, 9.0)), make(8, np.full(8, 2.0)), make(8)
    g.divide(e, f, shift=1.0)
    out["divide"] = g.gather_all()
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(40), rng.standard_normal(40)
    h, k = make(40, x), make(40, y)
    out["dot"] = np.array([h.dot(k), h.norm()])
    s = make(6, np.array([3.0, -7.0, 1.0, 5.0, -2.0, 0.5]))
    out["max_n"] = np.array([i for i, _ in s.max_n(2)])
    out["min_n"] = np.array([i for i, _ in s.min_n(2)])
    out["max_abs_n"] = np.array([i for i, _ in s.max_abs_n(1)])
    out["min_loc_n"] = np.array(s.min_loc_n(1))
    out["select"] = np.array(sorted(s.select(2, max_select=False)))
    p, q = make(4, np.array([1.0, 2.0, 0.1, 3.0])), make(4, np.array([1.0, 1.0, 100.0, 0.1]))
    out["select_max_dot"] = np.array(sorted(p.select_max_dot(2, q)))
    u = make(20, np.arange(20.0))
    out["local_buffers"] = np.concatenate([u.local_buffer(r) for r in range(WORLD)])
    out["size"] = np.array([u.distribution().size])
    v = make(6, np.arange(1.0, 7.0))
    v.fill(3.0)
    v.recip()
    out["recip"] = v.gather_all()
    return out


EXACT = ["fill", "put", "acc", "gather", "scatter", "scatter_acc", "divide", "max_n", "min_n",
         "max_abs_n", "min_loc_n", "select", "select_max_dot", "local_buffers", "size", "recip"]


@pytest.mark.parametrize("key", EXACT)
def test_distr_array_matches_jax_exactly(ranks, jmesh, key):
    want = _jax_distr_array(jmesh)[key]
    for r, res in enumerate(ranks["distr_array"]):
        np.testing.assert_array_equal(res[key], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("key", ["axpy", "scal", "times", "dot"])
def test_distr_array_linalg_matches_jax(ranks, jmesh, key):
    want = _jax_distr_array(jmesh)[key]
    first = ranks["distr_array"][0][key]
    np.testing.assert_allclose(first, want, rtol=0, atol=1e-12)
    for res in ranks["distr_array"][1:]:
        np.testing.assert_array_equal(res[key], first)   # the same bits on every rank


def test_distr_array_ranges_and_padding(ranks):
    d = tdist.spread_remainder(20, WORLD)
    for r, res in enumerate(ranks["distr_array"]):
        lo, hi = d.range(r)
        np.testing.assert_array_equal(res["own_buffer"], np.arange(20.0)[lo:hi])
        # n = 6 over 4 ranks: ranks 2 and 3 own one entry and a zero pad
        np.testing.assert_array_equal(res["pad"], np.zeros_like(res["pad"]))
    assert [len(r["pad"]) for r in ranks["distr_array"]] == [0, 0, 1, 1]


def test_collectives_match_jax(ranks, jmesh):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((3, 64)), rng.standard_normal((5, 64))
    coeff = rng.standard_normal((2, 5))
    sh = jblock_sharding(jmesh)
    xd, yd = jax.device_put(jnp.asarray(x), sh), jax.device_put(jnp.asarray(y), sh)
    gram = np.asarray(jcoll.sharded_gram(jmesh)(xd, yd))
    rec = np.asarray(jcoll.sharded_reconstruct(jmesh)(jnp.asarray(coeff), yd))
    dots = np.asarray(jcoll.sharded_dot(jmesh)(xd, xd))
    for res in ranks["collectives"]:
        np.testing.assert_allclose(res["gram"], gram, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res["rec"], rec, rtol=0, atol=1e-12)
        np.testing.assert_allclose(res["dots"], dots, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(res["gram"], ranks["collectives"][0]["gram"])


def test_collectives_uneven_reduce_scatter_and_max(ranks):
    rng = np.random.default_rng(0)
    rng.standard_normal((3, 64)), rng.standard_normal((5, 64)), rng.standard_normal((2, 5))
    z = rng.standard_normal((2, 10))
    base = rng.standard_normal((2, 8 * WORLD))
    total = sum(base * (r + 1) for r in range(WORLD))
    for r, res in enumerate(ranks["collectives"]):
        np.testing.assert_array_equal(res["uneven"], z)
        np.testing.assert_allclose(res["rs"], total[:, 8 * r:8 * (r + 1)], rtol=1e-14)
        np.testing.assert_array_equal(res["max"], [WORLD - 1, 0.0])
        # chunks of ceil(10 / 4) = 3: JAX's NamedSharding layout
        assert tuple(res["range"]) == (min(3 * r, 10), min(3 * r + 3, 10))


def test_mesh_helpers_need_an_initialised_group():
    from iterative_solver_torch.parallel import make_mesh, pad_to_multiple
    from iterative_solver_torch.parallel.mesh import check_sharding, local_range

    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    assert [local_range(10, 4, r) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert check_sharding(None) is None
    with pytest.raises(TypeError, match="Sharding"):
        check_sharding(object())
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
