"""The port's offload stores (iterative_solver_torch/array/offload_store.py)
against the JAX package's on the same seeded inputs, on the CPU in float64
(tests/test_offload_store.py's unit cases), and the parity Davidson through
``offload=True`` / ``"streamed"`` / a factory against JAX's with the same
options, on a seeded matrix.

Tolerances: 1e-12 for the host-f64 store against JAX's and against the
device ``BasisStore`` (the same float64 products, summed in another
order); 1e-10 for MGS; eigenvalues 1e-10 with equal ``stats``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterative_solver_torch as T
import iterative_solver_tpu as J
from iterative_solver_torch.array.basis_store import BasisStore
from iterative_solver_torch.array.offload_store import OffloadBasisStore, StreamedOffloadStore
from iterative_solver_tpu.array.offload_store import OffloadBasisStore as JOffload
from iterative_solver_tpu.array.offload_store import StreamedOffloadStore as JStreamed
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_interface_matches_device_store_and_jax():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 64))
    x = rng.standard_normal((3, 64))
    dev = BasisStore(8, 64, device=CPU)
    off = OffloadBasisStore(8, 64, device=CPU)
    jax_off = JOffload(8, 64)
    slots_d = [dev.append(v) for v in vecs]
    slots_o = [off.append(torch.as_tensor(v)) for v in vecs]   # a tensor row, as XSpace puts
    slots_j = [jax_off.append(v) for v in vecs]
    assert slots_d == slots_o == slots_j
    xt = torch.as_tensor(x)
    for ref in (dev.gram_block(xt)[:, slots_d], jax_off.gram_block(jnp.asarray(x))[:, slots_j]):
        np.testing.assert_allclose(off.gram_block(xt)[:, slots_o], ref, atol=1e-12)
    np.testing.assert_allclose(off.gram(xt, slots_o[::-1]),
                               np.asarray(jax_off.gram(jnp.asarray(x), slots_j[::-1])),
                               atol=1e-12)
    coeff = rng.standard_normal((2, 5))
    got = off.combine(coeff, slots_o)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    for ref in (_np(dev.combine(coeff, slots_d)), np.asarray(jax_off.combine(coeff, slots_j))):
        np.testing.assert_allclose(_np(got), ref, atol=1e-12)
    inv = rng.random(5) + 0.5
    for ref in (_np(dev.mgs_sweep(xt, slots_d, inv)),
                np.asarray(jax_off.mgs_sweep(jnp.asarray(x), slots_j, inv))):
        np.testing.assert_allclose(_np(off.mgs_sweep(xt, slots_o, inv)), ref, atol=1e-10)
    np.testing.assert_allclose(_np(off.rows(slots_o[:2])), vecs[:2], atol=0)
    off.axpy(slots_o[0], 2.0, vecs[1])
    off.scale(slots_o[1], -1.0)
    jax_off.axpy(slots_j[0], 2.0, vecs[1])
    jax_off.scale(slots_j[1], -1.0)
    for s, sj in zip(slots_o[:2], slots_j[:2]):
        np.testing.assert_array_equal(_np(off.get(s)), np.asarray(jax_off.get(sj)))
    off.close()
    jax_off.close()


def test_store_defaults_and_refusals():
    store = OffloadBasisStore(4, 8, device=CPU)
    assert store.dtype == torch.float64 and store.device.type == "cpu"
    # the offload stores' sharding is ported (tests/test_torch_sharded_families.py)
    # and takes a parallel.mesh.Sharding
    with pytest.raises(TypeError, match="Sharding"):
        OffloadBasisStore(4, 8, sharding=object(), device=CPU)
    store.close()


@pytest.mark.parametrize("cls", ["host", "streamed"])
def test_release_mask_zeroes_the_slot(cls):
    off = (OffloadBasisStore if cls == "host" else StreamedOffloadStore)(4, 16, device=CPU)
    s = off.append(np.ones(16))
    off.release(s)
    g = off.gram_block(torch.ones((1, 16), dtype=torch.float64))
    assert abs(g[0, s]) < 1e-14
    assert s not in off._valid and off.n_used == 0
    off.close()


@pytest.mark.parametrize("prefetch", [True, False])
def test_streamed_matches_host_store_and_jax(prefetch):
    rng = np.random.default_rng(1)
    host = OffloadBasisStore(16, 96, device=CPU)
    streamed = StreamedOffloadStore(16, 96, block_rows=3, device=CPU)  # 10 rows -> 4 blocks
    jax_streamed = JStreamed(16, 96, block_rows=3)
    vecs = rng.standard_normal((10, 96))
    sh = [host.append(v) for v in vecs]
    ss = [streamed.append(v) for v in vecs]
    sj = [jax_streamed.append(v) for v in vecs]
    x = rng.standard_normal((4, 96))
    xt = torch.as_tensor(x)
    got = streamed.gram(xt, ss, prefetch=prefetch)
    np.testing.assert_allclose(got, host.gram(xt, sh), atol=1e-12)
    np.testing.assert_allclose(got, jax_streamed.gram(jnp.asarray(x), sj, prefetch=prefetch),
                               atol=1e-12)
    np.testing.assert_allclose(streamed.gram_block(xt),
                               host.gram_block(xt), atol=1e-12)
    coeff = rng.standard_normal((3, 10))
    comb = streamed.combine(coeff, ss, prefetch=prefetch)
    assert isinstance(comb, torch.Tensor) and comb.dtype == torch.float64
    np.testing.assert_allclose(_np(comb), _np(host.combine(coeff, sh)), atol=1e-12)
    np.testing.assert_allclose(
        _np(comb), np.asarray(jax_streamed.combine(coeff, sj, prefetch=prefetch)), atol=1e-12)
    # the serial pipeline runs the same products in the same order: the same bits
    assert np.array_equal(got, streamed.gram(xt, ss, prefetch=not prefetch))
    assert torch.equal(comb, streamed.combine(coeff, ss, prefetch=not prefetch))
    for store in (host, streamed, jax_streamed):
        store.close()


def test_blocked_gs_matches_mgs_on_orthonormal_history():
    # the solvers keep Q orthonormal; block-classical GS == row MGS there
    rng = np.random.default_rng(2)
    n, k = 128, 9
    q, _ = np.linalg.qr(rng.standard_normal((n, k)))
    rows = q.T
    host = OffloadBasisStore(16, n, device=CPU)
    streamed = StreamedOffloadStore(16, n, block_rows=4, device=CPU)
    jax_streamed = JStreamed(16, n, block_rows=4)
    sh = [host.append(v) for v in rows]
    ss = [streamed.append(v) for v in rows]
    sj = [jax_streamed.append(v) for v in rows]
    r = rng.standard_normal((3, n))
    inv = np.ones(k)
    out_h = _np(host.mgs_sweep(torch.as_tensor(r), sh, inv))
    out_s = _np(streamed.mgs_sweep(torch.as_tensor(r), ss, inv))
    np.testing.assert_allclose(out_s, out_h, atol=1e-11)
    np.testing.assert_allclose(out_s, np.asarray(jax_streamed.mgs_sweep(jnp.asarray(r), sj, inv)),
                               atol=1e-12)
    assert np.abs(out_s @ rows.T).max() < 1e-10
    for store in (host, streamed, jax_streamed):
        store.close()


def test_release_mask_and_regrow():
    st = StreamedOffloadStore(4, 32, block_rows=2, device=CPU)
    js = JStreamed(4, 32, block_rows=2)
    for store in (st, js):
        s0 = store.append(np.ones(32))
        s1 = store.append(2 * np.ones(32))
        store.release(s0)
        g = store.gram_block(np.ones((1, 32)))
        assert abs(g[0, s0]) < 1e-14 and abs(g[0, s1] - 64.0) < 1e-10
        # a grow with a hole in the validity mask keeps the live rows
        for i in range(6):
            store.append(np.full(32, float(i + 3)))
        g2 = store.gram_block(np.ones((1, 32)))
        assert abs(g2[0, s1] - 64.0) < 1e-10
    assert st.capacity == js.capacity == 8
    assert st._valid == js._valid
    np.testing.assert_allclose(st.gram_block(np.ones((2, 32))),
                               js.gram_block(np.ones((2, 32))), atol=1e-12)
    st.close()
    js.close()


def _seeded_matrix(n=120, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.05
    return a + a.T + np.diag(np.linspace(1.0, 12.0, n))


def _streamed_factory(pkg):
    cls = StreamedOffloadStore if pkg is T else JStreamed

    def factory(capacity, n, dtype, sharding, name="params", **kw):
        return cls(capacity, n, dtype=dtype, sharding=sharding, name=name, block_rows=3, **kw)

    return factory


@pytest.mark.parametrize("offload", [False, True, "streamed", "factory"])
def test_davidson_offload_matches_jax(offload):
    """The parity Davidson through each store form, port against JAX: equal
    stats and iteration counts, eigenvalues within 1e-10."""
    m = _seeded_matrix()
    n, nroots = m.shape[0], 3
    results = {}
    for pkg in (J, T):
        kw = {"device": "cpu"} if pkg is T else {}
        opt = _streamed_factory(pkg) if offload == "factory" else offload
        solver = pkg.LinearEigensystemDavidson(n, nroots, offload=opt, **kw)
        solver.set_hermiticity(True)
        solver.verbosity = pkg.Verbosity.NONE
        problem = pkg.models.MatrixProblem(m, **kw)
        conv, *_ = solver.solve(np.zeros((nroots, n)), problem=problem,
                                generate_initial_guess=True)
        assert conv
        results[pkg] = (str(solver.stats), solver.stats.iterations,
                        np.asarray(solver.eigenvalues()[:nroots]), solver)
    assert results[T][0] == results[J][0]
    assert results[T][1] == results[J][1]
    np.testing.assert_allclose(results[T][2], results[J][2], atol=1e-10)
    np.testing.assert_allclose(results[T][2], np.linalg.eigvalsh(m)[:nroots], atol=1e-9)
    store = results[T][3].xspace.store_v
    expected = {False: BasisStore, True: OffloadBasisStore, "streamed": StreamedOffloadStore,
                "factory": StreamedOffloadStore}[offload]
    assert type(store) is expected
    if offload == "factory":
        assert store.block_rows == 3


def test_save_vecstore_hdf5_round_trips_an_offload_store(tmp_path):
    pytest.importorskip("h5py")
    from iterative_solver_torch.utils.checkpoint import load_vecstore_hdf5, save_vecstore_hdf5

    rng = np.random.default_rng(5)
    rows = rng.standard_normal((4, 40))
    store = OffloadBasisStore(4, 40, device=CPU)
    slots = [store.append(r) for r in rows]
    store.release(slots[1])
    path = str(tmp_path / "store.h5")
    save_vecstore_hdf5(store, path)
    got, got_slots = load_vecstore_hdf5(path)
    live = [s for s in slots if s != slots[1]]
    assert got_slots == sorted(live)
    np.testing.assert_array_equal(got, rows[[slots.index(s) for s in sorted(live)]])
    store.close()
