"""The float64 solver twins against their JAX examples, on the CPU:
batched_scan, response_equations, nonhermitian_eigen and
distributed_eigensystem (the rules in test_torch_examples_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
from test_torch_examples_parity import close, guess, jmv, twin
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def test_batched_scan():
    from iterative_solver_tpu.solvers.fused_davidson import make_batched_davidson_solve
    from iterative_solver_tpu.solvers.fused_nonsym import (
        finalize_nonsym_batch,
        make_batched_nonsym_solve,
    )

    n, nroots, m_max, npoints = 256, 3, 18, 6
    rng = np.random.default_rng(0)
    base = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    base = base + base.T
    mats = np.stack([lam * base + np.diag(np.linspace(0.0, 12.0, n))
                     for lam in np.linspace(0.2, 1.2, npoints)])
    diags = np.stack([np.diag(m) for m in mats])
    v0 = np.stack([guess(d, nroots) for d in diags])
    binit, bsolve = make_batched_davidson_solve(jmv, nroots, m_max)
    final, iters = bsolve(binit(jnp.asarray(v0), jnp.asarray(mats)), jnp.asarray(mats),
                          jnp.asarray(diags), 1e-9, 800)
    mats_ns = mats.copy()
    for p in range(npoints):
        mats_ns[p][np.tril_indices(n, -1)] *= 0.9
    diags_ns = np.stack([np.diag(m) for m in mats_ns])
    binit_ns, bsolve_ns = make_batched_nonsym_solve(jmv, nroots, m_max)
    state = binit_ns(jnp.asarray(v0), jnp.asarray(mats_ns))
    *_, bx, bG, bR, iters_ns = bsolve_ns(*state, jnp.asarray(mats_ns),
                                         jnp.asarray(diags_ns), 1e-9, 800)
    evals_ns, _, _ = finalize_nonsym_batch(bx, bG, bR)
    out = twin("batched_scan")
    for p in range(npoints):
        assert out["scan"][p]["iterations"] == int(iters[p])
        close(out["scan"][p]["eigenvalues"], np.sort(np.asarray(final.evals[p])), 1e-10)
        assert out["nonsym"][p]["iterations"] == int(iters_ns[p])
        close(out["nonsym"][p]["eigenvalues"], np.sort(np.asarray(evals_ns[p]).real), 1e-10)


def test_response_equations():
    from iterative_solver_tpu import FusedBlockCG, make_batched_nonsym_lineq_solve

    n = 512
    shifts = np.array([0.0, 0.5, 1.0, 2.0])
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    mat = a + a.T + np.diag(np.linspace(1.0, 9.0, n))
    b_vec = rng.standard_normal(n)
    sj = jnp.asarray(shifts)
    x, _, iters = FusedBlockCG(
        lambda x, op: jmv(x, op) + sj[:, None] * x,
        np.diag(mat)[None, :] + shifts[:, None], n, len(shifts),
        convergence_threshold=1e-11, max_iter=500,
        operand=jnp.asarray(mat)).solve(np.tile(b_vec, (len(shifts), 1)))
    mat_ns = mat.copy()
    mat_ns[np.tril_indices(n, -1)] *= 0.9
    b2 = rng.standard_normal((2, n))
    binit, bsolve = make_batched_nonsym_lineq_solve(
        lambda x, op: jmv(x, op[0]) + op[1] * x, 2, 12, operand_axes=(None, 0))
    operand = (jnp.asarray(mat_ns), sj)
    b_b = jnp.asarray(np.broadcast_to(b2, (4, 2, n)))
    state = binit(jnp.asarray(np.stack([b2 / (np.diag(mat_ns)[None, :] + s) for s in shifts])),
                  operand, b_b)
    *_, bxb, _, itersb = bsolve(
        *state, operand, jnp.asarray(np.stack([np.diag(mat_ns) + s for s in shifts])), b_b,
        jnp.asarray(np.broadcast_to(np.linalg.norm(b2, axis=1), (4, 2))), 1e-10, 200)
    out = twin("response_equations")
    assert out["cg_iterations"] == int(iters)
    close([r["response"] for r in out["symmetric"]], np.asarray(x) @ b_vec, 1e-8)
    for k, s in enumerate(shifts):
        assert out["nonsym"][k]["iterations"] == int(itersb[k])
        ref = np.linalg.solve(mat_ns + s * np.eye(n), b2.T).T
        jrel = np.linalg.norm(np.asarray(bxb[k]) - ref) / np.linalg.norm(ref)
        close(out["nonsym"][k]["relative_error"], jrel, 1e-8)


def test_nonhermitian_eigen():
    from iterative_solver_tpu import FusedNonSymDavidson, FusedNonSymLinearEquations

    n, nroots = 512, 4
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    diag = np.concatenate([np.linspace(-2.0, 0.0, 8), np.linspace(2.0, 20.0, n - 8)])
    mat = a + a.T + np.diag(diag)
    mat[np.tril_indices(n, -1)] *= 0.8
    v0 = guess(diag, nroots)
    host = FusedNonSymDavidson.from_dense(mat, nroots, m_max=16, convergence_threshold=1e-10,
                                          max_iter=80).solve(v0)
    dev = FusedNonSymDavidson.from_dense(mat, nroots, m_max=16, convergence_threshold=1e-10,
                                         max_iter=120, rr="device").solve(v0)
    m2 = np.diag(np.linspace(5.0, 25.0, n)) + rng.standard_normal((n, n)) * 0.01
    m2[0, 0] = m2[1, 1] = 1.0
    m2[0, 1], m2[1, 0] = -1.5, 1.5
    m2[0, 2:] = m2[1, 2:] = m2[2:, 0] = m2[2:, 1] = 0.0
    pair = FusedNonSymDavidson.from_dense(m2, 3, m_max=16, convergence_threshold=1e-9,
                                          max_iter=80).solve(guess(np.diag(m2), 3))
    b = rng.standard_normal((3, n))
    mat_pd = a + a.T + np.diag(np.linspace(1.0, 20.0, n))
    mat_pd[np.tril_indices(n, -1)] *= 0.9
    _, _, it3 = FusedNonSymLinearEquations(jmv, np.diag(mat_pd), n, 3, m_max=18,
                                           convergence_threshold=1e-11, max_iter=120,
                                           operand=jnp.asarray(mat_pd)).solve(b)
    out = twin("nonhermitian_eigen")
    for key, (evals, _, _, it) in (("host_rr", host), ("device_rr", dev)):
        assert out[key]["iterations"] == int(it), key
        close(out[key]["eigenvalues"], np.sort(np.asarray(evals).real), 1e-10)
    assert out["complex_pair"]["iterations"] == int(pair[3])
    got = np.array([complex(*z) for z in out["complex_pair"]["eigenvalues"]])
    np.testing.assert_allclose(got, np.asarray(pair[0]), rtol=0, atol=1e-10)
    assert out["linear"]["iterations"] == int(it3)


def test_distributed_eigensystem():
    """The JAX example's mesh (this process's 8 virtual CPU devices) against
    the twin's 2 gloo ranks."""
    from iterative_solver_tpu.parallel import block_sharding, make_mesh, matrix_row_sharding
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson

    mesh = make_mesh()
    n = 1024
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * 0.01
    matrix = a + a.T + np.diag(np.linspace(1.0, 10.0, n))
    mat = jax.device_put(jnp.asarray(matrix), matrix_row_sharding(mesh))
    v0 = np.zeros((2, n))
    v0[0, 0] = v0[1, 1] = 1.0
    evals, _, _, iters = FusedDavidson(jmv, np.diag(matrix), n, 2, m_max=16,
                                       sharding=block_sharding(mesh),
                                       operand=mat).run_on_device(v0)
    out = twin("distributed_eigensystem")
    assert out["iterations"] == int(iters) and out["same_bits_on_every_rank"]
    close(out["eigenvalues"], np.sort(np.asarray(evals)), 1e-10)
