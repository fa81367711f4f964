"""The ppcg_hard_spectrum twin against its JAX example, on the CPU, in
float64: FusedPPCG's count exactly, and the Davidson stalls of 250-500
iterations within the rounding drift pinned by the second test (the rules
in test_torch_examples_parity.py)."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_examples_parity import close, guess, jmv, twin
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def _ppcg_matrix():
    n = 768
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.4 / np.sqrt(n))
    return a + a.T + np.diag(np.linspace(0.0, 6.0, n))


def test_ppcg_hard_spectrum():
    from iterative_solver_tpu import FusedPPCG
    from iterative_solver_tpu.solvers.fused_davidson import (
        make_davidson_init,
        make_davidson_solve,
    )

    mat, nroots, tol = _ppcg_matrix(), 8, 1e-9
    n = mat.shape[0]
    mj = jnp.asarray(mat)
    v0 = guess(np.diag(mat), nroots)
    evals, _, _, it_ppcg = FusedPPCG(jmv, np.diag(mat), n, nroots, rr_every=5,
                                     convergence_threshold=tol, max_iter=500,
                                     operand=mj).run(v0)
    out = twin("ppcg_hard_spectrum")
    assert out["ppcg"]["iterations"] == int(it_ppcg)
    close(out["ppcg"]["eigenvalues"], np.asarray(evals), 1e-10)
    for rr, rec in out["davidson"].items():
        init = make_davidson_init(jmv, nroots, 4 * nroots)
        solve = make_davidson_solve(jmv, nroots, 4 * nroots, rr=rr)
        final, iters = solve(init(jnp.asarray(v0), mj), mj, jnp.diagonal(mj), tol, 500)
        # a stall of 250-500 iterations: rounding drift (the test below)
        assert abs(rec["iterations"] - int(iters)) <= 0.05 * int(iters), rr
        close(rec["eigenvalues"], np.sort(np.asarray(final.evals)), 1e-10)


def test_ppcg_davidson_histories_agree_to_rounding_then_drift():
    """rr="full" on the hard spectrum: the max residual of each of the first
    60 steps in both packages, relative difference under 1e-13 for 10
    steps and under 1e-6 for 60 (it grows about tenfold per 6 steps)."""
    from iterative_solver_tpu.solvers import fused_davidson as J
    from iterative_solver_torch.solvers import fused_davidson as T

    mat, nroots = _ppcg_matrix(), 8
    v0 = guess(np.diag(mat), nroots)
    mj, mt = jnp.asarray(mat), torch.as_tensor(mat)
    _, _, jh = J.make_davidson_solve(jmv, nroots, 32, rr="full", history=60)(
        J.make_davidson_init(jmv, nroots, 32)(jnp.asarray(v0), mj), mj, jnp.diagonal(mj),
        0.0, 60)

    def tmv(x, op):
        return torch.matmul(x, op.T)

    _, _, th = T.make_davidson_solve(tmv, nroots, 32, rr="full", history=60)(
        T.make_davidson_init(tmv, nroots, 32)(torch.as_tensor(v0), mt), mt,
        torch.diagonal(mt), 0.0, 60)
    rel = np.abs(np.asarray(jh) - th.numpy()) / np.asarray(jh)
    assert rel[:10].max() < 1e-13 and rel.max() < 1e-6, rel
