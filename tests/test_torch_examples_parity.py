"""Each twin in examples_torch/ against its JAX example, on the CPU: the
float32 twins here, the float64 ones in test_torch_examples_parity_*.py
(split so that each file stays short on one test worker), which take the
helpers below from this file.

The twin's ``main(["--device", "cpu"])`` runs in this process; the JAX
side is the example's own code, run here through the JAX package on the
same seed-made inputs (built independently of the twin, as the example
builds them). The JAX examples that run without x64 (float32 throughout)
get ``dtype=float32`` here, since this process enables x64.

Tolerances: float64 runs take the same iteration counts, eigenvalues
within 1e-10 and solutions within 1e-8; float32 runs are within 2
iterations and 1e-4. Two kinds of count are not held to those rules, each
pinned by its own test:

- a float32 solve that ends at its floor (the int8_precise polish of
  quantized_screening: its residual hovers at 1.3-2e-5 against tol 1e-5 in
  both packages, so the count is where the noise first dips under tol,
  and it moves with the summation order: the port takes 36 iterations on
  one thread and 60 on eight);
- the float64 Davidson runs of ppcg_hard_spectrum, which stall for 250-500
  iterations: the two packages' residual histories agree to rounding at
  first and drift apart exponentially (1e-15 at step 10, 1e-8 by step 60),
  so the counts differ by a few percent
  (test_torch_examples_parity_ppcg.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_testing import child_env
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


HIGHEST = jax.lax.Precision.HIGHEST


def twin(name: str, *argv) -> dict:
    return importlib.import_module(f"examples_torch.{name}").main(
        ["--device", "cpu", *argv])


def guess(diag, nroots):
    v0 = np.zeros((nroots, len(diag)))
    for row, i in enumerate(np.argsort(diag)[:nroots]):
        v0[row, i] = 1.0
    return v0


def jmv(x, op):
    return jnp.matmul(x, op.T, precision=HIGHEST)


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------- float32


def test_packed_symmetric_davidson():
    import dataclasses

    from iterative_solver_tpu.ops.kernels.symm_pallas import (
        SymmetricBlocked,
        SymmetricBlockedSplit,
        symm_matmat,
        symm_matmat_split_pallas,
    )
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson

    n, b, nroots = 512, 64, 4
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    matrix = a + a.T + np.diag(np.concatenate([
        np.linspace(-2.0, 1.0, 16), np.linspace(3.0, 40.0, n - 16)]))
    diag = np.diag(matrix)
    v0 = guess(diag, nroots)
    sym = SymmetricBlocked.from_dense(matrix, b=b, dtype=jnp.float32)

    def matvec_f32(x, op):
        s = dataclasses.replace(sym, values=op[0], ii=op[1], jj=op[2])
        return symm_matmat(x.astype(jnp.float32), s).astype(x.dtype)

    j1 = FusedDavidson(matvec_f32, diag, n, nroots, m_max=4 * nroots, dtype=jnp.float32,
                       convergence_threshold=2e-4, max_iter=100,
                       operand=(sym.values, sym.ii, sym.jj), rr="window").run_on_device(v0)
    syms = SymmetricBlockedSplit.from_dense(matrix, b=b)

    def matvec_split(x, op):
        s = dataclasses.replace(syms, hi=op[0], lo=op[1], ii=op[2], jj=op[3])
        return symm_matmat_split_pallas(x.astype(jnp.float32), s,
                                        interpret=True).astype(x.dtype)

    j2 = FusedDavidson(matvec_split, diag, n, nroots, m_max=4 * nroots, dtype=jnp.float32,
                       convergence_threshold=2e-4, max_iter=100,
                       operand=(syms.hi, syms.lo, syms.ii, syms.jj)).run_on_device(v0)
    out = twin("packed_symmetric_davidson")
    for key, (evals, _, _, iters) in (("f32", j1), ("split", j2)):
        assert abs(out[key]["iterations"] - int(iters)) <= 2, key
        close(out[key]["eigenvalues"], np.sort(np.asarray(evals)), 1e-4)
    close(out["reference"], np.linalg.eigvalsh(matrix)[:nroots], 1e-10)


def _refine_operator(n, r):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    d = np.concatenate([np.linspace(-2.0, 3.0, max(32, 2 * r)),
                        np.linspace(6.0, 50.0, n - max(32, 2 * r))])
    return a + a.T + np.diag(d)


def test_refine_to_1e8():
    """The JAX example's CPU branch (a dense float32 matmul), run as the
    example runs: in a process of its own without x64 (in this x64 process
    the same calls stall at the float32 floor for 100 iterations). Its
    printed account holds the counts and the refined eigenvalues' error."""
    import os
    import re
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = child_env(JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, os.path.join(root, "examples", "refine_to_1e8.py")],
                          capture_output=True, text=True, timeout=240, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    iters = int(re.search(r"fused solve: (\d+) iters", proc.stdout).group(1))
    passes = int(re.search(r"refinement: (\d+) passes", proc.stdout).group(1))
    jax_err = float(re.search(r"eigenvalue error vs dense f64: (\S+)", proc.stdout).group(1))
    out = twin("refine_to_1e8")
    assert out["action"] == "dense" and out["converged"]
    assert abs(out["iterations"] - iters) <= 2 and abs(out["passes"] - passes) <= 2
    assert jax_err <= 1e-4 and out["eigenvalue_error"] <= 1e-4
    close(out["eigenvalues"], np.linalg.eigvalsh(_refine_operator(1024, 8))[:8], 1e-4)


def _screening_jax(n=1024, nroots=6):
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson
    from iterative_solver_tpu.solvers.refine import EigenpairRefiner

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    matrix = a + a.T + np.diag(np.concatenate([np.linspace(-2.0, 1.0, 24),
                                               np.linspace(3.0, 40.0, n - 24)]))
    diag = np.diag(matrix)
    common = dict(b=256, max_iter=100, dtype=jnp.float32)
    screen = FusedDavidson.from_dense_symmetric(matrix, nroots, tier="int8",
                                                convergence_threshold=5e-3, **common)
    evals_s, x_s, err_s, it_s = screen.run_on_device(guess(diag, nroots))
    polish = FusedDavidson.from_dense_symmetric(matrix, nroots, tier="int8_precise",
                                                convergence_threshold=1e-5, **common)
    _, x_p, err_p, it_p = polish.run_on_device(screen.unpad(x_s))
    refiner = EigenpairRefiner(lambda x: x @ matrix.T, polish.matvec, polish.operand, diag,
                               polish.n, nroots, dtype=jnp.float32)
    out = refiner.refine(polish.unpad(np.asarray(x_p, dtype=np.float64)), tol=1e-8)
    return {"screen": (int(it_s), np.sort(np.asarray(evals_s)), np.asarray(err_s)),
            "polish": (int(it_p), np.asarray(err_p)), "refine": out}


@pytest.fixture(scope="module")
def screening():
    return _screening_jax(), twin("quantized_screening")


def test_quantized_screening(screening):
    jax_run, out = screening
    it_s, evals_s, _ = jax_run["screen"]
    assert abs(out["screen"]["iterations"] - it_s) <= 2
    close(out["screen"]["eigenvalues"], evals_s, 1e-4)
    ref = jax_run["refine"]
    assert abs(out["refine"]["passes"] - ref.passes) <= 2
    close(out["eigenvalues"], np.sort(ref.eigenvalues), 1e-4)


def test_quantized_screening_polish_ends_at_its_floor(screening):
    """The int8_precise polish converges to tol 1e-5 in both packages,
    each within max_iter, but from its floor: the counts (JAX 18 here, 9
    without x64; the port 36 on one thread, 60 on eight) are not held to
    each other."""
    jax_run, out = screening
    it_p, err_p = jax_run["polish"]
    assert np.max(err_p) <= 1e-5 and it_p < 100
    assert max(out["polish"]["errors"]) <= 1e-5 and out["polish"]["iterations"] < 100


def test_hybrid_precision():
    from iterative_solver_tpu.models.synthetic_fci import synthetic_fci_dense
    from iterative_solver_tpu.ops.precise import (
        SplitOperator,
        precise_matvec_fn,
        refine_on_host,
    )
    from iterative_solver_tpu.solvers.fused_davidson import FusedDavidson

    n, nroots = 1024, 3
    matrix = synthetic_fci_dense(n, seed=0)
    op = SplitOperator.from_dense(matrix, n_chunks=32)
    evals32, x32, _, iters32 = FusedDavidson(
        precise_matvec_fn(op), op.diagonal, n, nroots, m_max=20, dtype=jnp.float32,
        convergence_threshold=2e-5, max_iter=100, operand=op.operand()).run(
            guess(op.diagonal, nroots))
    evals, _, info = refine_on_host(matrix, np.asarray(x32), nroots)
    out = twin("hybrid_precision")
    assert abs(out["iterations"] - int(iters32)) <= 2
    assert abs(out["refine_iterations"] - info.iterations) <= 2
    close(out["eigenvalues_f32"], np.asarray(evals32), 1e-4)
    # the host refinement is float64 from either start
    close(out["eigenvalues"], evals, 1e-10)
