"""The port's block-vector operations (iterative_solver_torch/array/
vector_ops.py) against the JAX package's (iterative_solver_tpu/array/
vector_ops.py), in f64 on the CPU, to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.array import vector_ops as J
from iterative_solver_torch.array import vector_ops as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

_RNG = np.random.default_rng(21)
X = _RNG.standard_normal((4, 50))
Y = _RNG.standard_normal((4, 50))
Z = _RNG.standard_normal((6, 50))
C = _RNG.standard_normal((4, 6))
A = _RNG.standard_normal(4)
V = _RNG.standard_normal(50)
D = _RNG.standard_normal(50) + 3.0

CASES = {
    "gram": ((X, Z), {}),
    "gram_sym": ((Z,), {}),
    "reconstruct": ((C, Z), {}),
    "reconstruct_add": ((X, C, Z), {}),
    "axpy": ((0.7, X, Y), {}),
    "axpy_rows": ((A, X, Y), {}),
    "scale_rows": ((A, X), {}),
    "dots_rows": ((X, Y), {}),
    "norms_rows": ((X,), {}),
    "fused_axpy": ((_RNG.standard_normal(6), Z, V), {}),
    "fused_dot": ((V, Z), {}),
    "mgs_project": ((X, Z, 1.0 / np.sum(Z * Z, axis=1)), {}),
    "jacobi_precondition_block": ((X, A, D), {}),
}


def _to(a, mod):
    if not isinstance(a, np.ndarray):
        return a
    return jnp.asarray(a) if mod is J else torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    args, kw = CASES[name]
    got = getattr(T, name)(*(_to(a, T) for a in args), **kw)
    ref = getattr(J, name)(*(_to(a, J) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_normalize_rows_matches_jax():
    x = X.copy()
    x[2] = 0.0  # below threshold: left untouched
    got, gnorm = T.normalize_rows(torch.from_numpy(x))
    ref, rnorm = J.normalize_rows(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(rnorm), rtol=1e-12)


@pytest.mark.parametrize("name,args", [("select_smallest", (D, 5)),
                                       ("select_max_dot", (V, D, 5))])
def test_selection_matches_jax(name, args):
    gi, gv = getattr(T, name)(*(_to(a, T) for a in args))
    ri, rv = getattr(J, name)(*(_to(a, J) for a in args))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-15)


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float64, jnp.float64),
                                           (torch.float32, jnp.float32)])
def test_chol_jitter_matches_jax(tdtype, jdtype):
    assert T.chol_jitter(tdtype) == J.chol_jitter(jdtype)


def test_host_round_trip():
    t = T.to_device(X, dtype=torch.float32, device="cpu")
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(T.to_host(t), X.astype(np.float32))
