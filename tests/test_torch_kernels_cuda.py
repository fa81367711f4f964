"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the main path's shapes are chip_smoke.py's).

Marked ``cuda``: each test skips where CUDA is absent. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: 1e-5 of the plain result's max magnitude (both contributions and
the chain's reductions add partial sums with f32 atomics, so the order of
the sum differs from the plain version's).
"""

import numpy as np
import pytest
import torch

from iterative_solver_torch.ops.kernels import chain, symm

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _sym_matrix(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a + a.T + np.diag(np.linspace(-2.0, 10.0, n))


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


# b=256: vector tile loads; b=96, b=200: ragged sub-tiles; m=20: two x passes
SHAPES = [(512, 256, 16), (192, 96, 5), (400, 200, 20), (128, 128, 1)]


@pytest.mark.parametrize("n,b,m", SHAPES)
@pytest.mark.parametrize("tile", ["f32", "bf16"])
def test_symm_kernel_matches_plain(cuda, n, b, m, tile):
    dtype = torch.float32 if tile == "f32" else torch.bfloat16
    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(n, 1), b=b, dtype=dtype, device=cuda)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    key = "symm_" + tile
    before = symm.LAUNCHES[key]
    y = symm.symm_matmat_kernel(x, sym)
    torch.cuda.synchronize()
    assert symm.LAUNCHES[key] == before + 1
    assert _rel(y, symm.symm_matmat(x, sym)) <= TOL


@pytest.mark.parametrize("n,b,m", SHAPES)
def test_split_kernel_matches_plain(cuda, n, b, m):
    sym = symm.SymmetricBlockedSplit.from_dense(_sym_matrix(n, 3), b=b, device=cuda)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    before = symm.LAUNCHES["symm_split"]
    y = symm.symm_matmat_split_kernel(x, sym)
    torch.cuda.synchronize()
    assert symm.LAUNCHES["symm_split"] == before + 1
    assert _rel(y, symm.symm_matmat_split(x, sym)) <= TOL


def test_symm_kernel_rejects_f64(cuda):
    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(64, 5), b=32, dtype=torch.float32,
                                           device=cuda)
    with pytest.raises(TypeError):
        symm.symm_matmat_kernel(torch.zeros((2, 64), dtype=torch.float64, device=cuda), sym)


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("r,m_max,n,passes", [(16, 64, 8192, 2), (3, 12, 300, 2),
                                              (5, 40, 1000, 1), (4, 16, 777, 3)])
def test_chain_kernel_matches_plain(cuda, jacobi, r, m_max, n, passes):
    rng = np.random.default_rng(6)
    q = np.linalg.qr(rng.standard_normal((n, m_max)))[0].T
    mask = np.zeros(m_max)
    mask[: 3 * m_max // 4] = 1.0
    f32 = dict(dtype=torch.float32, device=cuda)
    v = torch.as_tensor(q * mask[:, None], **f32)
    mask = torch.as_tensor(mask, **f32)
    res = torch.as_tensor(rng.standard_normal((r, n)), **f32)
    extra = ()
    if jacobi:
        extra = (torch.as_tensor(rng.standard_normal(n) + 4.0, **f32),
                 torch.as_tensor(np.linspace(-1.0, 0.0, r), **f32))
    before = chain.LAUNCHES["chain"]
    got = chain.fused_expand_chain(res, v, mask, *extra, gs_passes=passes)
    ref = chain.expand_chain(res, v, mask, *extra, gs_passes=passes)
    torch.cuda.synchronize()
    assert chain.LAUNCHES["chain"] == before + 1
    for name, a, b in zip(("t", "n0", "n2", "g"), got, ref):
        assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("tier", ["fast", "precise", "exact"])
def test_small_solve_on_card(cuda, tier):
    from iterative_solver_torch import FusedDavidson

    n, nroots = 512, 4
    rng = np.random.default_rng(7)
    d = np.concatenate([np.linspace(-2.0, 3.0, 16), np.linspace(6.0, 50.0, n - 16)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    mat = a + a.T + np.diag(d)
    tol = 2e-4 if tier == "fast" else 1e-5
    solver = FusedDavidson.from_dense_symmetric(mat, nroots, tier=tier, b=128, m_max=16,
                                                rr="window", convergence_threshold=tol)
    assert solver.device.type == "cuda" and solver.fuse_chain
    v0 = np.zeros((nroots, n))
    for row, i in enumerate(np.argsort(d)[:nroots]):
        v0[row, i] = 1.0
    evals, x, errors, iters = solver.run_on_device(v0)
    assert x.device.type == "cuda"
    assert np.max(errors) <= tol
    # f64 Rayleigh quotients of the Ritz vectors against the f64 matrix (the
    # Ritz values of the bf16 tiles carry the tiles' own rounding)
    xs = x.double().cpu().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ mat), axis=1))
    ref = np.linalg.eigvalsh(mat)[:nroots]
    np.testing.assert_allclose(rq, ref, atol=1e-5 if tier == "fast" else 1e-8)
