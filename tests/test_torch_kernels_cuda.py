"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the main path's shapes are chip_smoke.py's).

Marked ``cuda``: each test skips where CUDA is absent. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: 1e-5 of the plain result's max magnitude for K1 and K3 (each
square's partial sums land in slots of their own, added in a fixed order
other than the plain version's), and the same bits on a second run. K4
and K5 add integer partial sums,
exact in any order, and round their epilogue in the plain version's order:
they must equal it bit for bit (tolerance 0). K2, K6 and K7 add in a fixed
order of their own (no atomics): tolerance 1e-5 of the plain result's max
magnitude (for K7, of the largest sum of |terms|, since a single dot
product may cancel), and the same bits on a second run.
"""

import functools

import numpy as np
import pytest
import torch

from iterative_solver_torch.ops.kernels import chain, gram, spmv, symm, symm_int8

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


def _bench_spectrum(n, seed):
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.linspace(-2.0, 3.0, 16), np.linspace(6.0, 50.0, n - 16)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(d), d


def _one_hot(d, nroots):
    v0 = np.zeros((nroots, d.shape[0]))
    for row, i in enumerate(np.argsort(d)[:nroots]):
        v0[row, i] = 1.0
    return v0


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


# the square walk: b below, at and above the 256-wide square; b = 100
# (bf16 rows not 16-byte aligned: scalar chunk loads) and b = 50 (x and y
# not float4-aligned: scalar staging and stores)
WALK_B = [(192, 96), (400, 200), (1024, 512), (2048, 1024), (300, 100), (150, 50)]
SYMM_VARIANTS = {
    "f32": (torch.float32, symm.symm_matmat_kernel, symm.symm_matmat, "symm_f32"),
    "bf16": (torch.bfloat16, symm.symm_matmat_kernel, symm.symm_matmat, "symm_bf16"),
    "split": (None, symm.symm_matmat_split_kernel, symm.symm_matmat_split, "symm_split"),
}


def _symm_operand(variant, mat, b, device, tol=None):
    dtype = SYMM_VARIANTS[variant][0]
    if dtype is None:
        return symm.SymmetricBlockedSplit.from_dense(mat, b=b, device=device)
    return symm.SymmetricBlocked.from_dense(mat, b=b, dtype=dtype, tol=tol, device=device)


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("n,b", WALK_B)
@pytest.mark.parametrize("variant", sorted(SYMM_VARIANTS))
def test_symm_walk_matches_plain(cuda, variant, n, b, m):
    _, kernel, plain, key = SYMM_VARIANTS[variant]
    sym = _symm_operand(variant, _sym_matrix(n, 30), b, cuda)
    x = torch.as_tensor(np.random.default_rng(31).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    before = symm.LAUNCHES[key]
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert symm.LAUNCHES[key] == before + 1
    assert y.shape == (m, sym.shape[0]) and y.dtype == torch.float32
    assert _rel(y, plain(x, sym)) <= TOL


@pytest.mark.parametrize("tile", ["f32", "bf16"])
def test_symm_kernel_tol_dropped_tiles(cuda, tile):
    n, b = 2048, 512
    mat = _sym_matrix(n, 32)
    mat[b:3 * b, :b] = 0.0   # tile pairs (1, 0), (2, 0) dropped
    mat[:b, b:3 * b] = 0.0
    sym = _symm_operand(tile, mat, b, cuda, tol=0.0)
    assert sym.n_pairs == 10 - 2
    x = torch.as_tensor(np.random.default_rng(33).standard_normal((16, n)),
                        dtype=torch.float32, device=cuda)
    y = symm.symm_matmat_kernel(x, sym)
    torch.cuda.synchronize()
    assert _rel(y, symm.symm_matmat(x, sym)) <= TOL


@pytest.mark.parametrize("variant", sorted(SYMM_VARIANTS))
def test_symm_kernel_never_takes_the_plain_path(cuda, variant, monkeypatch):
    _, kernel, plain, key = SYMM_VARIANTS[variant]
    sym = _symm_operand(variant, _sym_matrix(512, 34), 256, cuda)
    x = torch.as_tensor(np.random.default_rng(35).standard_normal((16, 512)),
                        dtype=torch.float32, device=cuda)
    y_ref = plain(x, sym)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA launch reached the plain version")

    for name in ("symm_matmat", "symm_matmat_split", "_symm_matmat_plain", "square_walk"):
        monkeypatch.setattr(symm, name, refuse)
    before = symm.LAUNCHES[key]
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert symm.LAUNCHES[key] == before + 1
    assert _rel(y, y_ref) <= TOL
    with pytest.raises(TypeError):
        kernel(x.double(), sym)


@pytest.mark.parametrize("n,b,m", [(2048, 512, 16), (1024, 512, 1), (1024, 512, 4),
                                   (2048, 1024, 17), (300, 100, 4), (150, 50, 16)])
@pytest.mark.parametrize("variant", sorted(SYMM_VARIANTS))
def test_symm_kernel_repeated_calls_agree(cuda, variant, n, b, m):
    """The slots are added in a fixed order: eight calls give the same bits,
    at the rows the solvers launch K1 and K3 at (16; 4 and 1 for the
    differentiable action) and at ragged b."""
    _, kernel, _, _ = SYMM_VARIANTS[variant]
    sym = _symm_operand(variant, _sym_matrix(n, 36), b, cuda)
    x = torch.as_tensor(np.random.default_rng(37).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    ys = [kernel(x, sym) for _ in range(8)]
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.parametrize("m", [1, 4, 16])
def test_symm_adjoint_same_bits_every_call(cuda, m):
    """The differentiable action (K1 forward, K1 as its own adjoint): y, xbar
    and vbar have the same bits on a second backward."""
    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(1024, 40), b=512,
                                           dtype=torch.float32, device=cuda)
    action = symm.make_differentiable_symm_action(sym)
    rng = np.random.default_rng(41)
    x0, ybar = (torch.as_tensor(rng.standard_normal((m, 1024)), dtype=torch.float32,
                                device=cuda) for _ in range(2))
    outs = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        values = sym.values.clone().requires_grad_(True)
        y = action(x, values)
        outs.append((y.detach(), *torch.autograd.grad(y, (x, values), ybar)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_symm_kernel_rejects_f64(cuda):
    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(64, 5), b=32, dtype=torch.float32,
                                           device=cuda)
    with pytest.raises(TypeError):
        symm.symm_matmat_kernel(torch.zeros((2, 64), dtype=torch.float64, device=cuda), sym)


def _chain_inputs(r, m_max, n, jacobi, device, seed=6):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, m_max)))[0].T
    mask = np.zeros(m_max)
    mask[: 3 * m_max // 4] = 1.0
    f32 = dict(dtype=torch.float32, device=device)
    v = torch.as_tensor(q * mask[:, None], **f32)
    mask = torch.as_tensor(mask, **f32)
    res = torch.as_tensor(rng.standard_normal((r, n)), **f32)
    extra = ()
    if jacobi:
        extra = (torch.as_tensor(rng.standard_normal(n) + 4.0, **f32),
                 torch.as_tensor(np.linspace(-1.0, 0.0, r), **f32))
    return (res, v, mask, *extra)


# K2's fast path (R <= 32, M <= 128, n a multiple of 4): 8196 and 4100 end
# in a ragged step of 128 columns, R = 1 and M = 128, R = 20 (32 padded
# rows); its second path: n = 8191, 300, 777 and 1000 (not multiples of 4
# or of a step) at small R and M, and R = 40, M = 150; gs_passes 1 to 3
CHAIN_SHAPES = [(16, 64, 8192, 2), (3, 12, 300, 2), (5, 40, 1000, 1), (4, 16, 777, 3),
                (16, 64, 8196, 2), (16, 64, 8191, 2), (1, 64, 4096, 2), (16, 128, 8196, 1),
                (1, 128, 4100, 3), (20, 100, 2048, 2), (40, 150, 2000, 2)]


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("r,m_max,n,passes", CHAIN_SHAPES)
def test_chain_kernel_matches_plain(cuda, jacobi, r, m_max, n, passes):
    args = _chain_inputs(r, m_max, n, jacobi, cuda)
    before = chain.LAUNCHES["chain"]
    got = chain.fused_expand_chain(*args, gs_passes=passes)
    ref = chain.expand_chain(*args, gs_passes=passes)
    torch.cuda.synchronize()
    assert chain.LAUNCHES["chain"] == before + 1
    for name, a, b in zip(("t", "n0", "n2", "g"), got, ref):
        assert _rel(a, b) <= TOL, name
    if chain.chain_fast_dims(r, m_max) is not None and n % 4 == 0:
        # the kernel's own partition and order, emulated on the card
        ctas = chain.chain_ctas(r, m_max, n, chain._chain_capacity(cuda, r, m_max, n, True))
        emul = chain.expand_chain_emulated(*args, gs_passes=passes, ctas=ctas)
        for name, a, b in zip(("t", "n0", "n2", "g"), got, emul):
            assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("r,m_max,n,passes", [(16, 64, 8192, 2), (16, 64, 8191, 2),
                                              (1, 128, 4100, 3), (40, 150, 2000, 2)])
def test_chain_kernel_repeated_calls_identical(cuda, r, m_max, n, passes):
    """K2 adds every partial in a fixed order: every call gives the same bits."""
    args = _chain_inputs(r, m_max, n, True, cuda, seed=7)
    outs = [chain.fused_expand_chain(*args, gs_passes=passes) for _ in range(4)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_chain_kernel_never_takes_the_plain_path(cuda, monkeypatch):
    args = _chain_inputs(16, 64, 8192, True, cuda, seed=8)
    ref = chain.expand_chain(*args)

    def refuse(*a, **k):
        raise AssertionError("a CUDA launch reached the plain version")

    for name in ("expand_chain", "expand_chain_emulated"):
        monkeypatch.setattr(chain, name, refuse)
    before = chain.LAUNCHES["chain"]
    got = chain.fused_expand_chain(*args)
    torch.cuda.synchronize()
    assert chain.LAUNCHES["chain"] == before + 1
    for name, a, b in zip(("t", "n0", "n2", "g"), got, ref):
        assert _rel(a, b) <= TOL, name
    with pytest.raises(TypeError):
        chain.fused_expand_chain(*(a.double() for a in args))


def test_chain_kernel_against_float64_at_2_18(cuda):
    """At n = 2^18, a phenol-like step (Ritz values just below the lowest
    diagonal entries: one large column per row of t) within 1e-5 of the
    plain version in float64 on the same f32 inputs, in t, n0, n2 and g."""
    n, nroots = 1 << 18, 16
    rng = np.random.default_rng(9)
    d = rng.uniform(0.5, 50.0, n)
    d[rng.choice(n, 64, replace=False)] = np.linspace(-2.0, 3.0, 64)
    res, v, mask = _chain_inputs(nroots, 64, n, False, cuda, seed=9)
    diag = torch.as_tensor(d, dtype=torch.float32, device=cuda)
    evals = torch.as_tensor(np.sort(d)[:nroots] - 1e-4, dtype=torch.float32, device=cuda)
    got = chain.fused_expand_chain(res, v, mask, diag, evals)
    ref64 = chain.expand_chain(*(a.double() for a in (res, v, mask, diag, evals)))
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "n0", "n2", "g"), got, ref64):
        assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("tier", ["fast", "precise", "exact"])
def test_small_solve_on_card(cuda, tier):
    from iterative_solver_torch import FusedDavidson

    nroots = 4
    mat, d = _bench_spectrum(512, 7)
    tol = 2e-4 if tier == "fast" else 1e-5
    solver = FusedDavidson.from_dense_symmetric(mat, nroots, tier=tier, b=128, m_max=16,
                                                rr="window", convergence_threshold=tol)
    assert solver.device.type == "cuda" and solver.fuse_chain
    evals, x, errors, iters = solver.run_on_device(_one_hot(d, nroots))
    assert x.device.type == "cuda"
    assert np.max(errors) <= tol
    # f64 Rayleigh quotients of the Ritz vectors against the f64 matrix (the
    # Ritz values of the bf16 tiles carry the tiles' own rounding)
    xs = x.double().cpu().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ mat), axis=1))
    ref = np.linalg.eigvalsh(mat)[:nroots]
    np.testing.assert_allclose(rq, ref, atol=1e-5 if tier == "fast" else 1e-8)


# K4/K5 shapes (n, b): b=32 is below the 64-wide chunk and b=96 ragged in
# it; b=200 is ragged and not a multiple of 16 (4-byte copies); b=512 and
# b=1024 are whole 256-wide squares
INT8_SHAPES = [(96, 32), (288, 96), (400, 200), (1024, 512), (2048, 1024)]
INT8_TIERS = {
    "int8": (symm_int8.SymmetricBlockedInt8, symm_int8.symm_matmat_int8_kernel,
             symm_int8.symm_matmat_int8, "symm_int8"),
    "int8_split": (symm_int8.SymmetricBlockedInt8Split,
                   symm_int8.symm_matmat_int8_split_kernel,
                   symm_int8.symm_matmat_int8_split, "symm_int8_split"),
}


@pytest.mark.parametrize("m", [1, 4, 16, 64])
@pytest.mark.parametrize("n,b", INT8_SHAPES)
@pytest.mark.parametrize("tier", sorted(INT8_TIERS))
def test_int8_kernel_equals_plain(cuda, tier, n, b, m):
    cls, kernel, plain, key = INT8_TIERS[tier]
    sym = cls.from_dense(_sym_matrix(n, 8), b=b, device=cuda)
    xh = np.random.default_rng(9).standard_normal((m, sym.shape[0]))
    xh[m // 2] = 0.0  # a zero row quantizes to zeros with sx = 1/127
    x = torch.as_tensor(xh, dtype=torch.float32, device=cuda)
    before = symm_int8.LAUNCHES[key]
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert symm_int8.LAUNCHES[key] == before + 1
    assert torch.equal(y, plain(x, sym))


# K4 at every M tiling: 15 and 16 rows one M tile, 17 and 32 two, 64 four,
# 65 and 128 passes of 64 rows (the test above takes m = 1, 4, 16, 64)
@pytest.mark.parametrize("m", [15, 17, 32, 65, 128])
@pytest.mark.parametrize("n,b", INT8_SHAPES)
def test_int8_kernel_m_tilings(cuda, n, b, m):
    sym = symm_int8.SymmetricBlockedInt8.from_dense(_sym_matrix(n, 12), b=b, device=cuda)
    x = torch.as_tensor(np.random.default_rng(13).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    before = symm_int8.LAUNCHES["symm_int8"]
    y = symm_int8.symm_matmat_int8_kernel(x, sym)
    torch.cuda.synchronize()
    assert symm_int8.LAUNCHES["symm_int8"] == before + 1
    assert torch.equal(y, symm_int8.symm_matmat_int8(x, sym))


# K5 at every pass count: 16 rows of x per pass, so 17 and 40 take two and
# three passes, 64 four, 100 seven
@pytest.mark.parametrize("m", [1, 17, 40, 64, 100])
@pytest.mark.parametrize("n,b", INT8_SHAPES)
def test_split_kernel_row_passes(cuda, n, b, m):
    sym = symm_int8.SymmetricBlockedInt8Split.from_dense(_sym_matrix(n, 22), b=b, device=cuda)
    x = torch.as_tensor(np.random.default_rng(23).standard_normal((m, sym.shape[0])),
                        dtype=torch.float32, device=cuda)
    before = symm_int8.LAUNCHES["symm_int8_split"]
    y = symm_int8.symm_matmat_int8_split_kernel(x, sym)
    torch.cuda.synchronize()
    assert symm_int8.LAUNCHES["symm_int8_split"] == before + 1
    assert torch.equal(y, symm_int8.symm_matmat_int8_split(x, sym))


def test_split_kernel_repeated_calls_identical(cuda):
    """Integer reds are exact in any order: every K5 call gives the same bits."""
    sym = symm_int8.SymmetricBlockedInt8Split.from_dense(_sym_matrix(2048, 24), b=1024,
                                                         device=cuda)
    x = torch.as_tensor(np.random.default_rng(25).standard_normal((16, 2048)),
                        dtype=torch.float32, device=cuda)
    ys = torch.stack([symm_int8.symm_matmat_int8_split_kernel(x, sym) for _ in range(8)])
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


# b = 50: rows not 4-byte aligned (byte loads), b even (64-bit reds);
# b = 25: b odd (32-bit reds)
@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("n,b", [(150, 50), (75, 25)])
@pytest.mark.parametrize("tier", sorted(INT8_TIERS))
def test_int8_kernel_unaligned_b(cuda, tier, n, b, m):
    cls, kernel, plain, _ = INT8_TIERS[tier]
    sym = cls.from_dense(_sym_matrix(n, 20), b=b, device=cuda)
    x = torch.as_tensor(np.random.default_rng(21).standard_normal((m, n)),
                        dtype=torch.float32, device=cuda)
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert torch.equal(y, plain(x, sym))


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("tier", sorted(INT8_TIERS))
def test_int8_kernel_tol_dropped_tiles(cuda, tier, m):
    cls, kernel, plain, _ = INT8_TIERS[tier]
    n, b = 2048, 512
    mat = _sym_matrix(n, 14)
    mat[b:3 * b, :b] = 0.0   # tile pairs (1, 0), (2, 0) dropped
    mat[:b, b:3 * b] = 0.0
    sym = cls.from_dense(mat, b=b, tol=0.0, device=cuda)
    assert sym.n_pairs == 10 - 2
    x = torch.as_tensor(np.random.default_rng(15).standard_normal((m, n)),
                        dtype=torch.float32, device=cuda)
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert torch.equal(y, plain(x, sym))


def test_int8_kernel_64_rows_at_n8192(cuda):
    """The flagship's row count and tile size on the flagship's generator,
    at n = 8192 (36 tiles of 1024)."""
    from iterative_solver_torch.models.synthetic_fci import synthetic_packed_int8

    sym, _ = synthetic_packed_int8(8192, b=1024, seed=16, device=cuda)
    x = torch.as_tensor(np.random.default_rng(17).standard_normal((64, 8192)),
                        dtype=torch.float32, device=cuda)
    y = symm_int8.symm_matmat_int8_kernel(x, sym)
    torch.cuda.synchronize()
    assert torch.equal(y, symm_int8.symm_matmat_int8(x, sym))


@pytest.mark.parametrize("m", [16, 64])
def test_int8_kernel_repeated_calls_identical(cuda, m):
    """Integer atomics are exact in any order: every call gives the same bits."""
    sym = symm_int8.SymmetricBlockedInt8.from_dense(_sym_matrix(2048, 18), b=1024,
                                                    device=cuda)
    x = torch.as_tensor(np.random.default_rng(19).standard_normal((m, 2048)),
                        dtype=torch.float32, device=cuda)
    ys = torch.stack([symm_int8.symm_matmat_int8_kernel(x, sym) for _ in range(8)])
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def _saturated(cls, copies, b, device):
    """``copies`` duplicates of one diagonal tile, every entry +127: with x
    quantized to +-127 each accumulator entry reaches copies*b*127^2 (one
    plane) or about twice that (the split tier's lo), just inside int32."""
    tile = torch.full((copies, b, b), 127, dtype=torch.int8, device=device)
    zeros = torch.zeros(copies, dtype=torch.int32, device=device)
    planes = {"q": tile} if cls is symm_int8.SymmetricBlockedInt8 else {"q1": tile,
                                                                        "q2": tile.clone()}
    return cls(gq=torch.ones(b, dtype=torch.float32, device=device), ii=zeros,
               jj=zeros.clone(), shape=(b, b), b=b,
               diagonal=torch.zeros(b, dtype=torch.float32, device=device), **planes)


@pytest.mark.parametrize("tier,copies", [("int8", 130), ("int8_split", 64)])
def test_int8_kernel_saturated_near_headroom(cuda, tier, copies):
    cls, kernel, plain, _ = INT8_TIERS[tier]
    b = 1024
    sym = _saturated(cls, copies, b, cuda)
    # rows of one sign: one entry at 127 sets sx, the rest at 126.49 puts
    # the split tier's p1 at 126 and p2 at 124
    xh = np.full((4, b), 126.49)
    xh[:, 0] = 127.0
    xh[1] *= -1.0
    xh[3] = 0.0
    x = torch.as_tensor(xh, dtype=torch.float32, device=cuda)
    if tier == "int8":
        qx, _ = symm_int8.quantize_rows(x)
        acc = symm_int8._symm_matmat_int8_plain(qx, sym.q, sym.ii, sym.jj, b, 1)
    else:
        p1, p2, _ = symm_int8.quantize_rows_split(x)
        acc = (symm_int8._symm_matmat_int8_plain(p1, sym.q2, sym.ii, sym.jj, b, 1)
               + symm_int8._symm_matmat_int8_plain(p2, sym.q1, sym.ii, sym.jj, b, 1))
    assert int(acc.abs().max()) > 0.96 * 2 ** 31
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert torch.equal(y, plain(x, sym))


@pytest.mark.parametrize("tier", sorted(INT8_TIERS))
def test_int8_kernel_never_takes_the_plain_path(cuda, tier, monkeypatch):
    cls, kernel, plain, key = INT8_TIERS[tier]
    sym = cls.from_dense(_sym_matrix(256, 10), b=128, device=cuda)
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((4, 256)),
                        dtype=torch.float32, device=cuda)
    y_ref = plain(x, sym)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA launch reached the plain version")

    for name in ("symm_matmat_int8", "symm_matmat_int8_split", "_symm_matmat_int8_plain"):
        monkeypatch.setattr(symm_int8, name, refuse)
    before = symm_int8.LAUNCHES[key]
    y = kernel(x, sym)
    torch.cuda.synchronize()
    assert symm_int8.LAUNCHES[key] == before + 1
    assert torch.equal(y, y_ref)
    with pytest.raises(TypeError):
        kernel(x.double(), sym)


@pytest.mark.parametrize("tier", ["int8", "int8_precise"])
def test_small_int8_solve_on_card(cuda, tier):
    from iterative_solver_torch import FusedDavidson

    mat, d = _bench_spectrum(512, 12)
    tol = 5e-3 if tier == "int8" else 1e-5
    key = "symm_int8" if tier == "int8" else "symm_int8_split"
    solver = FusedDavidson.from_dense_symmetric(mat, 4, tier=tier, b=128, m_max=16,
                                                rr="window", convergence_threshold=tol)
    before = symm_int8.LAUNCHES[key]
    evals, x, errors, iters = solver.run_on_device(_one_hot(d, 4))
    assert symm_int8.LAUNCHES[key] > before
    assert np.max(errors) <= tol
    xs = x.double().cpu().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ mat), axis=1))
    np.testing.assert_allclose(rq, np.linalg.eigvalsh(mat)[:4],
                               atol=1e-5 if tier == "int8" else 1e-8)


def test_small_ppcg_on_card(cuda):
    from iterative_solver_torch import FusedPPCG
    from iterative_solver_torch.models.synthetic_fci import (
        implied_dense_int8,
        synthetic_packed_int8,
    )

    sym, d = synthetic_packed_int8(1024, b=256, seed=3, device=cuda)
    matvec, op = symm_int8.int8_matvec(sym)
    solver = FusedPPCG(matvec, d, 1024, 8, rr_every=4, convergence_threshold=5e-3,
                       max_iter=200, operand=op)
    before = symm_int8.LAUNCHES["symm_int8"]
    evals, x, errors, iters = solver.run_on_device(_one_hot(d, 8))
    assert symm_int8.LAUNCHES["symm_int8"] - before == 1 + 2 + iters + iters // 4
    assert np.max(errors) <= 5e-3
    ref = np.linalg.eigvalsh(implied_dense_int8(sym, d))[:8]
    np.testing.assert_allclose(np.sort(evals), ref, atol=1e-3)


def _block_sparse(n, bm, bn, seed, empty_rows=()):
    """A block-sparse (n, n) matrix on a (bm, bn) block grid, about a third
    of the blocks kept; the block rows in ``empty_rows`` hold no block."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    keep = rng.random((-(-n // bm), -(-n // bn))) < 0.35
    keep[np.arange(min(keep.shape)), np.arange(min(keep.shape))] = True
    keep[list(empty_rows)] = False
    mask = np.kron(keep, np.ones((bm, bn)))[:n, :n]
    return a * mask


# (n, bm, bn): square 128 blocks (16-byte loads); bm != bn; a ragged last
# block row and column (n not a multiple of bm, bn); bn = 100 (a ragged
# 64-column chunk); bn = 6 and bm = 40 (scalar loads, a ragged 32-column
# CTA); bm = 256 (eight CTAs per block row)
BSR_SHAPES = [(512, 128, 128), (384, 32, 16), (300, 64, 32), (400, 40, 100),
              (96, 40, 6), (512, 256, 128)]


@pytest.mark.parametrize("m", [1, 4, 5, 15, 16, 17, 33, 64])
@pytest.mark.parametrize("n,bm,bn", BSR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bsr_kernel_matches_plain(cuda, n, bm, bn, m, dtype):
    bsr = spmv.BSRMatrix.from_dense(_block_sparse(n, bm, bn, 20, empty_rows=(1,)),
                                    bm=bm, bn=bn, dtype=dtype, device=cuda)
    rows = bsr.row_ptr.cpu().numpy()
    assert rows[2] == rows[1]  # block row 1 is empty
    x = torch.as_tensor(np.random.default_rng(21).standard_normal((m, bsr.shape[1])),
                        dtype=torch.float32, device=cuda)
    before = spmv.LAUNCHES["bsr"]
    y = spmv.bsr_matmat_kernel(x, bsr)
    torch.cuda.synchronize()
    assert spmv.LAUNCHES["bsr"] == before + 1
    assert y.shape == (m, bsr.shape[0]) and y.dtype == torch.float32
    ref = spmv.bsr_matmat(x, bsr)
    assert _rel(y, ref) <= TOL
    assert torch.all(y[:, bm:2 * bm] == 0)
    # one CTA writes each output: the same bits on a second run
    assert torch.equal(spmv.bsr_matmat_kernel(x, bsr), y)


@functools.lru_cache(maxsize=1)
def _phenol_host(n):
    from chip_smoke import phenol_int8_bsr

    return phenol_int8_bsr(n)


def _phenol_bsr(n, dtype, device):
    """chip_smoke's phenol-scale topology at size n, values q s/127 plus the
    diagonal, in ``dtype``."""
    q, rows, cols, row_ptr, diag, s = _phenol_host(n)
    values = q.astype(np.float32) * np.float32(s / 127.0)
    on_diag = np.nonzero(rows == cols)[0]
    ar = np.arange(q.shape[1])
    values[on_diag[:, None], ar, ar] += diag[rows[on_diag][:, None] * q.shape[1] + ar]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return spmv.BSRMatrix(values=t(values).to(dtype), col_idx=t(cols), row_idx=t(rows),
                          row_ptr=t(row_ptr), shape=(n, n), bm=q.shape[1], bn=q.shape[1])


def _dense_row(n, bm, bn, blocks, seed):
    """A block-sparse matrix whose block row 2 holds ``blocks`` blocks."""
    a = _block_sparse(n, bm, bn, seed)
    a[2 * bm:3 * bm, :blocks * bn] = np.random.default_rng(seed + 1).standard_normal(
        (bm, blocks * bn))
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["row_of_24", "phenol_2^14", "phenol_2^15", "phenol_2^16"])
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 33, 64])
def test_bsr_kernel_long_rows_and_phenol_topology(cuda, case, m, dtype):
    """A block row of 24 blocks (48 steps of the stream, bm != bn), and the
    phenol-scale topology at 2^14 and 2^15 (32 output columns per CTA) and
    2^16 (128 where m <= 16)."""
    if case == "row_of_24":
        bsr = spmv.BSRMatrix.from_dense(_dense_row(24 * 96, 64, 96, 24, 30), bm=64, bn=96,
                                        dtype=dtype, device=cuda)
        assert int(torch.diff(bsr.row_ptr).max()) >= 24
    else:
        bsr = _phenol_bsr(1 << int(case.split("^")[1]), dtype, cuda)
    x = torch.as_tensor(np.random.default_rng(31).standard_normal((m, bsr.shape[1])),
                        dtype=torch.float32, device=cuda)
    y = spmv.bsr_matmat_kernel(x, bsr)
    torch.cuda.synchronize()
    assert _rel(y, spmv.bsr_matmat(x, bsr)) <= TOL
    assert torch.equal(spmv.bsr_matmat_kernel(x, bsr), y)


def test_bsr_kernel_empty_operator(cuda):
    bsr = spmv.BSRMatrix.from_dense(np.zeros((256, 256)), bm=64, device=cuda)
    assert bsr.n_blocks == 0
    y = spmv.bsr_matmat_kernel(torch.ones((3, 256), device=cuda), bsr)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros((3, 256), device=cuda))


def test_bsr_kernel_refuses_what_it_does_not_take(cuda):
    bsr = spmv.BSRMatrix.from_dense(_block_sparse(128, 32, 32, 22), bm=32, device=cuda)
    x = torch.zeros((2, 128), device=cuda)
    with pytest.raises(TypeError):
        spmv.bsr_matmat_kernel(x.double(), bsr)
    with pytest.raises(ValueError):
        spmv.bsr_matmat_kernel(torch.zeros((65, 128), device=cuda), bsr)
    with pytest.raises(ValueError):
        spmv.bsr_matmat_kernel(torch.zeros((2, 96), device=cuda), bsr)
    f64 = spmv.BSRMatrix.from_dense(_block_sparse(128, 32, 32, 22), bm=32,
                                    dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        spmv.bsr_matmat_kernel(x, f64)


@pytest.mark.parametrize("m", [1, 7, 17, 40, 64])
@pytest.mark.parametrize("n,tile", [(8192, 512), (1000, 100), (4096, 128), (777, 512),
                                    (300, 1024), (1 << 16, 512)])
def test_gram_kernel_matches_plain(cuda, m, n, tile):
    rng = np.random.default_rng(23)
    f32 = dict(dtype=torch.float32, device=cuda)
    v = torch.as_tensor(rng.standard_normal((m, n)), **f32)
    w = torch.as_tensor(rng.standard_normal((m, n)), **f32)
    mask = torch.as_tensor((np.arange(m) < max(1, 5 * m // 8)).astype(np.float64), **f32)
    before = gram.LAUNCHES["gram"]
    h = gram.masked_gram_kernel(v, w, mask, tile=tile)
    torch.cuda.synchronize()
    assert gram.LAUNCHES["gram"] == before + 1
    # relative to the largest sum of |terms|: at M = 1 the one dot product
    # may cancel far below its terms, and both sums round at their scale
    scale = float((v.abs() @ w.abs().T).max())
    err = float((h.double() - gram.masked_gram(v, w, mask, tile=tile).double()).abs().max())
    assert err <= TOL * scale
    assert torch.equal(h, h.T)
    assert torch.equal(gram.masked_gram_kernel(v, w, mask, tile=tile), h)


@pytest.mark.parametrize("m", [1, 17, 64])
@pytest.mark.parametrize("start,n", [(1, 8192), (3, 777), (4, 4096)])
def test_gram_kernel_column_slices(cuda, m, start, n):
    """v and w as column slices of wider stacks: rows apart by more than n,
    unaligned where start is odd; the kernel reads them in place."""
    rng = np.random.default_rng(25)
    f32 = dict(dtype=torch.float32, device=cuda)
    big_v = torch.as_tensor(rng.standard_normal((m, n + 8)), **f32)
    big_w = torch.as_tensor(rng.standard_normal((m, n + 8)), **f32)
    v, w = big_v[:, start:start + n], big_w[:, start:start + n]
    mask = torch.ones(m, **f32)
    h = gram.masked_gram_kernel(v, w, mask, tile=n)
    ref = gram.masked_gram(v.contiguous(), w.contiguous(), mask, tile=n)
    scale = float((v.abs() @ w.abs().T).max())
    assert float((h.double() - ref.double()).abs().max()) <= TOL * scale
    assert torch.equal(gram.masked_gram_kernel(v, w, mask, tile=n), h)


def test_gram_kernel_all_zero_mask_and_tiles(cuda):
    rng = np.random.default_rng(24)
    v = torch.as_tensor(rng.standard_normal((16, 2048)), dtype=torch.float32, device=cuda)
    zero = torch.zeros(16, dtype=torch.float32, device=cuda)
    assert torch.equal(gram.masked_gram_kernel(v, v, zero), torch.zeros((16, 16), device=cuda))
    ones = torch.ones(16, dtype=torch.float32, device=cuda)
    ref = gram.masked_gram(v, v, ones)
    for tile in (128, 256, 512, 2048, 4096):
        assert _rel(gram.masked_gram_kernel(v, v, ones, tile=tile), ref) <= TOL
    with pytest.raises(ValueError):   # 3 tiles of 300 do not divide 1000
        gram.masked_gram_kernel(v[:, :1000], v[:, :1000], ones, tile=300)


def test_small_bsr_fused_davidson_on_card(cuda):
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr

    bsr, dense = synthetic_fci_bsr(1024, 64, density=0.3, seed=1, device=cuda)
    matvec, op = spmv.bsr_matvec(bsr)
    d = np.diagonal(dense)
    solver = FusedDavidson(matvec, d, 1024, 4, m_max=16, rr="full",
                           convergence_threshold=1e-5, max_iter=60, operand=op)
    assert solver.fuse_chain
    before = spmv.LAUNCHES["bsr"]
    evals, x, errors, iters = solver.run_on_device(_one_hot(d, 4))
    assert spmv.LAUNCHES["bsr"] > before
    assert np.max(errors) <= 1e-5
    xs = x.double().cpu().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ dense), axis=1))
    np.testing.assert_allclose(rq, np.linalg.eigvalsh(dense)[:4], atol=1e-8)


def test_small_create_linear_eigensystem_on_card(cuda):
    import iterative_solver_torch as its
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr

    bsr, dense = synthetic_fci_bsr(512, 32, density=0.3, seed=2, device=cuda)

    class BSRProblem(its.Problem):
        def action(self, parameters):
            return spmv.bsr_matmat_kernel(parameters, bsr)

        def diagonals(self):
            return bsr.diagonal

    solver = its.create_linear_eigensystem(512, 2, "Davidson", "convergence_threshold=1e-5")
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    assert solver.device.type == "cuda" and solver.dtype == torch.float32
    before = spmv.LAUNCHES["bsr"]
    conv, x, r = solver.solve(np.zeros((2, 512)), problem=BSRProblem(),
                              generate_initial_guess=True)
    assert conv and x.device.type == "cuda"
    # one action, so one K6 launch, per iteration
    assert spmv.LAUNCHES["bsr"] - before == solver.stats.iterations > 0
    np.testing.assert_allclose(np.sort(solver.eigenvalues()[:2]),
                               np.linalg.eigvalsh(dense)[:2], atol=1e-5)


@pytest.mark.parametrize("r,n", [(1, 64), (16, 4096), (64, 1 << 16)])
def test_lower_solve_on_card_matches_the_direct_solve(cuda, r, n):
    from iterative_solver_torch.ops.kernels.chain import _cholesky_nan, lower_solve

    a = np.random.default_rng(25).standard_normal((r, n))
    l64 = np.linalg.cholesky(a @ a.T)
    ref = np.linalg.solve(l64, a)
    x = torch.as_tensor(a, dtype=torch.float32, device=cuda)
    l = _cholesky_nan(x @ x.T)
    got = lower_solve(l, x).double().cpu().numpy()
    assert np.max(np.abs(got - ref)) <= 1e-3 * np.max(np.abs(ref))
    # the rows come out orthonormal
    np.testing.assert_allclose(got @ got.T, np.eye(r), atol=1e-3)


# -- the paths of the linear systems, P space, checkpoints and batches ---------

LINEAR_TIERS = {"fast": (2e-3, symm.LAUNCHES, "symm_bf16"),
                "precise": (1e-5, symm.LAUNCHES, "symm_split"),
                "exact": (1e-5, symm.LAUNCHES, "symm_f32"),
                "int8": (5e-3, symm_int8.LAUNCHES, "symm_int8"),
                "int8_precise": (1e-5, symm_int8.LAUNCHES, "symm_int8_split")}


def _refuse_plain(monkeypatch):
    """Every plain version a packed action or the chain could fall back to
    raises: a CUDA tensor must launch the kernel."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA launch reached the plain version")

    for mod, names in ((chain, ("expand_chain", "expand_chain_emulated")),
                       (symm, ("_symm_matmat_plain", "square_walk")),
                       (symm_int8, ("_symm_matmat_int8_plain", "int8_square_walk"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("tier", sorted(LINEAR_TIERS))
def test_linear_tiers_on_card_match_cpu(cuda, tier, monkeypatch):
    """FusedLinearEquations at n=1024 (bench spectrum + 3 I, 4 right-hand
    sides): the card takes the CPU run's iteration count (within 2 for
    "precise" and the int8 tiers, whose f32 sums round in another order),
    launches its action kernel and K2 (raw mode) every iteration, and
    never the plain versions."""
    from iterative_solver_torch import FusedLinearEquations

    tol, counters, key = LINEAR_TIERS[tier]
    mat, _ = _bench_spectrum(1024, 21)
    mat = mat + 3.0 * np.eye(1024)
    b = np.random.default_rng(22).standard_normal((4, 1024))
    kw = dict(tier=tier, b=256, m_max=16, convergence_threshold=tol, fuse_chain=True)
    _, cpu_err, cpu_iters = FusedLinearEquations.from_dense_symmetric(
        mat, 4, device="cpu", dtype=torch.float32, **kw).solve(b)
    solver = FusedLinearEquations.from_dense_symmetric(mat, 4, **kw)
    _refuse_plain(monkeypatch)
    before, chain_before = counters[key], chain.LAUNCHES["chain"]
    x, errors, iters = solver.solve(b)
    assert x.device.type == "cuda" and np.max(errors) <= tol
    assert abs(iters - cpu_iters) <= (0 if tier in ("fast", "exact") else 2)
    assert chain.LAUNCHES["chain"] - chain_before == iters
    assert counters[key] - before >= 1 + 2 + iters
    xs = x.double().cpu().numpy()
    res = np.linalg.norm(xs @ mat - b, axis=1) / np.linalg.norm(b, axis=1)
    assert res.max() <= 10 * tol


def test_pspace_davidson_on_card(cuda, monkeypatch):
    from iterative_solver_torch import FusedDavidson

    mat, d = _bench_spectrum(1024, 23)
    order = np.argsort(d)
    kw = dict(tier="precise", b=256, m_max=32, rr="full", convergence_threshold=1e-5,
              p_space=[{int(i): 1.0} for i in order[:8]], p_actions=mat[order[:8]])
    v0 = np.zeros((4, 1024))
    v0[np.arange(4), order[8:12]] = 1.0
    cpu = FusedDavidson.from_dense_symmetric(mat, 4, device="cpu", dtype=torch.float32,
                                             fuse_chain=True, **kw).run_on_device(v0)
    solver = FusedDavidson.from_dense_symmetric(mat, 4, **kw)
    assert solver.n_p == 8 and solver.fuse_chain
    _refuse_plain(monkeypatch)
    before, chain_before = symm.LAUNCHES["symm_split"], chain.LAUNCHES["chain"]
    evals, x, errors, iters = solver.run_on_device(v0)
    assert np.max(errors) <= 1e-5 and abs(iters - cpu[3]) <= 2
    # init + probe + iterations (+ restarts); none for P, whose actions are given
    assert symm.LAUNCHES["symm_split"] - before >= 1 + 2 + iters
    assert chain.LAUNCHES["chain"] - chain_before == iters
    xs = x.double().cpu().numpy()
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    rq = np.sort(np.sum(xs * (xs @ mat), axis=1))
    np.testing.assert_allclose(rq, np.linalg.eigvalsh(mat)[:4], atol=1e-8)


def test_checkpoint_resume_on_card(cuda, tmp_path):
    from iterative_solver_torch import FusedDavidson

    mat, d = _bench_spectrum(1024, 24)

    def solver(max_iter=60):
        return FusedDavidson.from_dense_symmetric(mat, 4, tier="fast", b=256, m_max=12,
                                                  rr="window", convergence_threshold=2e-4,
                                                  max_iter=max_iter)

    v0 = _one_hot(d, 4)
    full = solver().run_fast(v0)
    path = str(tmp_path / "ck.npz")
    first = solver(max_iter=2).run_fast(v0, checkpoint_path=path)
    assert first[3] < full[3]
    before = symm.LAUNCHES["symm_bf16"]
    evals, x, errors, iters = solver().resume_fast(path)
    assert symm.LAUNCHES["symm_bf16"] > before and x.device.type == "cuda"
    assert iters == full[3] and np.max(errors) <= 2e-4
    np.testing.assert_allclose(np.sort(evals), np.sort(full[0]), atol=1e-6)


def test_batched_davidson_on_card(cuda):
    from iterative_solver_torch import make_batched_davidson_solve

    n, nb, nroots = 256, 4, 3
    rng = np.random.default_rng(25)
    base = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    base = base + base.T
    mats = np.stack([lam * base + np.diag(np.linspace(0.0, 12.0, n))
                     for lam in np.linspace(0.2, 1.2, nb)])
    diags = np.stack([np.diag(m) for m in mats])
    v0 = np.stack([_one_hot(dg, nroots) for dg in diags])
    f32 = dict(dtype=torch.float32)

    def matvec(x, op):
        return torch.matmul(x, op.T)

    binit, bsolve = make_batched_davidson_solve(matvec, nroots, 18)
    outs = {}
    for dev in ("cpu", "cuda"):
        tm = torch.as_tensor(mats, device=dev, **f32)
        outs[dev] = bsolve(binit(torch.as_tensor(v0, device=dev, **f32), tm), tm,
                           torch.as_tensor(diags, device=dev, **f32), 1e-5, 400)
    final, iters = outs["cuda"]
    assert final.v.device.type == "cuda"
    assert np.all(np.abs(iters.numpy() - outs["cpu"][1].numpy()) <= 5)
    for p in range(nb):
        assert float(final.errors[p].max()) <= 1e-5
        np.testing.assert_allclose(np.sort(final.evals[p].double().cpu().numpy()),
                                   np.linalg.eigvalsh(mats[p])[:nroots], atol=1e-5)


def test_refiner_on_card(cuda):
    """EigenpairRefiner's deflated CG on the K3 matvec, from a precise solve
    on the card to an f64 residual of 1e-8."""
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.solvers.refine import EigenpairRefiner

    mat, d = _bench_spectrum(1024, 26)
    solver = FusedDavidson.from_dense_symmetric(mat, 4, tier="precise", b=256, m_max=16,
                                                rr="full", convergence_threshold=1e-5)
    _, x, _, _ = solver.run_on_device(_one_hot(d, 4))
    refiner = EigenpairRefiner(lambda xs: xs @ mat, solver.matvec, solver.operand, d, 1024, 4)
    before = symm.LAUNCHES["symm_split"]
    out = refiner.refine(x.double().cpu().numpy(), tol=1e-8)
    assert out.converged and out.residual_norms.max() <= 1e-8
    assert symm.LAUNCHES["symm_split"] - before == sum(1 + i for i in refiner.cg_iterations)
    np.testing.assert_allclose(np.sort(out.eigenvalues), np.linalg.eigvalsh(mat)[:4],
                               atol=1e-10)


def test_parity_linear_equations_on_card(cuda):
    """create_linear_equations on a K6 Problem (a block-sparse operator plus
    3 I): one K6 launch per iteration, the CPU run's iteration count."""
    import iterative_solver_torch as its

    a = _block_sparse(512, 64, 64, 27)
    dense = 0.02 * (a + a.T) + np.diag(np.linspace(1.0, 8.0, 512))
    rhs = np.random.default_rng(28).standard_normal((2, 512))
    runs = {}
    for dev in ("cpu", "cuda"):
        bsr = spmv.BSRMatrix.from_dense(dense, 64, 64, dtype=torch.float32, device=dev)

        class P(its.Problem):
            def action(self, parameters):
                return spmv.bsr_matmat_kernel(parameters, bsr) + 3.0 * parameters

            def diagonals(self):
                return bsr.diagonal + 3.0

        solver = its.create_linear_equations(512, 2, "Davidson", "convergence_threshold=1e-5",
                                             device=dev, dtype=torch.float32)
        solver.verbosity = its.Verbosity.NONE
        solver.add_equations(rhs)
        before = spmv.LAUNCHES["bsr"]
        conv, *_ = solver.solve(np.zeros((2, 512)), problem=P(), generate_initial_guess=True)
        assert conv
        runs[dev] = (solver.stats.iterations, spmv.LAUNCHES["bsr"] - before, solver)
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][1] == runs["cuda"][0] and runs["cpu"][1] == 0
    x = runs["cuda"][2].solution_params([0, 1]).double().cpu().numpy()
    res = np.linalg.norm(x @ (dense + 3.0 * np.eye(512)) - rhs, axis=1)
    assert res.max() <= 1e-4 * np.linalg.norm(rhs, axis=1).max()


@pytest.mark.parametrize("n,b,m", [(512, 256, 16), (400, 200, 5), (8192, 512, 1),
                                   (8192, 512, 4)])
def test_symm_autograd_through_k1_matches_plain(cuda, n, b, m):
    """make_differentiable_symm_action on the card: K1 forward, K1 again as
    its own adjoint (xbar), the tile cotangent (vbar) by einsums; against
    plain autograd through symm_matmat on the same inputs. n = 8192 with
    one and four rows: the shapes of L-BFGS, DIIS and the differentiable
    eigensolve (a partial row block in K1's grid)."""
    import dataclasses

    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(n, 40), b=b, dtype=torch.float32,
                                           device=cuda)
    act = symm.make_differentiable_symm_action(sym)
    rng = np.random.default_rng(41)
    x0 = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=cuda)
    ybar = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=cuda)
    grads = {}
    for name, fn in (("kernel", act), ("plain", lambda xx, vv: symm.symm_matmat(
            xx, dataclasses.replace(sym, values=vv)))):
        x = x0.clone().requires_grad_(True)
        values = sym.values.clone().requires_grad_(True)
        before = symm.LAUNCHES["symm_f32"]
        fn(x, values).backward(ybar)
        torch.cuda.synchronize()
        grads[name] = (x.grad, values.grad, symm.LAUNCHES["symm_f32"] - before)
    (xk, vk, launches), (xp, vp, plain_launches) = grads["kernel"], grads["plain"]
    assert launches == 2 and plain_launches == 0  # forward, then the adjoint
    assert _rel(xk, xp) <= TOL
    assert _rel(vk, vp) <= TOL
    assert vk.dtype == torch.float32 and xk.dtype == torch.float32


def test_symm_autograd_x_only_launches_adjoint_once(cuda):
    """A gradient w.r.t. x alone (the L-BFGS objective's) launches K1 once
    forward and once as the adjoint, and forms no tile cotangent."""
    sym = symm.SymmetricBlocked.from_dense(_sym_matrix(512, 42), b=256, dtype=torch.float32,
                                           device=cuda)
    act = symm.make_differentiable_symm_action(sym)
    x = torch.ones(512, dtype=torch.float32, device=cuda, requires_grad=True)
    before = symm.LAUNCHES["symm_f32"]
    f = 0.5 * torch.dot(x, act(x[None, :], sym.values)[0])
    (g,) = torch.autograd.grad(f, x)
    torch.cuda.synchronize()
    assert symm.LAUNCHES["symm_f32"] - before == 2
    ref = symm.symm_matmat(x.detach()[None, :], sym)[0]
    assert _rel(g, ref) <= TOL


def test_fused_lbfgs_and_diis_on_card(cuda):
    """FusedLBFGS (gradient by autograd through K1) and FusedDIIS (residual
    through K1) at n = 512 on the card, against the same solves on the CPU
    in float32: iterations within 2, solutions within 1e-4."""
    import dataclasses

    from iterative_solver_torch import FusedDIIS, FusedLBFGS

    a = np.random.default_rng(43).standard_normal((512, 512)) * (0.1 / np.sqrt(512))
    mat = a + a.T + np.diag(np.linspace(1.0, 10.0, 512))
    rhs = np.random.default_rng(44).standard_normal(512)
    out = {}
    for dev in ("cpu", "cuda"):
        sym = symm.SymmetricBlocked.from_dense(mat, b=256, dtype=torch.float32, device=dev)
        act = symm.make_differentiable_symm_action(sym)
        b = torch.as_tensor(rhs, dtype=torch.float32, device=dev)

        def vg(x, values):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                f = 0.5 * torch.dot(x, act(x[None, :], values)[0]) - torch.dot(b, x)
                (g,) = torch.autograd.grad(f, x)
            return f.detach(), g

        def residual(x, values):
            s = dataclasses.replace(sym, values=values)
            return symm.symm_matmat_kernel(x[None, :], s)[0] + 0.05 * x * x - b

        lx, _, lg, lit = FusedLBFGS(vg, 512, operand=sym.values, dtype=torch.float32,
                                    convergence_threshold=1e-3, device=dev).run(np.zeros(512))
        dx, derr, dit = FusedDIIS(residual, 512, operand=sym.values, dtype=torch.float32,
                                  diagonals=np.diagonal(mat), convergence_threshold=1e-4,
                                  device=dev).run(np.zeros(512))
        assert lg <= 1e-3 and derr <= 1e-4
        out[dev] = (lx.cpu().numpy(), lit, dx.cpu().numpy(), dit)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 2
    assert abs(out["cuda"][3] - out["cpu"][3]) <= 2
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], atol=1e-4)


def test_differentiable_eigenvalues_on_card(cuda):
    """Eigenvalue gradients w.r.t. the tiles through K1 on the card, at
    n = 1024: d lambda(sA)/ds = lambda, and vbar against the outer-product
    tiles formed in float64 from the solver's own x."""
    from iterative_solver_torch import make_differentiable_eigenvalues

    mat, d = _bench_spectrum(1024, 45)
    sym = symm.SymmetricBlocked.from_dense(mat, b=256, dtype=torch.float32, device=cuda)
    act = symm.make_differentiable_symm_action(sym)
    fn = make_differentiable_eigenvalues(act, 4, 24, tol=1e-5, max_iter=60)
    v0 = torch.as_tensor(_one_hot(d, 4), dtype=torch.float32, device=cuda)
    values = sym.values.clone().requires_grad_(True)
    s = torch.ones((), dtype=torch.float32, device=cuda, requires_grad=True)
    lam = fn(v0, values * s, torch.as_tensor(d, dtype=torch.float32, device=cuda) * s)
    x = lam.grad_fn.saved_tensors[0].double().cpu().numpy()  # the solver's own x
    lam.sum().backward()
    total = float(lam.detach().sum())
    assert abs(float(s.grad) - total) <= 1e-4 * abs(total)
    outer = x.T @ x
    vbar = values.grad.double().cpu().numpy()
    for t, (i, j) in enumerate(zip(sym.ii.tolist(), sym.jj.tolist())):
        blk = outer[i * 256:(i + 1) * 256, j * 256:(j + 1) * 256]
        np.testing.assert_allclose(vbar[t], blk if i == j else 2 * blk, atol=1e-5)


# ---------------------------------------------------------------------------
# the non-hermitian family: dense operators, no kernel of the port's own
# (cuBLAS, cuSOLVER and torch._int_mm), the card against the CPU in float32


def _nonsym_op(n=512, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.concatenate([np.linspace(-2.0, 0.0, 8),
                                          np.linspace(2.0, 20.0, n - 8)]))
    m[np.tril_indices(n, -1)] *= 0.9
    return m


@pytest.mark.parametrize("tier", ["int8", "int8_precise"])
def test_dense_int8_action_on_card_matches_cpu(cuda, tier):
    """The int32 accumulators are exact on both, and the epilogue is the
    same IEEE float32 arithmetic: the card's action equals the CPU's within
    1e-6 of max|y|, and n not a multiple of 8 is refused on the card."""
    from iterative_solver_torch.ops.kernels import dense_int8

    cls, fn = ((dense_int8.DenseInt8, dense_int8.dense_int8_matvec) if tier == "int8" else
               (dense_int8.DenseInt8Split, dense_int8.dense_int8_matvec_split))
    m = _nonsym_op()
    x = np.random.default_rng(1).standard_normal((16, 512))
    y = {}
    for dev in ("cpu", "cuda"):
        y[dev] = fn(torch.as_tensor(x, dtype=torch.float32, device=dev),
                    cls.from_dense(m, device=dev).tree()).cpu()
    assert _rel(y["cuda"], y["cpu"]) <= 1e-6
    with pytest.raises(ValueError, match="multiples of 8"):
        fn(torch.zeros((4, 300), device=cuda), cls.from_dense(np.eye(300), device=cuda).tree())


@pytest.mark.parametrize("tier,rr", [("precise", "device"), ("precise", "host"),
                                     ("fast", "device"), ("int8", "device"),
                                     ("int8_precise", "device")])
def test_nonsym_davidson_on_card_matches_cpu(cuda, tier, rr):
    from iterative_solver_torch import FusedNonSymDavidson

    m = _nonsym_op()
    v0 = _one_hot(np.diag(m), 4)
    out = {}
    for dev in ("cpu", "cuda"):
        s = FusedNonSymDavidson.from_dense(m, 4, tier=tier, rr=rr, m_max=16,
                                           convergence_threshold=2e-4, max_iter=60,
                                           dtype=torch.float32, device=dev)
        ev, x, errs, it = s.solve(v0)
        assert errs.max() <= 2e-4 and x.device.type == dev
        out[dev] = (np.sort(ev.real), it)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 2
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)


@pytest.mark.parametrize("rr", ["device", "host"])
def test_nonsym_lineq_on_card_matches_cpu(cuda, rr):
    from iterative_solver_torch import FusedNonSymLinearEquations

    m = _nonsym_op() + 3.0 * np.eye(512)
    b = np.random.default_rng(2).standard_normal((3, 512))
    ref = np.linalg.solve(m, b.T).T
    its = {}
    for dev in ("cpu", "cuda"):
        s = FusedNonSymLinearEquations.from_dense(m, 3, rr=rr, m_max=16,
                                                  convergence_threshold=1e-5, max_iter=60,
                                                  dtype=torch.float32, device=dev)
        x, errs, its[dev] = s.solve(b)
        assert errs.max() <= 1e-5
        assert np.abs(x.double().cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert abs(its["cuda"] - its["cpu"]) <= 2


def test_nonsym_batched_on_card(cuda):
    """Both batched makers on the card: eigenproblems with stacked int8 trees
    (torch._int_mm once per element under vmap) and shifted systems of one
    shared operator."""
    from iterative_solver_torch import (
        finalize_nonsym_batch,
        make_batched_nonsym_lineq_solve,
        make_batched_nonsym_solve,
    )
    from iterative_solver_torch.ops.kernels import dense_int8

    mats = [_nonsym_op(256, seed) for seed in range(3)]
    trees = [dense_int8.DenseInt8Split.from_dense(m, device=cuda).tree() for m in mats]
    tree = tuple(torch.stack([t[i] for t in trees]) for i in range(5))
    f32 = dict(dtype=torch.float32, device=cuda)
    v0 = torch.as_tensor(np.stack([_one_hot(np.diag(m), 2) for m in mats]), **f32)
    diag = torch.as_tensor(np.stack([np.diag(m) for m in mats]), **f32)
    binit, bsolve = make_batched_nonsym_solve(dense_int8.dense_int8_matvec_split, 2, 10)
    out = bsolve(*binit(v0, tree), tree, diag, 5e-4, 100)
    evals, x_rot, errors = finalize_nonsym_batch(out[3], out[4], out[5])
    for b, m in enumerate(mats):
        assert np.max(errors[b]) <= 1e-3
        w = np.linalg.eigvals(m)
        np.testing.assert_allclose(np.sort(evals[b].real), np.sort(w.real)[:2], atol=1e-3)

    a = mats[0] + 3.0 * np.eye(256)
    sig = np.array([0.0, 0.5, 1.0])
    rhs = np.random.default_rng(3).standard_normal((2, 256))
    op = (torch.as_tensor(a, **f32), torch.as_tensor(sig, **f32))
    bb = torch.as_tensor(np.broadcast_to(rhs, (3, 2, 256)).copy(), **f32)
    bn = torch.as_tensor(np.broadcast_to(np.linalg.norm(rhs, axis=1), (3, 2)).copy(), **f32)
    dg = torch.as_tensor(np.stack([np.diag(a) + s for s in sig]), **f32)
    x0 = bb / dg[:, None, :]

    def mv(x, o):
        return x @ o[0].T + o[1] * x

    binit, bsolve = make_batched_nonsym_lineq_solve(mv, 2, 12, operand_axes=(None, 0))
    res = bsolve(*binit(x0, op, bb), op, dg, bb, bn, 1e-5, 100)
    for k, s in enumerate(sig):
        ref = np.linalg.solve(a + s * np.eye(256), rhs.T).T
        assert float(res[4][k].max()) <= 1e-5
        assert np.abs(res[3][k].double().cpu().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
