"""The port's int8 operator tiers (iterative_solver_torch/ops/kernels/symm_int8.py)
against the JAX package's, on the CPU with the same matrices and inputs.

Tolerances:

- storage, quantization and the int32 accumulators: exact equality (the
  planes, scales, diagonal and topology are byte-identical, so one host
  packing feeds both packages);
- the actions: rtol 1e-6 against the JAX package's XLA paths and its Pallas
  kernels in interpret mode (the only float work is the f32 epilogue,
  whose rounding order a compiler may change).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_torch import convert
from iterative_solver_torch.ops.kernels import symm_int8 as T
from iterative_solver_tpu.ops.kernels import symm_int8 as J

TIERS = {"int8": ("SymmetricBlockedInt8", ("q",)),
         "int8_split": ("SymmetricBlockedInt8Split", ("q1", "q2"))}
FIELDS = ("gq", "ii", "jj", "diagonal")


def _symmetric(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * scale
    return a + a.T


def _block_sparse(n, b, seed):
    """A symmetric matrix with whole zero off-diagonal blocks, which
    ``tol=0.0`` drops from the packed tiles."""
    a = _symmetric(n, seed)
    nb = n // b
    rng = np.random.default_rng(seed + 1)
    for i in range(nb):
        for j in range(i):
            if rng.random() < 0.5:
                a[i * b:(i + 1) * b, j * b:(j + 1) * b] = 0.0
                a[j * b:(j + 1) * b, i * b:(i + 1) * b] = 0.0
    return a


# (n, b, tol): whole tiles, padding (80 -> 96, 100 -> 128), b = n, tile dropping
PACKINGS = [(96, 32, None), (80, 32, None), (100, 64, None), (64, 64, None),
            (128, 32, 0.0)]


def _pair(tier, n, b, tol, seed=0):
    cls, _ = TIERS[tier]
    mat = _block_sparse(n, b, seed) if tol is not None else _symmetric(n, seed)
    return (getattr(J, cls).from_dense(mat, b=b, tol=tol),
            getattr(T, cls).from_dense(mat, b=b, tol=tol, device="cpu"))


@pytest.mark.parametrize("n,b,tol", PACKINGS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_storage_is_byte_identical(tier, n, b, tol):
    js, ts = _pair(tier, n, b, tol)
    assert ts.shape == js.shape and ts.b == js.b and ts.n_pairs == js.n_pairs
    if tol is not None:
        assert ts.n_pairs < (n // b) * (n // b + 1) // 2
    for name in TIERS[tier][1] + FIELDS:
        ref = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("n_pad,b,dots", [(8192, 1024, 1), (131072, 1024, 1),
                                          (133120, 1024, 1), (65536, 512, 2),
                                          (66560, 512, 2), (4096, 32, 2)])
def test_headroom_refusals_match_jax(n_pad, b, dots):
    def outcome(fn):
        try:
            fn(n_pad, b, dots, "tier")
        except ValueError as e:
            return str(e)
        return None

    ref = outcome(J._check_acc_headroom)
    assert outcome(T._check_acc_headroom) == ref
    worst = dots * n_pad * 127 * 127
    assert (ref is not None) == (worst >= 2 ** 31)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_from_dense_refuses_asymmetric(tier):
    cls = getattr(T, TIERS[tier][0])
    with pytest.raises(ValueError, match="symmetric"):
        cls.from_dense(np.arange(16.0).reshape(4, 4), b=4, device="cpu")


def _rows(m, n, seed, zero_row=True):
    x = np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32) * 3.0
    if zero_row:
        x[1] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_bit_equal(seed):
    xs = _rows(5, 200, seed)
    qj, sj = J.quantize_rows(jnp.asarray(xs))
    qt, st = T.quantize_rows(torch.from_numpy(xs))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert np.all(qt.numpy()[1] == 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_split_bit_equal(seed):
    xs = _rows(5, 200, seed)
    got = T.quantize_rows_split(torch.from_numpy(xs))
    ref = J.quantize_rows_split(jnp.asarray(xs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_quantize_rows_half_to_even():
    # 0.5 and 2.5 quantization steps: torch.round and jnp.round both round
    # half to even
    xs = np.array([[127.0, 0.5, 2.5, -1.5, 3.5]], dtype=np.float32)
    qj, _ = J.quantize_rows(jnp.asarray(xs))
    qt, _ = T.quantize_rows(torch.from_numpy(xs))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy(), [[127, 0, 2, -2, 4]])


# pairs_per_pass None: all pairs in one contraction; 2: in passes of two
# pairs (the card's check at the benchmark's size), the same bits
@pytest.mark.parametrize("n,b,tol", PACKINGS)
@pytest.mark.parametrize("m,pairs_per_pass", [(1, None), (4, None), (4, 2)],
                         ids=["1", "4", "4-passes"])
def test_int32_accumulator_equals_jax(n, b, tol, m, pairs_per_pass):
    js, ts = _pair("int8", n, b, tol, seed=3)
    n_pad = ts.shape[0]
    qx = np.random.default_rng(4).integers(-127, 128, (m, n_pad)).astype(np.int8)
    nb = n_pad // ts.b
    ref = np.asarray(J._symm_matmat_int8_xla(jnp.asarray(qx), js.q, (js.ii, js.jj), js.b, nb))
    got = T._symm_matmat_int8_plain(torch.from_numpy(qx), ts.q, ts.ii, ts.jj, ts.b, nb,
                                    pairs_per_pass)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


ACTIONS = {"int8": (J.symm_matmat_int8, T.symm_matmat_int8, J.symm_matmat_int8_pallas),
           "int8_split": (J.symm_matmat_int8_split, T.symm_matmat_int8_split,
                          J.symm_matmat_int8_split_pallas)}


@pytest.mark.parametrize("n,b,tol", PACKINGS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tier", sorted(ACTIONS))
def test_action_matches_jax(tier, n, b, tol, dtype):
    js, ts = _pair(tier, n, b, tol, seed=5)
    x = _rows(4, ts.shape[0], 6).astype(dtype)
    jfn, tfn, _ = ACTIONS[tier]
    ref = np.asarray(jfn(jnp.asarray(x), js))
    got = tfn(torch.from_numpy(x), ts)
    assert got.dtype == torch.from_numpy(x).dtype  # f32 inside, cast back
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("n,b", [(96, 32), (128, 64)])
@pytest.mark.parametrize("tier", sorted(ACTIONS))
def test_action_matches_jax_pallas_interpret(tier, n, b):
    """As tests/test_symm_int8.py runs the Pallas kernels on the CPU."""
    js, ts = _pair(tier, n, b, None, seed=7)
    x = _rows(4, n, 8)
    _, tfn, pfn = ACTIONS[tier]
    ref = np.asarray(pfn(jnp.asarray(x), js, interpret=True))
    got = tfn(torch.from_numpy(x), ts).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_wrappers_take_the_plain_version_on_cpu(tier):
    _, ts = _pair(tier, 96, 32, None, seed=9)
    x = torch.from_numpy(_rows(3, 96, 10))
    kernel, plain = {"int8": (T.symm_matmat_int8_kernel, T.symm_matmat_int8),
                     "int8_split": (T.symm_matmat_int8_split_kernel,
                                    T.symm_matmat_int8_split)}[tier]
    before = dict(T.LAUNCHES)
    assert torch.equal(kernel(x, ts), plain(x, ts))
    assert T.LAUNCHES == before  # no launch is counted for the plain version


def test_missing_diagonal_reads_as_zeros():
    js, ts = _pair("int8", 64, 32, None, seed=11)
    js = js.__class__(**{**js.__dict__, "diagonal": None})
    ts = ts.__class__(**{**ts.__dict__, "diagonal": None})
    x = _rows(2, 64, 12)
    ref = np.asarray(J.symm_matmat_int8(jnp.asarray(x), js))
    got = T.symm_matmat_int8(torch.from_numpy(x), ts).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(T._diag_or_zeros(ts).numpy(), np.zeros(64, np.float32))


@pytest.mark.parametrize("two_plane", [False, True])
def test_make_int8_matvec_matches_jax(two_plane):
    mat = _symmetric(160, 13, scale=0.1) + np.diag(np.linspace(0.0, 10.0, 160))
    jmv, jop, _ = J.make_int8_matvec(mat, b=64, two_plane=two_plane, use_pallas=False)
    tmv, top, tsym = T.make_int8_matvec(mat, b=64, two_plane=two_plane, device="cpu")
    assert len(top) == len(jop)
    for got, ref in zip(top, jop):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    x = np.random.default_rng(14).standard_normal((3, tsym.shape[0]))
    ref = np.asarray(jmv(jnp.asarray(x), jop))
    got = tmv(torch.from_numpy(x), top)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_convert_carries_jax_storage(tier):
    js, ts = _pair(tier, 100, 64, None, seed=15)
    planes = [np.asarray(getattr(js, p)) for p in TIERS[tier][1]]
    fn = convert.symmetric_blocked_int8 if tier == "int8" else convert.symmetric_blocked_int8_split
    got = fn(*planes, np.asarray(js.gq), np.asarray(js.ii), np.asarray(js.jj), js.shape,
             js.b, diagonal=np.asarray(js.diagonal), device="cpu")
    assert got.shape == ts.shape and got.b == ts.b
    for name in TIERS[tier][1] + FIELDS:
        assert torch.equal(getattr(got, name), getattr(ts, name)), name


# K4's walk (``int8_square_walk``, the kernel's order in plain PyTorch): b
# below the 64-wide chunk (32), ragged chunks (96, 200), whole 256-wide
# squares (1024), and tiles dropped by ``tol``; m = 17 takes two M tiles,
# m = 64 four, m = 65 a second pass of 64 rows
WALKS = [(96, 32, None), (288, 96, None), (400, 200, None), (2048, 1024, None),
         (384, 96, 0.0), (3072, 1024, 0.0)]


def _walk_operand(n, b, tol):
    mat = _block_sparse(n, b, 16) if tol is not None else _symmetric(n, 16)
    ts = T.SymmetricBlockedInt8.from_dense(mat, b=b, tol=tol, device="cpu")
    if tol is not None:
        assert ts.n_pairs < (n // b) * (n // b + 1) // 2
    return ts


# the square walk at every M tiling; K4's band walk (one M tile, b a
# multiple of 16) at m = 1, 6 and 16
WALK_CASES = ([pytest.param(n, b, tol, m, "square", id=f"{n}-{b}-{tol}-{m}")
               for n, b, tol in WALKS for m in (1, 16, 17, 64, 65)]
              + [pytest.param(n, b, tol, m, "band", id=f"{n}-{b}-{tol}-{m}-band")
                 for n, b, tol in WALKS if b % 16 == 0 for m in (1, 6, 16)])


@pytest.mark.parametrize("n,b,tol,m,walk", WALK_CASES)
def test_square_walk_equals_plain(n, b, tol, m, walk):
    ts = _walk_operand(n, b, tol)
    qx = np.random.default_rng(17).integers(-127, 128, (m, ts.shape[0])).astype(np.int8)
    qx[m // 2] = 0
    qx = torch.from_numpy(qx)
    got = T.int8_square_walk(qx, ts.q, ts.ii, ts.jj, ts.b, walk=walk)
    ref = T._symm_matmat_int8_plain(qx, ts.q, ts.ii, ts.jj, ts.b, ts.shape[0] // ts.b)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)


def _split_walk_operand(n, b, tol):
    mat = _block_sparse(n, b, 18) if tol is not None else _symmetric(n, 18)
    return T.SymmetricBlockedInt8Split.from_dense(mat, b=b, tol=tol, device="cpu")


# K5's walk: the same squares and chunks on two planes, passes of 16 rows
# (m = 17 and 40 take two and three)
@pytest.mark.parametrize("m", [1, 16, 17, 40])
@pytest.mark.parametrize("n,b,tol", WALKS)
def test_split_square_walk_equals_plain(n, b, tol, m):
    ts = _split_walk_operand(n, b, tol)
    rng = np.random.default_rng(19)
    p1, p2 = (torch.from_numpy(rng.integers(-127, 128, (m, ts.shape[0])).astype(np.int8))
              for _ in range(2))
    p1[m // 2] = 0
    hi, lo = T.int8_square_walk(p1, ts.q1, ts.ii, ts.jj, ts.b, p2=p2, q2=ts.q2)
    nb = ts.shape[0] // ts.b
    ref_hi = T._symm_matmat_int8_plain(p1, ts.q1, ts.ii, ts.jj, ts.b, nb)
    ref_lo = (T._symm_matmat_int8_plain(p1, ts.q2, ts.ii, ts.jj, ts.b, nb)
              + T._symm_matmat_int8_plain(p2, ts.q1, ts.ii, ts.jj, ts.b, nb))
    assert hi.dtype == lo.dtype == torch.int32
    assert torch.equal(hi, ref_hi)
    assert torch.equal(lo, ref_lo)


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("n,b,tol", WALKS + [(150, 50, None), (75, 25, None)])
def test_flush_atomics_count_by_numpy(n, b, tol, planes):
    """``int8_flush_atomics`` against a numpy count over the walk's squares:
    per accumulator (one, or hi and lo), row of x and square, one sum per
    row of the square and, off the diagonal, one per column; two sums to a
    64-bit red where b is even."""
    ts = _walk_operand(n, b, tol) if planes == 1 else _split_walk_operand(n, b, tol)
    ii, jj = ts.ii.numpy(), ts.jj.numpy()
    nsq = -(-b // T.SQUARE_INT8)
    t = np.repeat(np.arange(ts.n_pairs), nsq * nsq)
    s = np.tile(np.arange(nsq * nsq), ts.n_pairs)
    rows = np.minimum(T.SQUARE_INT8, b - (s // nsq) * T.SQUARE_INT8)
    cols = np.minimum(T.SQUARE_INT8, b - (s % nsq) * T.SQUARE_INT8)
    per_x_row = np.sum(rows + np.where(ii[t] != jj[t], cols, 0))
    # the band walk: per band, its rows (y_i) and, off the diagonal, all b
    # columns of the tile (y_j)
    bpt = -(-b // T.BAND_INT8)
    tb = np.repeat(np.arange(ts.n_pairs), bpt)
    band_rows = np.minimum(T.BAND_INT8, b - np.tile(np.arange(bpt), ts.n_pairs) * T.BAND_INT8)
    per_x_row_band = np.sum(band_rows + np.where(ii[tb] != jj[tb], b, 0))
    for m in (1, 16, 17, 64):
        sums, reds = T.int8_flush_atomics(ii, jj, b, m, planes=planes)
        assert sums == planes * m * int(per_x_row)
        assert reds == (sums // 2 if b % 2 == 0 else sums)
        if planes == 1 and m <= 16:
            # one 32-bit red a sum
            assert T.int8_flush_atomics(ii, jj, b, m, walk="band") == (
                m * int(per_x_row_band),) * 2


@pytest.mark.parametrize("walk,sums,reds", [("band", 667_942_912, 667_942_912),
                                            ("square", 1_073_741_824, 536_870_912)])
def test_flush_atomics_at_the_benchmark_cell(walk, sums, reds):
    """The benchmark's operator (n = 131072, b = 1024: 8256 tile pairs, 128
    on the diagonal) at 16 rows of x: the band walk flushes 256 + 1024
    sums a band and row of x, each a 32-bit red; the square walk 4 x 512,
    two to a 64-bit red."""
    ii, jj = np.tril_indices(128)
    assert ii.size == 8256
    assert T.int8_flush_atomics(ii, jj, 1024, 16, walk=walk) == (sums, reds)


@pytest.mark.parametrize("n,b,tol", WALKS)
def test_square_items_cover_every_tile_element_once(n, b, tol):
    """Each tile element lies in exactly one chunk of one work item; an
    off-diagonal tile's elements give two contributions, a diagonal tile's
    one; and ``int8_flush_atomics`` counts one int32 sum per row of x and
    contributed row or column of every item, two to a 64-bit red where b is
    even."""
    ts = _walk_operand(n, b, tol)
    ii, jj = ts.ii.numpy(), ts.jj.numpy()
    cover = np.zeros((ts.n_pairs, b, b), dtype=np.int64)
    contributions = np.zeros_like(cover)
    flushes_i = flushes_j = 0
    items = list(T.int8_square_items(ts.n_pairs, b))
    assert len(items) == ts.n_pairs * (-(-b // T.SQUARE_INT8)) ** 2
    for t, r0, c0 in items:
        r1, c1 = min(r0 + T.SQUARE_INT8, b), min(c0 + T.SQUARE_INT8, b)
        for c in range(c0, c1, T.CHUNK_INT8):
            for a in range(r0, r1, T.CHUNK_INT8):
                cover[t, a:min(a + T.CHUNK_INT8, r1), c:min(c + T.CHUNK_INT8, c1)] += 1
        contributions[t, r0:r1, c0:c1] += 1 if ii[t] == jj[t] else 2
        flushes_i += r1 - r0
        flushes_j += 0 if ii[t] == jj[t] else c1 - c0
    assert np.all(cover == 1)
    assert np.all(contributions[ii == jj] == 1) and np.all(contributions[ii != jj] == 2)
    for m in (1, 64, 65):
        sums, reds = T.int8_flush_atomics(ii, jj, b, m)
        assert sums == m * (flushes_i + flushes_j)
        assert reds == (sums // 2 if b % 2 == 0 else sums)


@pytest.mark.parametrize("m,tiles", [(1, 1), (16, 1), (17, 2), (32, 2), (33, 4), (64, 4),
                                     (65, 4)])
def test_m_tiles_per_block(m, tiles):
    assert T.int8_m_tiles(m) == tiles


# (m, b, n_pairs, sms, aligned, planes) -> walk: the benchmark's operator
# (8256 pairs of 1024) takes the band walk at 16 rows on 132 SMs; 36 pairs
# (n = 8192) give 144 bands, 528 of 256 (b = 256) 528: under 8 an SM
WALK_CHOICES = [
    ((16, 1024, 8256, 132, True, 1), "band"),
    ((1, 1024, 8256, 132, True, 1), "band"),
    ((17, 1024, 8256, 132, True, 1), "square"),
    ((64, 1024, 8256, 132, True, 1), "square"),
    ((16, 1024, 8256, 132, False, 1), "square"),
    ((16, 1000, 8256, 132, True, 1), "square"),
    ((16, 2048, 8256, 132, True, 1), "square"),
    ((16, 1024, 8256, 132, True, 2), "square"),
    ((16, 1024, 36, 132, True, 1), "square"),
    ((6, 256, 528, 132, True, 1), "square"),
    ((16, 1024, 264, 132, True, 1), "band"),
    ((16, 1024, 263, 132, True, 1), "square"),
    ((16, 1024, 263, 100, True, 1), "band"),
    ((16, 96, 1056, 132, True, 1), "band"),
]


@pytest.mark.parametrize("args,walk", WALK_CHOICES)
def test_walk_choice(args, walk):
    """The band walk only at one M tile, b a multiple of 16 up to 1024 with
    16-byte aligned operands, and at least 8 bands an SM (the SM count
    passed in); the square walk otherwise, and always for K5."""
    assert T.int8_walk(*args) == walk


@pytest.mark.parametrize("walk", ["band", "square"])
def test_walk_counters_count_one_a_call(walk):
    """``K4_WALKS`` counts every call of its walk; the profiler's
    ``int8_band_calls`` and ``int8_square_calls`` count that walk's calls
    inside a traced solve only."""
    from torch.profiler import ProfilerActivity, profile

    from iterative_solver_torch.utils import profiler as P

    P.reset()
    before = dict(T.K4_WALKS)
    T._record_walk(walk)
    with profile(activities=[ProfilerActivity.CPU]):
        T._record_walk(walk)
        T._record_walk(walk)
    assert T.K4_WALKS == {**before, walk: before[walk] + 3}
    assert P.snapshot()["counters"] == {f"int8_{walk}_calls": 2}
    P.reset()
