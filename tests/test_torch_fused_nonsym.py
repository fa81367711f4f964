"""The port's non-hermitian family (iterative_solver_torch/solvers/
fused_nonsym.py) against the JAX package's, on the CPU with the same numpy
inputs and options, seeded from tests/test_fused_nonsym.py,
test_fuzz.py::test_fuzz_fused_nonsym and _lineq, test_checkpoint.py's
non-hermitian checkpoints and test_fused_pspace.py's non-hermitian P space.

- ``ritz_nonsym`` is a numpy copy: equal outputs.
- Real spectra in float64 (host and device RR, P space, the linear
  equations, both batched makers): JAX's iteration counts exactly,
  eigenvalues and solutions within 1e-10.
- float32 solves: iteration counts within 2 (or, at an unreachable
  tolerance, the floor class of both).
- The complex-pair regime does not reproduce between the packages
  iteration for iteration (ROADMAP Queue 3): compared by the escalation
  flag, convergence and the eigenvalues.
- Checkpoints written by either package resume in the other.
- Every refusal the JAX tests pin raises ``ValueError`` here too.

No test reads the reference hamiltonians: the hf tests' wrong-root and P
space cases stand on ``_coupled`` operators, where the per-root inverse
iteration without the global selection step ends on a wrong root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from iterative_solver_tpu.solvers import fused_nonsym as J
from iterative_solver_torch.solvers import fused_nonsym as T


def reference_matrix(n, param=1.0, strength=0.0):
    """test_LinearEigensystem.cpp:41-51's construction."""
    m = np.ones((n, n))
    np.fill_diagonal(m, np.arange(n) * param)
    if strength:
        for i in range(n):
            m[i, :i] *= 1.0 - strength
    return m


def gapped_nonsym(n, nlow=8, strength=0.1, seed=0, coupling=0.05):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (coupling / np.sqrt(n))
    d = np.concatenate([np.linspace(-2.0, 0.0, nlow), np.linspace(2.0, 20.0, n - nlow)])
    m = a + a.T + np.diag(d)
    m[np.tril_indices(n, -1)] *= 1.0 - strength
    return m


def _coupled():
    """Strong couplings (0.6/sqrt(n)) at n = 64: the lowest eigenvectors
    mix the diagonal's coordinates, so a one-hot guess overlaps them
    poorly, as on the reference's hf hamiltonian."""
    return gapped_nonsym(64, 8, 0.1, seed=36, coupling=0.6)


def pair_heavy(n, seed, rot, cpl, gap, npairs=6):
    """tests/test_fused_nonsym.py::TestAutoEscalatingRR.pair_heavy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (cpl / np.sqrt(n))
    lows = np.arange(2 * npairs) * gap - 2.0
    m = a + a.T + np.diag(np.concatenate([lows, np.linspace(2.0, 20.0, n - 2 * npairs)]))
    for k in range(0, 2 * npairs, 2):
        m[k, k + 1] += rot
        m[k + 1, k] -= rot
    m[np.tril_indices(n, -1)] *= 0.85
    return m


def planted_pair(n=128):
    """A conjugate pair 1 ± 1.5i planted below a real spectrum."""
    rng = np.random.default_rng(5)
    m = np.diag(np.linspace(5.0, 25.0, n))
    m += rng.standard_normal((n, n)) * 0.01
    m[0, 0] = m[1, 1] = 1.0
    m[0, 1], m[1, 0] = -1.5, 1.5
    m[0, 2:] = m[1, 2:] = m[2:, 0] = m[2:, 1] = 0.0
    return m


def lineq_problem(n, strength, seed=0, nrhs=3, low=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.linspace(low, 20.0, n))
    m[np.tril_indices(n, -1)] *= 1.0 - strength
    return m, rng.standard_normal((nrhs, n))


def jmv(x, op):
    return jnp.matmul(x, op.T, precision=jax.lax.Precision.HIGHEST)


def tmv(x, op):
    return torch.matmul(x, op.T)


def guess(m, nroots, skip=0):
    v0 = np.zeros((nroots, m.shape[0]))
    for row, i in enumerate(np.argsort(np.diag(m))[skip:skip + nroots]):
        v0[row, i] = 1.0
    return v0


def dense_lowest(m, nroots):
    w = scipy.linalg.eigvals(m)
    return w[np.argsort(w.real, kind="stable")][:nroots]


def _eig_pair(m, r, jdtype=None, tdtype=None, **kw):
    """(jax solver, port solver) on the dense operator m."""
    n = m.shape[0]
    jop = jnp.asarray(m, jdtype) if jdtype else jnp.asarray(m)
    tdt = tdtype or torch.float64
    js = J.FusedNonSymDavidson(jmv, np.diag(m), n, r, operand=jop, dtype=jdtype, **kw)
    ts = T.FusedNonSymDavidson(tmv, np.diag(m), n, r, operand=torch.as_tensor(m, dtype=tdt),
                               dtype=tdtype, device="cpu", **kw)
    return js, ts


def _solve_both(m, r, v0=None, **kw):
    js, ts = _eig_pair(m, r, **kw)
    v0 = guess(m, r) if v0 is None else v0
    return js.solve(v0), ts.solve(v0), js, ts


def _assert_same_solve(jres, tres, tol=1e-10):
    jev, jx, jerr, jit = jres
    tev, tx, terr, tit = tres
    assert isinstance(tx, torch.Tensor) and isinstance(terr, np.ndarray)
    assert tit == jit, (tit, jit)
    assert len(tev) == len(jev)
    np.testing.assert_allclose(np.sort_complex(np.asarray(tev)),
                               np.sort_complex(np.asarray(jev)), rtol=0, atol=tol)
    # the residual norms of a converged solve sit near rounding: loose
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=1e-2, atol=1e-10)


def _true_residuals(x, evals, m):
    """||x_i Aᵀ - λ_i x_i|| of each real root's row, in f64."""
    x64 = np.asarray(x, np.float64)
    return {i: float(np.linalg.norm(x64[i] @ m.T - evals[i].real * x64[i]))
            for i in range(len(evals)) if evals[i].imag == 0}


# ---------------------------------------------------------------------------
# ritz_nonsym: a numpy copy


def _ritz_inputs():
    rng = np.random.default_rng(0)
    real = rng.standard_normal((12, 12)) * 0.1 + np.diag(np.arange(12.0))
    pair = np.diag(np.arange(6.0) + 3.0)
    pair[0, 0] = pair[1, 1] = 1.0
    pair[0, 1], pair[1, 0] = -2.0, 2.0
    straddle = np.diag(np.arange(6.0) + 3.0)
    straddle[3, 3] = straddle[4, 4] = 30.0
    straddle[3, 4], straddle[4, 3] = -1.0, 1.0
    return [(real, 4), (pair, 3), (straddle, 2), (straddle, 4), (straddle, 6),
            (pair_heavy(40, 0, 0.8, 0.1, 0.1), 6)]


@pytest.mark.parametrize("case", range(6))
def test_ritz_nonsym_equals_jax(case):
    h, r = _ritz_inputs()[case]
    for got, ref in zip(T.ritz_nonsym(h, r), J.ritz_nonsym(h, r)):
        np.testing.assert_array_equal(got, ref)


def test_ritz_pair_block_reproduces_the_action():
    h, r = _ritz_inputs()[1]
    evals, coeff, lam, shifts = T.ritz_nonsym(h, r)
    assert evals[0] == pytest.approx(1 + 2j) and evals[1] == pytest.approx(1 - 2j)
    np.testing.assert_allclose(coeff @ h.T, lam @ coeff, atol=1e-12)


# ---------------------------------------------------------------------------
# host RR (rr="host")


@pytest.mark.parametrize("strength", [0.0, 0.1, 0.2])
def test_reference_sweep_matrix_host(strength):
    m = reference_matrix(64, strength=strength)
    jres, tres, _, _ = _solve_both(m, 3, m_max=16, convergence_threshold=1e-9, max_iter=60)
    _assert_same_solve(jres, tres)
    assert np.all(tres[2] <= 1e-8)
    np.testing.assert_allclose(np.sort(tres[0].real), np.sort(dense_lowest(m, 3).real),
                               atol=1e-7)


@pytest.mark.parametrize("rr", ["host", "device"])
@pytest.mark.parametrize("strength", [0.1, 0.3])
def test_gapped_nonsym(rr, strength):
    m = gapped_nonsym(512, strength=strength)
    jres, tres, _, _ = _solve_both(m, 4, m_max=16, convergence_threshold=1e-9,
                                   max_iter=120, rr=rr)
    _assert_same_solve(jres, tres)
    np.testing.assert_allclose(np.sort(tres[0].real), np.sort(dense_lowest(m, 4).real),
                               atol=1e-8)
    if rr == "device":
        # the reported errors ARE the true per-root residuals (the rotation
        # uses LEFT eigenvectors of G)
        for i, true_r in _true_residuals(tres[1], tres[0], m).items():
            assert true_r <= 10 * max(tres[2][i], 1e-12), (i, true_r, tres[2][i])


def test_symmetric_matches_eigh():
    m = gapped_nonsym(256, strength=0.0, seed=3)
    jres, tres, _, _ = _solve_both(m, 4, m_max=16, convergence_threshold=1e-10, max_iter=60)
    _assert_same_solve(jres, tres)
    np.testing.assert_allclose(tres[0].real, np.linalg.eigvalsh(m)[:4], atol=1e-9)
    assert np.all(tres[0].imag == 0)


def test_inner_enrichment_host():
    m = gapped_nonsym(300, strength=0.15, seed=1)
    jres, tres, _, _ = _solve_both(m, 3, m_max=15, convergence_threshold=1e-9,
                                   max_iter=100, inner=2)
    _assert_same_solve(jres, tres)


@pytest.mark.parametrize("rr,rr_steps", [("host", 1), ("device", 2)])
def test_complex_pair_invariant_subspace(rr, rr_steps):
    """A planted pair 1 ± 1.5i: converged, the same eigenvalues, and rows
    spanning the A-invariant 2D subspace."""
    m = planted_pair()
    jres, tres, _, _ = _solve_both(m, 3, m_max=16, convergence_threshold=1e-9,
                                   max_iter=160, rr=rr, rr_steps=rr_steps)
    assert np.all(tres[2] <= 1e-8) and np.all(np.asarray(jres[2]) <= 1e-8)
    pair = sorted(tres[0][:2], key=lambda z: -z.imag)
    assert pair[0] == pytest.approx(1 + 1.5j, abs=1e-7)
    assert pair[1] == pytest.approx(1 - 1.5j, abs=1e-7)
    np.testing.assert_allclose(np.sort_complex(tres[0]), np.sort_complex(jres[0]),
                               atol=1e-8)
    x64 = tres[1].numpy()[:2]
    ax = x64 @ m.T
    lam2, *_ = np.linalg.lstsq(x64.T, ax.T, rcond=None)
    np.testing.assert_allclose(ax, lam2.T @ x64, atol=1e-7)


@pytest.mark.parametrize("floor", ["host", "device"])
def test_f32_floor_returns_best(floor):
    """An unreachable tolerance in float32: both packages return the best
    snapshot at the floor, not a contaminated state."""
    m = gapped_nonsym(512, nlow=8, strength=0.1, seed=6)
    kw = dict(m_max=12, convergence_threshold=1e-12, max_iter=40, rr=floor,
              jdtype=jnp.float32, tdtype=torch.float32)
    jres, tres, _, _ = _solve_both(m, 3, **kw)
    ref = np.sort(dense_lowest(m, 3).real)
    for ev, errs in ((tres[0], tres[2]), (jres[0], jres[2])):
        assert np.max(errs) < 1e-3, errs
        np.testing.assert_allclose(np.sort(np.asarray(ev).real), ref, atol=1e-3)
    assert abs(tres[3] - jres[3]) <= 2, (tres[3], jres[3])


def test_convergence_history_recorded():
    m = gapped_nonsym(300, strength=0.15, seed=1)
    for mode, ci in (("host", 64), ("device", 3)):
        js, ts = _eig_pair(m, 3, m_max=12, convergence_threshold=1e-9, max_iter=100,
                           rr=mode, chunk_iters=ci)
        v0 = guess(m, 3)
        js.solve(v0)
        ts.solve(v0)
        assert [h[0] for h in ts.history] == [h[0] for h in js.history], mode
        np.testing.assert_allclose([h[1] for h in ts.history],
                                   [h[1] for h in js.history], rtol=1e-2, atol=1e-12)
        assert ts.history[-1][1] <= 1e-9
        ts.solve(v0)    # a second solve restarts the record
        assert ts.history[-1][1] <= 1e-9 and len(ts.history) == len(js.history)


# ---------------------------------------------------------------------------
# device RR (rr="device")


def test_device_multi_chunk_continuation():
    m = gapped_nonsym(300, strength=0.1, seed=2)
    jres, tres, _, _ = _solve_both(m, 4, m_max=16, convergence_threshold=1e-9,
                                   max_iter=120, rr="device", chunk_iters=2)
    _assert_same_solve(jres, tres)


def test_device_tight_m_max_restarts_in_loop():
    m = gapped_nonsym(256, strength=0.1, seed=4)
    jres, tres, _, _ = _solve_both(m, 4, m_max=12, convergence_threshold=1e-7,
                                   max_iter=300, rr="device")
    _assert_same_solve(jres, tres)
    assert tres[3] <= 40


def test_device_rr_finds_interior_root_standin(monkeypatch):
    """The hf regression's stand-in: on ``_coupled()`` the device tier finds
    the two lowest roots in JAX's iteration count, and without the gated
    global selection step the per-root inverse iteration ends on a wrong
    root (0.24 off after 60 iterations), as it did on hf."""
    m = _coupled()
    ref = np.sort(dense_lowest(m, 2).real)
    kw = dict(convergence_threshold=1e-8, max_iter=60, rr="device", m_max=8)
    jres = J.FusedNonSymDavidson.from_dense(m, 2, **kw).solve(guess(m, 2))
    tres = T.FusedNonSymDavidson.from_dense(m, 2, device="cpu", **kw).solve(guess(m, 2))
    _assert_same_solve(jres, tres)
    assert np.max(np.abs(np.sort(tres[0].real) - ref)) < 1e-8

    refine = T._make_refine

    def without_global(r, m_max, rr_steps):
        f = refine(r, m_max, rr_steps)
        return lambda C, h, mask, do_global: f(C, h, mask, False)

    monkeypatch.setattr(T, "_make_refine", without_global)
    ev, _, _, it = T.FusedNonSymDavidson.from_dense(m, 2, device="cpu", **kw).solve(
        guess(m, 2))
    assert np.max(np.abs(np.sort(ev.real) - ref)) > 0.1, ev


@pytest.mark.parametrize("r,mm,gap", [(6, 24, 0.10), (4, 16, 0.12)])
def test_pair_heavy_escalates_and_converges(r, mm, gap):
    """The complex-pair regime: both packages escalate to two refinement
    passes, converge and agree on the eigenvalues."""
    m = pair_heavy(400, 0, 0.8, 0.1, gap)
    jres, tres, js, ts = _solve_both(m, r, m_max=mm, convergence_threshold=1e-9,
                                     max_iter=500, rr="device")
    assert ts.rr_steps_active == js.rr_steps_active == 2
    assert tres[2].max() <= 1e-9 and np.asarray(jres[2]).max() <= 1e-9
    np.testing.assert_allclose(np.sort_complex(tres[0]), np.sort_complex(jres[0]),
                               atol=1e-7)
    np.testing.assert_allclose(np.sort(tres[0].real), np.sort(dense_lowest(m, r).real),
                               atol=1e-7)


def test_real_spectrum_never_escalates():
    m = gapped_nonsym(300, strength=0.2, seed=3)
    jres, tres, js, ts = _solve_both(m, 3, m_max=12, convergence_threshold=1e-9,
                                     max_iter=200, rr="device", chunk_iters=8)
    _assert_same_solve(jres, tres)
    assert ts.rr_steps_active == js.rr_steps_active == 1


# ---------------------------------------------------------------------------
# refusals pinned by the JAX tests


def _refusals(mod, mv):
    nsd, nle = mod.FusedNonSymDavidson, mod.FusedNonSymLinearEquations
    kw = {"device": "cpu"} if mod is T else {}
    return [
        (lambda: nsd(mv, np.zeros(8), 8, 2, rr="wat", **kw), "rr must be"),
        (lambda: nle(mv, np.zeros(8), 8, 2, rr="wat", **kw), "rr must be"),
        (lambda: nsd(mv, np.zeros(8), 8, 2, rr="device", inner=2, **kw), "inner enrichment"),
        (lambda: nle(mv, np.zeros(8), 8, 2, rr="device", inner=2, **kw), "inner enrichment"),
        (lambda: nsd(mv, np.ones(16), 16, 2, p_space=[{0: 1.0}], rr="host", **kw),
         "device tier"),
        (lambda: nle(mv, np.ones(16), 16, 2, p_space=[{0: 1.0}], rr="host", **kw),
         "device tier"),
        (lambda: nsd(mv, np.ones(16), 16, 4, m_max=6, **kw), "m_max must be"),
        (lambda: nsd(mv, np.ones(16), 16, 2, max_iter=0, **kw), "max_iter"),
        (lambda: nsd.from_dense(np.eye(8), 2, tier="wat", **kw), "tier must be"),
        (lambda: nle.from_dense(np.eye(8), 2, tier="wat", **kw), "tier must be"),
        (lambda: nsd(mv, np.ones(16), 16, 2, **kw).solve(np.zeros((2, 16)),
                                                         checkpoint_path="x.npz"),
         "device-tier"),
    ]


@pytest.mark.parametrize("case", range(11))
def test_refusals_match_jax(case):
    for mod, mv in ((J, jmv), (T, tmv)):
        fn, match = _refusals(mod, mv)[case]
        with pytest.raises(ValueError, match=match):
            fn()


def test_too_few_live_directions_raises():
    """n_p < nroots with every guess inside span(P) would return a
    fabricated eigenvalue 0: both tiers refuse on the host."""
    n = 64
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * 0.02
    m = a + a.T + np.diag(np.linspace(1.0, 8.0, n))
    m[np.tril_indices(n, -1)] *= 0.9
    p = np.zeros((1, n))
    p[0, 0] = 1.0
    v0 = np.vstack([p[0], p[0]])
    op = torch.as_tensor(m)
    s = T.FusedNonSymDavidson(tmv, np.diag(m), n, 2, m_max=10, rr="device", operand=op,
                              p_space=p, device="cpu")
    with pytest.raises(ValueError, match="outside the P span"):
        s.solve(v0)
    sl = T.FusedNonSymLinearEquations(tmv, np.diag(m), n, 2, m_max=10, rr="device",
                                      operand=op, p_space=p, device="cpu")
    with pytest.raises(ValueError, match="outside the P span"):
        sl.solve(np.ones((2, n)), x0=v0)


def test_sharding_and_card_default_raise():
    with pytest.raises(NotImplementedError, match="item 6"):
        T.FusedNonSymDavidson(tmv, np.ones(8), 8, 2, sharding=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.FusedNonSymDavidson(tmv, np.ones(8), 8, 2)


# ---------------------------------------------------------------------------
# P space (device tier)


def test_p_space_accelerates_standin():
    """test_p_space_accelerates_hf's stand-in on ``_coupled()``: P on the 3
    and 6 lowest diagonal coordinates; JAX's iteration counts, the dense
    eigenvalues."""
    m = _coupled()
    ref = np.sort(dense_lowest(m, 2).real)
    idx = np.argsort(np.diag(m))
    iters = {}
    for n_p in (0, 3, 6):
        kw = dict(convergence_threshold=1e-8, max_iter=100, rr="device", m_max=8 + n_p)
        if n_p:
            kw["p_space"] = [{int(i): 1.0} for i in idx[:n_p]]
        jres = J.FusedNonSymDavidson.from_dense(m, 2, **kw).solve(guess(m, 2))
        tres = T.FusedNonSymDavidson.from_dense(m, 2, device="cpu", **kw).solve(guess(m, 2))
        _assert_same_solve(jres, tres)
        assert np.all(tres[2] <= 1e-8)
        np.testing.assert_allclose(np.sort(tres[0].real), ref, atol=1e-8)
        iters[n_p] = tres[3]
    assert iters[3] < iters[0] and iters[6] <= iters[3], iters


@pytest.mark.parametrize("actions", [False, True])
def test_p_space_action_rows(actions):
    """Exact user action rows (row p_i Aᵀ) and device-computed ones."""
    m = gapped_nonsym(300, strength=0.15)
    idx = np.argsort(np.diag(m))
    kw = dict(m_max=16, convergence_threshold=1e-9, max_iter=150, rr="device",
              p_space=[{int(i): 1.0} for i in idx[:4]],
              p_actions=m.T[idx[:4]] if actions else None)
    jres, tres, _, _ = _solve_both(m, 3, **kw)
    _assert_same_solve(jres, tres)
    np.testing.assert_allclose(np.sort(tres[0].real), np.sort(dense_lowest(m, 3).real),
                               atol=1e-8)


def test_guess_inside_p_span_survives():
    m = _coupled()
    idx = np.argsort(np.diag(m))
    kw = dict(convergence_threshold=1e-8, max_iter=100, rr="device", m_max=11,
              p_space=[{int(i): 1.0} for i in idx[:3]])
    jres = J.FusedNonSymDavidson.from_dense(m, 2, **kw).solve(guess(m, 2))
    tres = T.FusedNonSymDavidson.from_dense(m, 2, device="cpu", **kw).solve(guess(m, 2))
    _assert_same_solve(jres, tres)
    assert tres[3] > 1


@pytest.mark.parametrize("actions", [False, True])
def test_lineq_p_space(actions):
    m, b = lineq_problem(400, 0.15, nrhs=2, low=0.5)
    idx = np.argsort(np.diag(m))
    kw = dict(m_max=17, convergence_threshold=1e-10, max_iter=200, rr="device",
              p_space=[{int(i): 1.0} for i in idx[:5]],
              p_actions=m.T[idx[:5]] if actions else None)
    jres = J.FusedNonSymLinearEquations(jmv, np.diag(m), 400, 2, operand=jnp.asarray(m),
                                        **kw).solve(b)
    tres = T.FusedNonSymLinearEquations(tmv, np.diag(m), 400, 2, operand=torch.as_tensor(m),
                                        device="cpu", **kw).solve(b)
    _assert_same_lineq(jres, tres)
    ref = np.linalg.solve(m, b.T).T
    assert np.linalg.norm(tres[0].numpy() - ref) / np.linalg.norm(ref) < 1e-9


# ---------------------------------------------------------------------------
# linear equations


def _lineq_pair(m, nrhs, jdtype=None, tdtype=None, diag=None, **kw):
    n = m.shape[0]
    diag = np.diag(m) if diag is None else diag
    jop = jnp.asarray(m, jdtype) if jdtype else jnp.asarray(m)
    return (J.FusedNonSymLinearEquations(jmv, diag, n, nrhs, operand=jop, dtype=jdtype, **kw),
            T.FusedNonSymLinearEquations(tmv, diag, n, nrhs,
                                         operand=torch.as_tensor(m, dtype=tdtype
                                                                 or torch.float64),
                                         dtype=tdtype, device="cpu", **kw))


def _assert_same_lineq(jres, tres, tol=1e-10):
    jx, jerr, jit = jres
    tx, terr, tit = tres
    assert isinstance(tx, torch.Tensor) and isinstance(terr, np.ndarray)
    assert tit == jit, (tit, jit)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=tol)
    np.testing.assert_allclose(terr, np.asarray(jerr), rtol=1e-2, atol=1e-12)


@pytest.mark.parametrize("rr,strength,mm", [("host", 0.0, 18), ("host", 0.1, 18),
                                             ("host", 0.3, 18), ("device", 0.1, 24),
                                             ("device", 0.3, 24)])
def test_lineq_matches_jax_and_dense(rr, strength, mm):
    m, b = lineq_problem(384, strength)
    js, ts = _lineq_pair(m, 3, m_max=mm, convergence_threshold=1e-10, max_iter=200, rr=rr)
    jres, tres = js.solve(b), ts.solve(b)
    _assert_same_lineq(jres, tres)
    assert np.all(tres[1] <= 1e-10)
    ref = np.linalg.solve(m, b.T).T
    assert np.linalg.norm(tres[0].numpy() - ref) / np.linalg.norm(ref) <= 1e-9


def test_lineq_multi_chunk_and_restarts():
    m, b = lineq_problem(300, 0.2, seed=3)
    js, ts = _lineq_pair(m, 3, m_max=9, convergence_threshold=1e-9, max_iter=200,
                         rr="device", chunk_iters=2)
    _assert_same_lineq(js.solve(b), ts.solve(b))


def test_lineq_inner_enrichment():
    m, b = lineq_problem(384, 0.2, seed=4, nrhs=2)
    js, ts = _lineq_pair(m, 2, m_max=16, inner=2, convergence_threshold=1e-10, max_iter=120)
    _assert_same_lineq(js.solve(b), ts.solve(b))


def test_lineq_zero_rhs_row():
    m, b = lineq_problem(128, 0.1, seed=2, nrhs=2)
    b[1] = 0.0
    js, ts = _lineq_pair(m, 2, m_max=12, convergence_threshold=1e-10, max_iter=80)
    tres = ts.solve(b)
    _assert_same_lineq(js.solve(b), tres)
    assert np.linalg.norm(tres[0].numpy()[1]) <= 1e-8


def test_lineq_per_rhs_diagonals_default_x0():
    m, b = lineq_problem(128, 0.1, seed=7, nrhs=2)
    diag2 = np.stack([np.diag(m), np.diag(m) * 1.5])
    js, ts = _lineq_pair(m, 2, diag=diag2, m_max=12, convergence_threshold=1e-10,
                         max_iter=80)
    _assert_same_lineq(js.solve(b), ts.solve(b))


def test_lineq_f32_refinement_accuracy():
    """float32, both tiers: converged to 1e-5, within 2 iterations of JAX."""
    m, b = lineq_problem(512, 0.1, seed=5)
    for rr in ("host", "device"):
        js, ts = _lineq_pair(m, 3, jdtype=jnp.float32, tdtype=torch.float32, m_max=24,
                             convergence_threshold=1e-5, max_iter=60, rr=rr)
        jx, jerr, jit = js.solve(b)
        tx, terr, tit = ts.solve(b)
        assert terr.max() <= 1e-5 and np.asarray(jerr).max() <= 1e-5, rr
        assert abs(tit - jit) <= 2, (rr, tit, jit)


# ---------------------------------------------------------------------------
# the fuzz configurations of test_fuzz.py


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_fused_nonsym(seed):
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(48, 200))
    nroot = int(rng.integers(1, 5))
    strength = float(rng.uniform(0.0, 0.35))
    nlow = max(nroot + 2, n // 16)
    diag = np.concatenate([np.linspace(-2.0, 0.0, nlow), np.linspace(2.0, 30.0, n - nlow)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    mat = a + a.T + np.diag(diag)
    mat[np.tril_indices(n, -1)] *= 1.0 - strength
    inner = int(rng.integers(1, 3))
    kw = dict(m_max=int(rng.integers(2 * nroot + 2, 6 * nroot + 4)),
              convergence_threshold=1e-9, max_iter=120, inner=inner)
    v0 = guess(mat, nroot)
    jres = J.FusedNonSymDavidson.from_dense(mat, nroot, **kw).solve(v0)
    tres = T.FusedNonSymDavidson.from_dense(mat, nroot, device="cpu", **kw).solve(v0)
    _assert_same_solve(jres, tres)
    assert np.all(tres[2] <= 1e-8)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_fused_nonsym_lineq(seed):
    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(64, 300))
    nrhs = int(rng.integers(1, 4))
    strength = float(rng.uniform(0.0, 0.4))
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    mat = a + a.T + np.diag(np.linspace(1.0, 15.0, n))
    mat[np.tril_indices(n, -1)] *= 1.0 - strength
    b = rng.standard_normal((nrhs, n))
    js, ts = _lineq_pair(mat, nrhs, m_max=int(rng.integers(2 * nrhs + 2, 5 * nrhs + 6)),
                         convergence_threshold=1e-10, max_iter=150,
                         inner=int(rng.integers(1, 3)))
    _assert_same_lineq(js.solve(b), ts.solve(b))


# ---------------------------------------------------------------------------
# batched solves


def _batch(B, n, r, seed=0):
    """TestBatchedNonSym._batch's generator."""
    rng = np.random.default_rng(seed)
    ops, diags, v0s = [], [], []
    for b in range(B):
        a = rng.standard_normal((n, n)) * (0.04 / np.sqrt(n))
        m = a + a.T + np.diag(np.linspace(1.0 + 0.2 * b, 20.0, n))
        m[np.tril_indices(n, -1)] *= 0.9
        ops.append(m)
        diags.append(np.diag(m).copy())
        v0s.append(guess(m, r))
    return np.stack(ops), np.stack(diags), np.stack(v0s)


@pytest.mark.parametrize("B,n,r,mm,tol", [(4, 200, 3, 12, 1e-9), (3, 150, 2, 10, 1e-10)])
def test_batched_nonsym_matches_jax(B, n, r, mm, tol):
    ops, diags, v0s = _batch(B, n, r, seed=0 if r == 3 else 7)
    binit, bsolve = J.make_batched_nonsym_solve(jmv, r, mm)
    jout = bsolve(*binit(jnp.asarray(v0s), jnp.asarray(ops)), jnp.asarray(ops),
                  jnp.asarray(diags), tol, 300)
    jev, jx, jerr = J.finalize_nonsym_batch(jout[3], jout[4], jout[5])
    tinit, tsolve = T.make_batched_nonsym_solve(tmv, r, mm)
    top = torch.as_tensor(ops)
    tout = tsolve(*tinit(torch.as_tensor(v0s), top), top, torch.as_tensor(diags), tol, 300)
    tev, tx, terr = T.finalize_nonsym_batch(tout[3], tout[4], tout[5])
    np.testing.assert_array_equal(tout[6].numpy(), np.asarray(jout[6]))
    for b in range(B):
        np.testing.assert_allclose(np.sort_complex(tev[b]), np.sort_complex(jev[b]),
                                   atol=1e-10)
        assert np.max(terr[b]) <= 10 * tol
        np.testing.assert_allclose(np.sort(tev[b].real),
                                   np.sort(dense_lowest(ops[b], r).real), atol=1e-8)
        # the rotated rows are true solutions (the left-eigenvector rule)
        for i, true_r in _true_residuals(tx[b], tev[b], ops[b]).items():
            assert true_r <= 10 * max(terr[b][i], 1e-13), (b, i, true_r, terr[b][i])


def test_batched_element_matches_single_device_solve():
    ops, diags, v0s = _batch(2, 200, 3)
    tinit, tsolve = T.make_batched_nonsym_solve(tmv, 3, 12)
    top = torch.as_tensor(ops)
    tout = tsolve(*tinit(torch.as_tensor(v0s), top), top, torch.as_tensor(diags), 1e-9, 200)
    tev = T.finalize_nonsym_batch(tout[3], tout[4], tout[5])[0]
    s = T.FusedNonSymDavidson(tmv, diags[0], 200, 3, m_max=12, convergence_threshold=1e-9,
                              max_iter=200, operand=top[0], rr="device", device="cpu")
    np.testing.assert_allclose(np.sort(s.solve(v0s[0])[0].real), np.sort(tev[0].real),
                               atol=1e-10)


def test_batched_shifted_lineq_shares_one_operator():
    """operand_axes=(None, 0): (A + sigma_k I) x_k = b for 4 shifts of one
    operator, the iteration counts and solutions of JAX's."""
    n, nrhs, B = 300, 2, 4
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    A = a + a.T + np.diag(np.linspace(1.0, 20.0, n))
    A[np.tril_indices(n, -1)] *= 0.85
    sigmas = np.array([0.0, 0.4, 0.9, 1.5])
    b = rng.standard_normal((nrhs, n))
    diag_b = np.stack([np.diag(A) + s for s in sigmas])
    b_b = np.broadcast_to(b, (B, nrhs, n)).copy()
    b_norm = np.broadcast_to(np.linalg.norm(b, axis=1), (B, nrhs)).copy()
    x0_b = np.stack([b / (np.diag(A)[None, :] + s) for s in sigmas])

    def jshift(x, op):
        return jmv(x, op[0]) + op[1] * x

    def tshift(x, op):
        return tmv(x, op[0]) + op[1] * x

    binit, bsolve = J.make_batched_nonsym_lineq_solve(jshift, nrhs, 12, operand_axes=(None, 0))
    jop = (jnp.asarray(A), jnp.asarray(sigmas))
    jout = bsolve(*binit(jnp.asarray(x0_b), jop, jnp.asarray(b_b)), jop,
                  jnp.asarray(diag_b), jnp.asarray(b_b), jnp.asarray(b_norm), 1e-10, 200)
    tinit, tsolve = T.make_batched_nonsym_lineq_solve(tshift, nrhs, 12,
                                                      operand_axes=(None, 0))
    top = (torch.as_tensor(A), torch.as_tensor(sigmas))
    tout = tsolve(*tinit(torch.as_tensor(x0_b), top, torch.as_tensor(b_b)), top,
                  torch.as_tensor(diag_b), torch.as_tensor(b_b), torch.as_tensor(b_norm),
                  1e-10, 200)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=1e-10)
    for k in range(B):
        assert tout[4][k].max() <= 1e-10
        ref = np.linalg.solve(A + sigmas[k] * np.eye(n), b.T).T
        assert np.linalg.norm(tout[3][k].numpy() - ref) / np.linalg.norm(ref) < 1e-9


# ---------------------------------------------------------------------------
# checkpoints, both ways


def _ck_operator():
    rng = np.random.default_rng(0)
    n = 300
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.concatenate([np.linspace(-2, 0, 8), np.linspace(2, 20, n - 8)]))
    m[np.tril_indices(n, -1)] *= 0.85
    return m


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_eigen_checkpoint_resumes_across_packages(writer, tmp_path):
    """An interrupted device-tier solve (4 iterations) written by one
    package resumes in the other: the resumed count and eigenvalues equal
    those of the same resume in the writer's own package."""
    m = _ck_operator()
    n, r = m.shape[0], 3
    v0 = guess(m, r)
    path = str(tmp_path / "ns_ck.npz")
    first = dict(m_max=14, convergence_threshold=1e-9, max_iter=4, chunk_iters=2,
                 rr="device")
    then = dict(m_max=14, convergence_threshold=1e-9, max_iter=200, chunk_iters=64,
                rr="device")
    if writer == "jax":
        J.FusedNonSymDavidson(jmv, np.diag(m), n, r, operand=jnp.asarray(m), **first).solve(
            v0, checkpoint_path=path)
    else:
        _, _, errs, it = T.FusedNonSymDavidson(tmv, np.diag(m), n, r,
                                               operand=torch.as_tensor(m), device="cpu",
                                               **first).solve(v0, checkpoint_path=path)
        assert it == 4 and errs.max() > 1e-9
    # neither resume writes: both must start from the writer's file
    jres = J.FusedNonSymDavidson(jmv, np.diag(m), n, r, operand=jnp.asarray(m),
                                 **then).resume(path, keep_checkpointing=False)
    tres = T.FusedNonSymDavidson(tmv, np.diag(m), n, r, operand=torch.as_tensor(m),
                                 device="cpu", **then).resume(path, keep_checkpointing=False)
    _assert_same_solve(jres, tres)
    assert tres[2].max() <= 1e-9
    np.testing.assert_allclose(np.sort(tres[0].real), np.sort(dense_lowest(m, r).real),
                               atol=1e-8)
    bad = T.FusedNonSymDavidson(tmv, np.diag(m), n, r, m_max=16, operand=torch.as_tensor(m),
                                rr="device", device="cpu")
    with pytest.raises(ValueError, match="m_max"):
        bad.resume(path)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lineq_checkpoint_resumes_across_packages(writer, tmp_path):
    pytest.importorskip("h5py")
    m, b = lineq_problem(350, 0.2, nrhs=2, low=1.0)
    n = m.shape[0]
    path = str(tmp_path / "lq_ck.h5")
    first = dict(m_max=12, convergence_threshold=1e-11, max_iter=3, chunk_iters=2,
                 rr="device")
    then = dict(m_max=12, convergence_threshold=1e-11, max_iter=200, rr="device")
    if writer == "jax":
        J.FusedNonSymLinearEquations(jmv, np.diag(m), n, 2, operand=jnp.asarray(m),
                                     **first).solve(b, checkpoint_path=path)
    else:
        T.FusedNonSymLinearEquations(tmv, np.diag(m), n, 2, operand=torch.as_tensor(m),
                                     device="cpu", **first).solve(b, checkpoint_path=path)
    jres = J.FusedNonSymLinearEquations(jmv, np.diag(m), n, 2, operand=jnp.asarray(m),
                                        **then).resume(path, b, keep_checkpointing=False)
    ts = T.FusedNonSymLinearEquations(tmv, np.diag(m), n, 2, operand=torch.as_tensor(m),
                                      device="cpu", **then)
    _assert_same_lineq(jres, ts.resume(path, b, keep_checkpointing=False))
    with pytest.raises(ValueError, match="different RHS"):
        ts.resume(path, b + 1.0)


# ---------------------------------------------------------------------------
# the single-system sweep solves (the forms the JAX package vmaps)


def test_sweep_solve_matches_jax():
    m = gapped_nonsym(300, strength=0.15, seed=1)
    v0 = guess(m, 3)
    jinit, jsolve = J.make_nonsym_sweep_solve(jmv, 3, 12)
    jout = jsolve(*jinit(jnp.asarray(v0), jnp.asarray(m)), jnp.asarray(m),
                  jnp.asarray(np.diag(m)), 1e-9, 200)
    tinit, tsolve = T.make_nonsym_sweep_solve(tmv, 3, 12)
    op = torch.as_tensor(m)
    tout = tsolve(*tinit(torch.as_tensor(v0), op), op, torch.as_tensor(np.diag(m)), 1e-9, 200)
    assert tout[6] == int(jout[6])
    jev = J.finalize_nonsym_batch(jout[3][None], jout[4][None], jout[5][None])[0][0]
    tev = T.finalize_nonsym_batch(tout[3][None], tout[4][None], tout[5][None])[0][0]
    np.testing.assert_allclose(np.sort_complex(tev), np.sort_complex(jev), atol=1e-10)


def test_lineq_sweep_solve_matches_jax():
    m, b = lineq_problem(300, 0.2, seed=3, nrhs=2)
    x0 = b / np.diag(m)[None, :]
    bn = np.linalg.norm(b, axis=1)
    jinit, jsolve = J.make_nonsym_lineq_sweep_solve(jmv, 2, 10)
    jout = jsolve(*jinit(jnp.asarray(x0), jnp.asarray(m), jnp.asarray(b)), jnp.asarray(m),
                  jnp.asarray(np.diag(m)), jnp.asarray(b), jnp.asarray(bn), 1e-10, 200)
    tinit, tsolve = T.make_nonsym_lineq_sweep_solve(tmv, 2, 10)
    op, bt = torch.as_tensor(m), torch.as_tensor(b)
    tout = tsolve(*tinit(torch.as_tensor(x0), op, bt), op, torch.as_tensor(np.diag(m)), bt,
                  torch.as_tensor(bn), 1e-10, 200)
    assert tout[5] == int(jout[5])
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=1e-10)
    assert tout[4].max() <= 1e-10
