"""P-space in the port's FusedDavidson against the JAX package's, on the CPU
with the same matrix, P space and guesses.

The matrix is the bench spectrum cut to n=384 (gapped low block, dense weak
couplings), packed in b=128 tiles; 4 roots, m_max 28. P is the unit
vectors of the 8 lowest diagonal entries; the guess is one-hot on the next
4. Both packages run f64 arithmetic on the CPU ("exact" tier), so they take
the same steps: eigenvalues within 1e-10 and equal iteration counts.

Also here: the float32 parity test of ROADMAP Queue 3 (FusedDavidson
"exact" and "precise" in float32 at tol 1e-4 on the bench spectrum, n =
1024, 8 roots: eigenvalues within 1e-5 of JAX, iteration counts within 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solver_tpu.solvers import fused_davidson as J
from iterative_solver_torch.solvers import fused_davidson as T
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, B, NROOTS, M_MAX, NP = 384, 128, 4, 28, 8


def _matrix(n=N, seed=0):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


@pytest.fixture(scope="module")
def mat():
    return _matrix()


def _order(mat):
    return np.argsort(np.diag(mat))


def _p_space(mat, form):
    idx = _order(mat)[:NP]
    if form == "dict":
        return [{int(i): 1.0} for i in idx]
    if form == "pairs":
        return [(np.array([i]), np.array([1.0])) for i in idx]
    dense = np.zeros((NP, N))
    dense[np.arange(NP), idx] = 1.0
    return dense


def _guess(mat, rows):
    v0 = np.zeros((len(rows), mat.shape[0]))
    v0[np.arange(len(rows)), rows] = 1.0
    return v0


def _pair(mat, **kw):
    kw = dict(tier="exact", b=B, m_max=M_MAX, convergence_threshold=1e-9, max_iter=200,
              fuse_chain=False, **kw)
    return (J.FusedDavidson.from_dense_symmetric(mat, NROOTS, **kw),
            T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", **kw))


def _compare(jres, tres):
    je, _, jerr, jit = jres
    te, _, terr, tit = tres
    assert np.max(terr) <= 1e-9 and np.max(jerr) <= 1e-9
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-10)
    assert tit == int(jit)


# -- densify_p_space / validate_p_inputs --------------------------------------

def test_densify_forms_agree_with_jax(mat):
    dense = [T.densify_p_space(_p_space(mat, f), N) for f in ("dict", "pairs", "dense")]
    for d in dense[1:]:
        np.testing.assert_array_equal(d, dense[0])
    np.testing.assert_array_equal(dense[0], J.densify_p_space(_p_space(mat, "dict"), N))


def test_dense_p_space_right_padded():
    rows = T.densify_p_space(np.ones((2, 5)), 8)
    assert rows.shape == (2, 8)
    np.testing.assert_array_equal(rows[:, 5:], 0.0)


@pytest.mark.parametrize("bad", ["zero_dict", "zero_dense", "too_wide"])
def test_densify_rejects_as_jax(bad):
    arg = {"zero_dict": [{0: 1.0}, {}], "zero_dense": np.zeros((1, 4)),
           "too_wide": np.ones((1, 9))}[bad]
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.densify_p_space(arg, 8)


@pytest.mark.parametrize("case", ["actions_without_p", "wrong_rows", "one_dimensional",
                                  "too_wide"])
def test_validate_p_inputs_errors(case):
    p = [{0: 1.0}, {1: 1.0}]
    args = {"actions_without_p": (None, np.ones((2, 8))),
            "wrong_rows": (p, np.ones((3, 8))),
            "one_dimensional": ([{0: 1.0}], np.ones((3,))[None, None]),
            "too_wide": (p, np.ones((2, 9)))}[case]
    messages = []
    for mod in (J, T):
        with pytest.raises(ValueError) as err:
            mod.validate_p_inputs(*args, 8)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_validate_p_inputs_pads_actions():
    p_dense, n_p, rows = T.validate_p_inputs([{0: 1.0}], np.ones((1, 5)), 8)
    assert n_p == 1 and p_dense.shape == (1, 8) and rows.shape == (1, 8)
    np.testing.assert_array_equal(rows[0, 5:], 0.0)


# -- solves against JAX -------------------------------------------------------

@pytest.mark.parametrize("with_actions", [False, True])
@pytest.mark.parametrize("rr", ["full", "window", "window3", "anchored"])
def test_pspace_solve_matches_jax(mat, rr, with_actions):
    kw = {"p_space": _p_space(mat, "dict")}
    if with_actions:
        kw["p_actions"] = mat[_order(mat)[:NP]]
    js, ts = _pair(mat, rr=rr, **kw)
    assert ts.n_p == NP and ts.m_max == M_MAX
    v0 = _guess(mat, _order(mat)[NP:NP + NROOTS])
    tres = ts.run_on_device(v0)
    _compare(js.run_on_device(v0), tres)
    # P holds the 8 lowest diagonal couplings exactly: the solve finds the
    # lowest eigenvalues of the whole matrix
    np.testing.assert_allclose(np.sort(tres[0]), np.linalg.eigvalsh(mat)[:NROOTS], atol=1e-9)


@pytest.mark.parametrize("form", ["dict", "pairs", "dense"])
def test_pspace_forms_match_jax(mat, form):
    js, ts = _pair(mat, rr="window", p_space=_p_space(mat, form))
    v0 = _guess(mat, _order(mat)[NP:NP + NROOTS])
    _compare(js.run_on_device(v0), ts.run_on_device(v0))


@pytest.mark.parametrize("driver", ["run", "chunked", "run_fast"])
def test_pspace_drivers_match_jax(mat, driver):
    js, ts = _pair(mat, rr="full", p_space=_p_space(mat, "dict"),
                   p_actions=mat[_order(mat)[:NP]])
    v0 = _guess(mat, _order(mat)[NP:NP + NROOTS])
    if driver == "run":
        jres, tres = js.run(v0), ts.run(v0)
    elif driver == "run_fast":
        jres, tres = js.run_fast(v0), ts.run_fast(v0)
    else:
        jres, tres = js.run_on_device(v0, chunked=True), ts.run_on_device(v0, chunked=True)
    _compare(jres, tres)
    assert ts.matvecs == js.matvecs


def test_guess_inside_p_span_seeds_dead_slots(mat):
    """Two guesses lie in the P span: their slots start dead with errors at
    inf (not 0, which would read as converged), and the solve still finds
    the lowest roots, as in JAX."""
    rows = np.concatenate([_order(mat)[:2], _order(mat)[NP:NP + NROOTS - 2]])
    js, ts = _pair(mat, rr="window", p_space=_p_space(mat, "dict"))
    v0 = _guess(mat, rows)
    state = ts.init_state(v0)
    jstate = js.init_state(v0)
    assert state.k == NP + NROOTS
    np.testing.assert_array_equal(state.mask.numpy(), np.asarray(jstate.mask))
    assert np.sum(np.isinf(state.errors.numpy())) == 2
    np.testing.assert_array_equal(np.isinf(state.errors.numpy()),
                                  np.isinf(np.asarray(jstate.errors)))
    _compare(js.run_on_device(v0), ts.run_on_device(v0))


def test_restarts_keep_the_p_slots(mat):
    """Across restarts the frozen P rows of the basis and action stacks are
    never written (the step appends at k >= n_p + nroots)."""
    _, ts = _pair(mat, rr="full", p_space=_p_space(mat, "dict"))
    v0 = _guess(mat, _order(mat)[NP:NP + NROOTS])
    state = ts.init_state(v0)
    p0, w0 = state.v[:NP].clone(), state.w[:NP].clone()
    for it in range(9):  # (28 - 8 - 4) / 4 = 4 steps per fill: two restarts
        if state.k + NROOTS > M_MAX:
            state = ts.restart(state, ts.operand)
            assert state.k == NP + NROOTS
        state = ts.step(state, ts.operand, ts.diag, it)
        assert torch.equal(state.v[:NP], p0) and torch.equal(state.w[:NP], w0)
        assert torch.all(state.mask[:NP] == 1.0)


def test_init_and_restart_states_match_jax(mat):
    js, ts = _pair(mat, rr="window3", p_space=_p_space(mat, "dense"),
                   p_actions=mat[_order(mat)[:NP]])
    v0 = _guess(mat, _order(mat)[NP:NP + NROOTS])
    jstate, tstate = js.init_state(v0), ts.init_state(v0)
    for it in range(4):
        jstate = js.step(jstate, js.operand, js.diag, it)
        tstate = ts.step(tstate, ts.operand, ts.diag, it)
    jstate, tstate = js.restart(jstate, js.operand), ts.restart(tstate, ts.operand)
    assert tstate.k == int(jstate.k)
    # eigenvector signs are the LAPACK build's choice: the restarted rows
    # come out of an eigh-whitening (a sign per basis row, which its action
    # row and its row of c share) and the Ritz vectors out of the steps'
    # eighs (a sign per column of c)
    def signs(a, b):
        s = np.sign(np.sum(a * b, axis=1))
        s[np.sum(a * a, axis=1) == 0] = 1.0
        assert np.all(s != 0)
        return s

    row = signs(np.asarray(jstate.v), tstate.v.numpy())
    col = signs(np.asarray(jstate.x), tstate.x.numpy())
    assert np.all(row[:NP] == 1.0)
    for name in ("v", "w"):
        np.testing.assert_allclose(getattr(tstate, name).numpy() * row[:, None],
                                   np.asarray(getattr(jstate, name)), rtol=0, atol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(tstate.c.numpy() * row[:, None] * col[None, :],
                               np.asarray(jstate.c), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tstate.cm.numpy(), np.asarray(jstate.cm))
    np.testing.assert_array_equal(tstate.mask.numpy(), np.asarray(jstate.mask))


def test_pspace_m_max_rule(mat):
    with pytest.raises(ValueError, match="m_max"):
        T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu", m_max=15,
                                             p_space=_p_space(mat, "dict"))
    ts = T.FusedDavidson.from_dense_symmetric(mat, NROOTS, device="cpu",
                                              p_space=_p_space(mat, "dict"))
    assert ts.m_max == max(4 * NROOTS + NP, 24)


# -- float32 parity (ROADMAP Queue 3) ------------------------------------------

@pytest.mark.parametrize("rr", ["full", "window"])
@pytest.mark.parametrize("tier", ["exact", "precise"])
def test_float32_matches_jax(tier, rr):
    """Both packages in float32 on the CPU at tol 1e-4 (above the f32 floor
    of the bench spectrum, ||A|| about 50): eigenvalues within 1e-5 of JAX,
    iteration counts within 2."""
    n, nroots = 1024, 8
    m = _matrix(n)
    kw = dict(tier=tier, b=512, m_max=32, rr=rr, convergence_threshold=1e-4,
              max_iter=100, fuse_chain=False)
    js = J.FusedDavidson.from_dense_symmetric(m, nroots, dtype=jnp.float32, **kw)
    ts = T.FusedDavidson.from_dense_symmetric(m, nroots, device="cpu", dtype=torch.float32,
                                              **kw)
    v0 = _guess(m, np.argsort(np.diag(m))[:nroots])
    je, _, jerr, jit = js.run_on_device(v0)
    te, tx, terr, tit = ts.run_on_device(v0)
    assert tx.dtype == torch.float32
    assert np.max(terr) <= 1e-4 and np.max(jerr) <= 1e-4
    np.testing.assert_allclose(te, np.asarray(je), rtol=0, atol=1e-5)
    assert abs(tit - int(jit)) <= 2
