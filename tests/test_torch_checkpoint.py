"""Checkpoint/resume in the port (iterative_solver_torch/utils/checkpoint.py
and FusedDavidson.run_fast/resume_fast) against the JAX package's, on the
CPU in float64.

The fused solve is FusedDavidson "exact" on the bench spectrum cut to
n=384 (b=128 tiles), 4 roots, m_max 16, rr "window": a sweep is 3 steps.
An interrupted solve is one whose solver has max_iter 3 (one sweep, one
checkpoint); a fresh solver with the full max_iter resumes it.

- The port's resumed run equals its uninterrupted run bit for bit.
- A checkpoint written by either package resumes in the other and reaches
  the writer's uninterrupted result: eigenvalues within 1e-10, the same
  iteration count.
- npz and HDF5 files (HDF5 where h5py is installed) round-trip every
  field; the parity solvers' save_checkpoint/load_checkpoint round-trip a
  ``_sym`` problem mid-solve and resume it to the uninterrupted result.
"""

import numpy as np
import pytest
import torch

import iterative_solver_tpu as its_j
import iterative_solver_torch as its_t
from iterative_solver_tpu.solvers import fused_davidson as J
from iterative_solver_tpu.utils import checkpoint as JC
from iterative_solver_torch.solvers import fused_davidson as T
from iterative_solver_torch.utils import checkpoint as TC
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, B, NROOTS, M_MAX = 384, 128, 4, 16


def _matrix(n=N, seed=0):
    rng = np.random.default_rng(seed)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


@pytest.fixture(scope="module")
def mat():
    return _matrix()


def _guess(mat, nroots=NROOTS):
    v0 = np.zeros((nroots, mat.shape[0]))
    v0[np.arange(nroots), np.argsort(np.diag(mat))[:nroots]] = 1.0
    return v0


def _solver(mod, mat, max_iter=200, nroots=NROOTS, **kw):
    kw = {**dict(tier="exact", b=B, m_max=M_MAX, rr="window", convergence_threshold=1e-9,
                 max_iter=max_iter, fuse_chain=False), **kw}
    if mod is T:
        kw["device"] = "cpu"
    return mod.FusedDavidson.from_dense_symmetric(mat, nroots, **kw)


@pytest.fixture(scope="module")
def uninterrupted(mat):
    return {"jax": _solver(J, mat).run_fast(_guess(mat)),
            "port": _solver(T, mat).run_fast(_guess(mat))}


def _interrupt(mod, mat, path):
    """One sweep of run_fast, checkpointed to ``path``."""
    _solver(mod, mat, max_iter=3).run_fast(_guess(mat), checkpoint_path=path)


def test_resume_equals_uninterrupted_bit_for_bit(mat, uninterrupted, tmp_path):
    path = str(tmp_path / "ck.npz")
    _interrupt(T, mat, path)
    resumed = _solver(T, mat)
    te, tx, terr, tit = resumed.resume_fast(path)
    ue, ux, uerr, uit = uninterrupted["port"]
    assert tit == uit and resumed.iterations == uit
    np.testing.assert_array_equal(te, ue)
    np.testing.assert_array_equal(terr, uerr)
    assert torch.equal(tx, ux)
    # the resumed solver kept checkpointing to the same path
    state, meta = TC.load_fused_state(path, device="cpu")
    assert meta["iterations"] == uit and state.k <= M_MAX


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(mat, uninterrupted, tmp_path, writer):
    path = str(tmp_path / "ck.npz")
    _interrupt(J if writer == "jax" else T, mat, path)
    if writer == "jax":
        te, _, terr, tit = _solver(T, mat).resume_fast(path)
    else:
        te, _, terr, tit = _solver(J, mat).resume_fast(path)
    ue, _, _, uit = uninterrupted[writer]
    assert np.max(terr) <= 1e-9
    np.testing.assert_allclose(np.asarray(te), np.asarray(ue), rtol=0, atol=1e-10)
    assert int(tit) == int(uit)


@pytest.mark.parametrize("suffix", ["npz", "h5"])
def test_fused_state_round_trip(mat, tmp_path, suffix):
    if suffix == "h5":
        pytest.importorskip("h5py")
    ts = _solver(T, mat)
    state = ts.step(ts.init_state(_guess(mat)), ts.operand, ts.diag, 0)
    path = str(tmp_path / f"st.{suffix}")
    TC.save_fused_state(state, path, iterations=1, rr="window", tol=np.float64(1e-9))
    loaded, meta = TC.load_fused_state(path, device="cpu")
    assert meta == {"iterations": 1, "rr": "window", "tol": 1e-9}
    assert isinstance(loaded.k, int) and loaded.k == state.k
    for name in ("v", "w", "mask", "evals", "x", "r", "errors", "c", "cm"):
        assert torch.equal(getattr(loaded, name), getattr(state, name)), name
    # the JAX package reads the same file
    jstate, jmeta = JC.load_fused_state(path)
    assert int(jstate.k) == state.k and jmeta == meta
    np.testing.assert_array_equal(np.asarray(jstate.v), state.v.numpy())


def test_missing_optional_fields_and_bare_path(mat, tmp_path):
    ts = _solver(T, mat)
    state = ts.init_state(_guess(mat))._replace(c=None, cm=None)
    TC.save_fused_state(state, str(tmp_path / "bare.npz"))
    loaded, meta = TC.load_fused_state(str(tmp_path / "bare"), device="cpu",
                                       dtype=torch.float32)
    assert loaded.c is None and loaded.cm is None and meta == {}
    assert loaded.v.dtype == torch.float32


@pytest.mark.parametrize("field", ["nroots", "n_p", "rr"])
def test_resume_refuses_another_configuration(mat, tmp_path, field):
    path = str(tmp_path / "ck.npz")
    _interrupt(T, mat, path)
    # the same (m_max, n) stacks, written by a solver of another configuration
    if field == "nroots":
        other = _solver(T, mat, nroots=2)
    elif field == "n_p":
        other = _solver(T, mat, p_space=[{int(np.argmax(np.diag(mat))): 1.0}])
    else:
        other = T.FusedDavidson.from_dense_symmetric(
            mat, NROOTS, tier="exact", b=B, m_max=M_MAX, rr="full", device="cpu")
    with pytest.raises(ValueError, match=field):
        other.resume_fast(path)


def test_resume_of_a_converged_checkpoint_returns_it(mat, uninterrupted, tmp_path):
    path = str(tmp_path / "done.npz")
    _solver(T, mat).run_fast(_guess(mat), checkpoint_path=path)
    again = _solver(T, mat)
    te, _, _, tit = again.resume_fast(path)
    np.testing.assert_array_equal(te, uninterrupted["port"][0])
    assert tit == uninterrupted["port"][3]


def test_pspace_checkpoint_resumes(mat, tmp_path):
    p = [{int(i): 1.0} for i in np.argsort(np.diag(mat))[:4]]
    kw = dict(p_space=p, m_max=20, rr="full")
    guess = np.zeros((NROOTS, N))
    guess[np.arange(NROOTS), np.argsort(np.diag(mat))[4:8]] = 1.0
    ref = _solver(T, mat, **kw).run_fast(guess)
    path = str(tmp_path / "p.npz")
    _solver(T, mat, max_iter=3, **kw).run_fast(guess, checkpoint_path=path)
    out = _solver(J, mat, **kw).resume_fast(path)
    np.testing.assert_allclose(np.asarray(out[0]), ref[0], rtol=0, atol=1e-10)
    assert int(out[3]) == ref[3]


# -- the parity solvers --------------------------------------------------------

def _sym(n, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    return a + a.T + np.diag(np.arange(1.0, n + 1.0))


def _drive(solver, problem, params, actions, iterations, cat):
    """A fixed number of add_vector/end_iteration cycles."""
    nwork = params.shape[0]
    for _ in range(iterations):
        if nwork <= 0:
            break
        act = problem.action(params[:nwork])
        actions = cat([act, actions[nwork:]]) if nwork < actions.shape[0] else act
        nwork, params, actions = solver.add_vector(params, actions)
        while solver.end_iteration_needed:
            if nwork > 0:
                shifts = solver.working_set_eigenvalues()[:nwork]
                prec = problem.precondition(actions[:nwork], shifts, problem.diagonals())
                actions = cat([prec, actions[nwork:]]) if nwork < actions.shape[0] else prec
            nwork, params, actions = solver.end_iteration(params, actions)
    return nwork, params, actions


def _fresh(m, nroot=2):
    s = its_t.create_linear_eigensystem(m.shape[0], nroot, "Davidson", device="cpu")
    s.set_hermiticity(True)
    s.verbosity = its_t.Verbosity.NONE
    p0 = torch.zeros((nroot, m.shape[0]), dtype=torch.float64)
    p0[torch.arange(nroot), torch.as_tensor(np.argsort(np.diag(m))[:nroot])] = 1.0
    return s, p0, torch.zeros_like(p0)


@pytest.mark.parametrize("suffix", ["npz", "h5"])
def test_parity_checkpoint_resumes(tmp_path, suffix):
    if suffix == "h5":
        pytest.importorskip("h5py")
    m = _sym(80)
    problem = its_t.models.MatrixProblem(m, device="cpu")
    cat = torch.cat
    ref, p, a = _fresh(m)
    _drive(ref, problem, p, a, 30, cat)

    solver, p, a = _fresh(m)
    _drive(solver, problem, p, a, 3, cat)
    path = str(tmp_path / f"parity.{suffix}")
    TC.save_checkpoint(solver, path)
    resumed = TC.load_checkpoint(path, device="cpu")
    assert resumed.xspace.dimensions.nQ == solver.xspace.dimensions.nQ
    np.testing.assert_allclose(resumed.xspace.h, solver.xspace.h, rtol=0, atol=1e-14)
    np.testing.assert_allclose(resumed.xspace.s, solver.xspace.s, rtol=0, atol=1e-14)
    assert torch.equal(resumed.xspace.params_q(), solver.xspace.params_q())
    assert str(resumed.stats) == str(solver.stats)
    p2 = resumed.solution_params([0, 1]).clone()
    _drive(resumed, problem, p2, torch.zeros_like(p2), 30, cat)
    np.testing.assert_allclose(resumed.eigenvalues()[:2], ref.eigenvalues()[:2], atol=2e-9)


def test_parity_checkpoint_written_by_jax_loads(tmp_path):
    import jax.numpy as jnp

    m = _sym(60)
    s = its_j.create_linear_eigensystem(60, 2, "Davidson")
    s.set_hermiticity(True)
    s.verbosity = its_j.Verbosity.NONE
    p0 = np.zeros((2, 60))
    p0[np.arange(2), np.argsort(np.diag(m))[:2]] = 1.0
    _drive(s, its_j.models.MatrixProblem(m), jnp.asarray(p0), jnp.zeros((2, 60)), 3,
           lambda xs: jnp.concatenate(xs, axis=0))
    path = str(tmp_path / "jax.npz")
    JC.save_checkpoint(s, path)
    loaded = TC.load_checkpoint(path, device="cpu")
    assert type(loaded).__name__ == "LinearEigensystemDavidson"
    np.testing.assert_array_equal(loaded.xspace.h, s.xspace.h)
    np.testing.assert_array_equal(loaded.xspace.params_q().numpy(),
                                  np.asarray(s.xspace.params_q()))
    assert loaded.working_set == s.working_set and str(loaded.stats) == str(s.stats)


def test_parity_checkpoint_linear_equations(tmp_path):
    rng = np.random.default_rng(0)
    n = 12
    a = rng.standard_normal((n, n)) * 0.1
    mat = a + a.T + np.diag(np.arange(4.0, n + 4.0))
    rhs = rng.standard_normal((1, n))
    solver = its_t.create_linear_equations(n, 1, device="cpu")
    solver.verbosity = its_t.Verbosity.NONE
    solver.add_equations(rhs)
    path = str(tmp_path / "le.npz")
    TC.save_checkpoint(solver, path)
    resumed = TC.load_checkpoint(path, device="cpu")
    np.testing.assert_allclose(resumed.rhs().numpy(), rhs, rtol=0, atol=1e-14)
    conv, *_ = resumed.solve(np.zeros((1, n)), problem=its_t.models.MatrixProblem(
        mat, device="cpu"), generate_initial_guess=True)
    assert conv


def test_vecstore_hdf5_dump(tmp_path):
    pytest.importorskip("h5py")
    from iterative_solver_torch.native.vecstore import VecStore

    store = VecStore(3, 32)
    vecs = np.random.default_rng(1).standard_normal((3, 32))
    for v in vecs:
        store.append(v)
    path = str(tmp_path / "store.h5")
    TC.save_vecstore_hdf5(store, path, group="q_store")
    rows, slots = TC.load_vecstore_hdf5(path, group="q_store")
    assert slots == [0, 1, 2]
    np.testing.assert_array_equal(rows, vecs)
    jrows, jslots = JC.load_vecstore_hdf5(path, group="q_store")
    assert jslots == slots
    np.testing.assert_array_equal(jrows, rows)
    store.close()
