"""The port's host tier against the JAX package's: ``ops/dense.py``,
``options.py``, ``subspace/dimensions.py``, the logger, the statistics, the
profiler and the option store of ``config.py``.

These are numpy (or plain Python) copies, so the same inputs must give the
same outputs exactly: arrays equal bit for bit, the same exceptions.
"""

import io

import numpy as np
import pytest

from iterative_solver_torch import config as tconfig
from iterative_solver_torch import options as topt
from iterative_solver_torch.ops import dense as T
from iterative_solver_torch.subspace.dimensions import Dimensions as TDimensions
from iterative_solver_torch.utils import Level as TLevel
from iterative_solver_torch.utils import Logger as TLogger
from iterative_solver_torch.utils import Profiler as TProfiler
from iterative_solver_torch.utils import Statistics as TStatistics
from iterative_solver_tpu import config as jconfig
from iterative_solver_tpu import options as jopt
from iterative_solver_tpu.ops import dense as J
from iterative_solver_tpu.subspace.dimensions import Dimensions as JDimensions
from iterative_solver_tpu.utils import Logger as JLogger
from iterative_solver_tpu.utils import Statistics as JStatistics
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _sym(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if complex_:
        a = a + 1j * rng.standard_normal((n, n))
    return a + a.conj().T


def _spd(n, seed, rank=None):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((rank or n, n))
    return v.T @ v


CASES = {
    "hermitian": lambda: (_sym(6, 0), _spd(6, 1), True),
    "hermitian_rank_deficient": lambda: (_sym(6, 2), _spd(6, 3, rank=4), True),
    "nonhermitian": lambda: (np.random.default_rng(4).standard_normal((6, 6)), _spd(6, 5), False),
    "complex_pairs": lambda: (np.array([[0.0, 1.0, 0.2], [-1.0, 0.0, 0.1], [0.0, 0.3, 2.0]]),
                              np.eye(3), False),
    "complex_hermitian": lambda: (_sym(5, 6, True), np.eye(5), True),
    "complex_nonhermitian": lambda: (_sym(5, 7, True) + 0.3j * np.eye(5), np.eye(5), False),
    "empty": lambda: (np.zeros((0, 0)), np.zeros((0, 0)), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eigenproblem_equals_jax(case):
    h, s, hermitian = CASES[case]()
    _equal(T.eigenproblem(h, s, hermitian, 1e-14), J.eigenproblem(h, s, hermitian, 1e-14))


def test_eigenproblem_refuses_as_jax():
    h = np.array([[0.0, 1.0], [-1.0, 0.0]])
    for mod in (T, J):
        with pytest.raises(RuntimeError, match="complex"):
            mod.eigenproblem(h, np.eye(2), False, 1e-14, condone_complex=False)


@pytest.mark.parametrize("hermitian", [True, False])
@pytest.mark.parametrize("reduce", [True, False])
def test_svd_system_equals_jax(hermitian, reduce):
    m = _spd(7, 8, rank=4) if hermitian else np.random.default_rng(9).standard_normal((5, 7))
    for thresh in (1e-8, 1.0, np.inf):
        got = T.svd_system(m, thresh, hermitian=hermitian, reduce_to_rank=reduce)
        ref = J.svd_system(m, thresh, hermitian=hermitian, reduce_to_rank=reduce)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.value == r.value
            _equal(g.v, r.v)
    assert T.get_rank(T.svd_system(m, np.inf, hermitian=hermitian), 1e-3) == \
        J.get_rank(J.svd_system(m, np.inf, hermitian=hermitian), 1e-3)


@pytest.mark.parametrize("ah", [0.0, 0.5])
def test_solve_linear_equations_equals_jax(ah):
    h, s = _spd(5, 10) + 5 * np.eye(5), np.eye(5)
    rhs = np.random.default_rng(11).standard_normal((5, 2))
    _equal(T.solve_linear_equations(h, s, rhs, ah), J.solve_linear_equations(h, s, rhs, ah))


def test_complex_linear_equations_equal_jax():
    h = _sym(4, 12, True) + 6 * np.eye(4)
    rhs = np.random.default_rng(13).standard_normal((4, 1)) + 0j
    _equal(T.solve_linear_equations(h, None, rhs), J.solve_linear_equations(h, None, rhs))
    for mod in (T, J):
        with pytest.raises(NotImplementedError):
            mod.solve_linear_equations(h, None, rhs, augmented_hessian=0.1)


def test_gram_schmidt_and_diis_equal_jax():
    s = _spd(6, 14, rank=5)
    for thresh in (0.0, 1e-8):
        _equal(T.gram_schmidt_transform(s, thresh), J.gram_schmidt_transform(s, thresh))
    b = _spd(4, 15)
    _equal(T.solve_diis(b), J.solve_diis(b))
    bad = np.full((2, 2), np.nan)
    for mod in (T, J):
        with pytest.raises((OverflowError, np.linalg.LinAlgError)):
            mod.solve_diis(bad)


OPTION_CLASSES = ("Options", "LinearEigensystemDavidsonOptions",
                  "LinearEquationsDavidsonOptions", "LinearEigensystemRSPTOptions",
                  "NonLinearEquationsDIISOptions", "OptimizeBFGSOptions", "OptimizeSDOptions")


@pytest.mark.parametrize("cls", OPTION_CLASSES)
def test_options_parse_as_jax(cls):
    text = ("n_roots=3, convergence_threshold=1e-7,MAX_ITER=20,max_p=4,reset_d=2,"
            "max_size_qspace=9,hermiticity=yes,svd_thresh=1e-10,strong_wolfe=off,"
            "augmented_hessian=0.25,,")
    t, j = getattr(topt, cls).from_string(text), getattr(jopt, cls).from_string(text)
    assert vars(t) == vars(j)
    assert topt.parse_keyval_string(text) == jopt.parse_keyval_string(text)
    for mod in (topt, jopt):
        with pytest.raises(ValueError, match="malformed option"):
            getattr(mod, cls).from_string("max_iter=3,oops")


def test_dimensions_logger_statistics_equal_jax():
    td, jd = TDimensions(2, 3, 1, 4), JDimensions(2, 3, 1, 4)
    assert (td.oP, td.oQ, td.oD, td.nX) == (jd.oP, jd.oQ, jd.oD, jd.nX) == (0, 2, 5, 6)
    outs = []
    for cls in (TLogger, JLogger):
        buf = io.StringIO()
        log = cls(max_trace_level=TLevel.INFO, stream=buf)
        log.msg("shown")
        log.msg("hidden", TLevel.DEBUG)
        log.msg("warn", TLevel.WARN)
        log.msg_values("v = ", [1.5, 2, "x"])
        outs.append((buf.getvalue(), log.scientific(1234.5)))
    assert outs[0] == outs[1]
    ts, js = TStatistics(), JStatistics()
    for s in (ts, js):
        s.iterations, s.q_creations, s.dots = 3, 7, 2
    assert str(ts) == str(js) == "iterations = 3, Q vectors created = 7, dots = 2"


def test_profiler_tree():
    prof = TProfiler("test")
    for _ in range(2):
        with prof.push("outer", flops=1e9):
            with prof.push("inner"):
                pass
    report = prof.report()
    assert report.splitlines()[0].startswith("outer:") and "x2" in report
    assert "  inner:" in report
    assert "digraph profile" in prof.dotgraph(0.0)
    off = TProfiler(max_depth=0)
    with off.push("ignored"):
        pass
    assert off.report() == ""


def test_option_store_as_jax(monkeypatch):
    for key in ("BSR_BLOCK", "GEMM_BUFFERS", "PROFILER_DEPTH", "PROFILER_OUTPUT",
                "PROFILER_DOTGRAPH", "PROFILER_THRESHOLD"):
        assert tconfig.get_option(key) == jconfig.get_option(key)
    monkeypatch.setenv("ITERATIVE_SOLVER_BSR_BLOCK", "32")
    monkeypatch.setenv("ITERATIVE_SOLVER_PROFILER_THRESHOLD", "0.5")
    assert tconfig.get_option("bsr_block") == jconfig.get_option("bsr_block") == 32
    assert tconfig.get_option("profiler_threshold") == 0.5
    tconfig.set_option("bsr_block", 16)
    try:
        assert tconfig.get_option("BSR_BLOCK") == 16
    finally:
        tconfig.clear_options()
    assert tconfig.get_option("BSR_BLOCK") == 32
    assert tconfig.get_option("NO_SUCH_KNOB", "fallback") == "fallback"
