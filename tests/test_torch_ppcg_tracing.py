"""The spans of the port's PPCG solve (solvers/fused_ppcg.py) and K4's walk
counters (ops/kernels/symm_int8.py), as utils/profiler.py records them.

They record only while a ``torch.profiler`` session records: with none, a
solve leaves the registry empty and each span site costs one flag read.
Under a profiler a warm solve records each span the number of times its
loop gives (the first solve's symmetry probe calls the action outside the
spans), nests them inside ``ppcg.solve`` in the chrome trace, and returns
the same bits as without one.
"""

import contextlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solver_torch.ops.kernels import symm_int8 as T
from iterative_solver_torch.solvers import fused_ppcg as fp
from iterative_solver_torch.utils import profiler as P
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, NROOTS, RR_EVERY = 2048, 8, 2
SPANS = ("ppcg.solve", "ppcg.upload", "ppcg.iteration", "ppcg.action", "ppcg.rr3",
         "ppcg.full_rr", "ppcg.wait")


def _problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(d), d


def _guess(d, nroots=NROOTS):
    """A float64 numpy one-hot guess on the lowest diagonal entries, as a
    user passes it."""
    v0 = np.zeros((nroots, d.shape[0]))
    v0[np.arange(nroots), np.argsort(d)[:nroots]] = 1.0
    return v0


def _solver(tol=1e-9, matvec=None):
    """A warm PPCG solver over a dense float64 operator on the CPU: its
    first solve has run the symmetry probe."""
    a, d = _problem()
    solver = fp.FusedPPCG(matvec or (lambda x, m: x @ m), d, N, NROOTS, rr_every=RR_EVERY,
                          convergence_threshold=tol, max_iter=200,
                          operand=torch.as_tensor(a), device="cpu")
    solver.run_on_device(_guess(d))
    return solver, d


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and np.array_equal(a[2], b[2]) and a[3] == b[3])


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset()
    yield
    P.reset()


# loops of odd and even length: the full RR's cadence at more than one count
@pytest.mark.parametrize("tol, iters", [(1e-8, 7), (1e-3, 3), (1e-2, 2)])
def test_profiled_solve_records_each_span_as_the_loop_runs(tol, iters):
    solver, d = _solver(tol=tol)
    with profile(activities=[ProfilerActivity.CPU]):
        assert solver.run_on_device(_guess(d))[3] == iters
    spans = P.snapshot()["spans"]
    counts = {name: s["count"] for name, s in spans.items()}
    assert counts == {
        "ppcg.solve": 1, "ppcg.upload": 1, "ppcg.iteration": iters,
        "ppcg.action": 1 + iters + iters // RR_EVERY,
        "ppcg.rr3": iters, "ppcg.full_rr": iters // RR_EVERY,
        # iters + 1 convergence tests, and one span around the final reads
        "ppcg.wait": iters + 2,
    }
    # on the CPU the host does the work: the device extent is the host time
    for s in spans.values():
        assert s["device_s"] == s["host_s"] > 0
    inner = spans["ppcg.rr3"]["host_s"] + spans["ppcg.full_rr"]["host_s"]
    assert inner <= spans["ppcg.iteration"]["host_s"] <= spans["ppcg.solve"]["host_s"]


def test_unprofiled_solve_records_nothing_and_opens_no_range(monkeypatch):
    solver, d = _solver()
    calls = []

    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler recording")

    monkeypatch.setattr(P, "record_function", refuse)
    gate = P._recording
    monkeypatch.setattr(P, "_recording", lambda: calls.append(1) or gate())
    monkeypatch.setattr(P, "time", SimpleNamespace())   # no clock reading
    monkeypatch.setattr(P, "_Span", refuse)              # no span object
    monkeypatch.setattr(torch.cuda, "Event", refuse)     # no CUDA event
    evals, _, _, iters = solver.run_on_device(_guess(d))
    assert iters > 1 and np.all(np.isfinite(evals))
    assert P.snapshot() == {"spans": {}, "counters": {}}
    monkeypatch.undo()

    # one flag read a span site: as many reads as a profiled solve records spans
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        solver.run_on_device(_guess(d))
    recorded = sum(s["count"] for s in P.snapshot()["spans"].values())
    assert len(calls) == recorded


def test_spans_nest_inside_the_solve_in_the_chrome_trace(tmp_path):
    solver, d = _solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.run_on_device(_guess(d))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if str(ev.get("name", "")).startswith("ppcg.") and ev.get("ph") == "X"]
    assert {ev["name"] for ev in events} == set(SPANS)
    assert all(ev["cat"] == "user_annotation" for ev in events)
    (solve,) = [ev for ev in events if ev["name"] == "ppcg.solve"]
    s0, s1 = float(solve["ts"]), float(solve["ts"]) + float(solve["dur"])
    for ev in events:
        assert s0 <= float(ev["ts"]) and float(ev["ts"]) + float(ev["dur"]) <= s1, ev["name"]
    # the full RR's re-anchoring action lies inside it
    full = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e["name"] == "ppcg.full_rr"]
    acts = [float(e["ts"]) for e in events if e["name"] == "ppcg.action"]
    assert full and all(any(f0 <= t <= f1 for t in acts) for f0, f1 in full)


def test_profiled_solve_gives_the_same_bits():
    solver, d = _solver()
    plain = solver.run_on_device(_guess(d))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = solver.run_on_device(_guess(d))
    assert _same(plain, traced)
    assert P.snapshot()["spans"]["ppcg.solve"]["count"] == 1


def test_spans_off_give_the_bits_of_a_solve_without_spans(monkeypatch):
    """With no profiler recording, a solve returns the bits, vectors and
    iteration count of the same solve with every span site taken out."""
    solver, d = _solver()
    with_sites = solver.run_on_device(_guess(d))
    monkeypatch.setattr(fp, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(fp, "settle", lambda: None)
    bare, _ = _solver()
    assert _same(with_sites, bare.run_on_device(_guess(d)))


def test_square_calls_equal_the_action_spans_of_a_solve():
    """An action that records the walk K4 takes at 64 rows on the card,
    the strip walk (the square walk before it, whence the name), once a
    call through ``_record_walk``, as the wrapper does (on the CPU it takes
    the plain version and records no walk), adds one to
    ``K4_WALKS["strip"]`` for each ``ppcg.action`` of a traced solve; the
    profiler counts no walk (the trace names the walk's kernel)."""

    def matvec(x, m):
        T._record_walk("strip")
        return x @ m

    solver, d = _solver(matvec=matvec)
    before = T.K4_WALKS["strip"]
    with profile(activities=[ProfilerActivity.CPU]):
        solver.run_on_device(_guess(d))
    reg = P.snapshot()
    assert T.K4_WALKS["strip"] - before == reg["spans"]["ppcg.action"]["count"] > 0
    assert not [name for name in reg["counters"] if name.startswith("int8_")]
