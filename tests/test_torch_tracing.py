"""The spans and the counter of the port's Davidson solve
(iterative_solver_torch/utils/profiler.py, solvers/fused_davidson.py,
array/vector_ops.py).

They record only while a ``torch.profiler`` session records: with none, a
solve leaves the registry empty and each span site costs one flag read.
Under a profiler a solve records each span the number of times its
structure gives, nests them inside ``davidson.solve`` in the chrome trace,
and returns the same bits as without one.

The tests marked ``cuda`` skip without a card; the file imports no JAX,
so on the card they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import contextlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solver_torch.solvers import fused_davidson as fd
from iterative_solver_torch.utils import Profiler
from iterative_solver_torch.utils import profiler as P
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

N, B, NROOTS, M_MAX = 256, 128, 4, 16
SPANS = ("davidson.solve", "davidson.upload", "davidson.iteration", "davidson.rr",
         "davidson.ritz", "davidson.expand", "davidson.action", "davidson.wait")
SYNCS = ("cudaEventSynchronize", "cudaStreamSynchronize", "cudaDeviceSynchronize")


def _problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.linspace(-2.0, 3.0, 16), np.linspace(6.0, 50.0, n - 16)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(d), d


def _guess(d, nroots=NROOTS):
    """A float64 numpy one-hot guess on the lowest diagonal entries, as a
    user passes it."""
    v0 = np.zeros((nroots, d.shape[0]))
    v0[np.arange(nroots), np.argsort(d)[:nroots]] = 1.0
    return v0


def _solver(device="cpu", tol=1e-9):
    a, d = _problem()
    return fd.FusedDavidson.from_dense_symmetric(a, NROOTS, tier="exact", b=B, m_max=M_MAX,
                                                 convergence_threshold=tol, device=device), d


def _restarts(iters, nroots=NROOTS, m_max=M_MAX):
    """The restarts of ``make_davidson_solve``'s loop over ``iters`` steps
    from the init's ``k = nroots``."""
    k, out = nroots, 0
    for _ in range(iters):
        if k + nroots > m_max:
            out, k = out + 1, nroots
        k += nroots
    return out


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset()
    yield
    P.reset()


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


def test_gate_off_span_and_count_are_one_shared_no_op(monkeypatch):
    calls = []
    monkeypatch.setattr(P, "_recording", lambda: calls.append(1) or False)
    first, second = P.span("davidson.a"), P.span("davidson.b")
    assert first is second
    with first:
        pass
    P.count("h2d_bytes", 8)
    assert len(calls) == 3
    assert P.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("tol", [1e-9, 1e-4])
def test_profiled_solve_records_each_span_as_the_loop_runs(tol):
    solver, d = _solver(tol=tol)
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, _, iters = solver.run_on_device(_guess(d))
    spans = P.snapshot()["spans"]
    counts = {name: s["count"] for name, s in spans.items()}
    assert counts == {
        "davidson.solve": 1, "davidson.upload": 1,
        "davidson.iteration": iters, "davidson.rr": iters, "davidson.ritz": iters,
        "davidson.expand": iters,
        "davidson.action": 1 + iters + _restarts(iters),
        "davidson.wait": iters + 2,
    }
    # on the CPU the host does the work: the device extent is the host time
    for s in spans.values():
        assert s["device_s"] == s["host_s"] > 0
    inner = sum(spans[f"davidson.{p}"]["host_s"] for p in ("rr", "ritz", "expand"))
    assert inner <= spans["davidson.iteration"]["host_s"] <= spans["davidson.solve"]["host_s"]


def test_spans_nest_inside_the_solve_in_the_chrome_trace(tmp_path):
    solver, d = _solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.run_on_device(_guess(d))
    events = [ev for ev in _trace(prof, tmp_path)
              if str(ev.get("name", "")).startswith("davidson.") and ev.get("ph") == "X"]
    assert {ev["name"] for ev in events} == set(SPANS)
    assert all(ev["cat"] == "user_annotation" for ev in events)
    (solve,) = [ev for ev in events if ev["name"] == "davidson.solve"]
    s0, s1 = float(solve["ts"]), float(solve["ts"]) + float(solve["dur"])
    for ev in events:
        assert s0 <= float(ev["ts"]) and float(ev["ts"]) + float(ev["dur"]) <= s1, ev["name"]


@pytest.mark.parametrize("loop", ["run_on_device", "chunked"])
def test_profiled_solve_gives_the_same_bits(loop):
    solver, d = _solver()
    kw = {"chunked": True} if loop == "chunked" else {}
    plain = solver.run_on_device(_guess(d), **kw)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = solver.run_on_device(_guess(d), **kw)
    assert np.array_equal(plain[0], traced[0]) and np.array_equal(plain[2], traced[2])
    assert torch.equal(plain[1], traced[1]) and plain[3] == traced[3]
    assert P.snapshot()["spans"]["davidson.solve"]["count"] == 1


def test_batched_solve_records_its_spans_once_a_batched_step():
    a, d = _problem()
    ops = torch.as_tensor(np.stack([a, a + 0.01 * np.eye(N)]))
    diags = torch.as_tensor(np.stack([d, d + 0.01]))
    v0 = torch.as_tensor(np.stack([_guess(d)] * 2))
    init, solve = fd.make_batched_davidson_solve(lambda x, op: x @ op.T, NROOTS, M_MAX)
    plain, plain_its = solve(init(v0, ops), ops, diags, 1e-8, 60)
    with profile(activities=[ProfilerActivity.CPU]):
        final, its = solve(init(v0, ops), ops, diags, 1e-8, 60)
    assert torch.equal(its, plain_its) and torch.equal(final.evals, plain.evals)
    counts = {name: s["count"] for name, s in P.snapshot()["spans"].items()}
    steps = int(its.max())
    assert counts["davidson.rr"] == counts["davidson.ritz"] == counts["davidson.expand"] == steps
    assert counts["davidson.action"] >= 1 + steps


def test_profiler_push_regions_report_and_show_in_a_trace(tmp_path, monkeypatch):
    prof = Profiler("test")
    with profile(activities=[ProfilerActivity.CPU]) as trace:
        with prof.push("outer"):
            with prof.push("inner"):
                torch.ones(4).sum()
    names = {ev.get("name") for ev in _trace(trace, tmp_path) if ev.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names
    # unprofiled: the tree still counts, and no range opens
    monkeypatch.setattr(P, "record_function", None)
    with prof.push("outer"):
        pass
    report = prof.report()
    assert report.splitlines()[0].startswith("outer:") and "x2" in report and "  inner:" in report


def test_counter_records_under_the_profiler_only():
    P.count("h2d_bytes", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        P.count("h2d_bytes", 7)
        P.count("h2d_bytes", 1)
        # a host destination lands nothing on a card
        from iterative_solver_torch.array.vector_ops import to_device
        to_device(np.ones((4, 8)), torch.float32, "cpu")
    assert P.snapshot()["counters"] == {"h2d_bytes": 8}
    P.reset()
    assert P.snapshot() == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device extents and host-to-device bytes")
    return torch.device("cuda")


def _cuda_solver(cuda):
    a, d = _problem()
    op = torch.as_tensor(a, dtype=torch.float32, device=cuda)
    solver = fd.FusedDavidson(lambda x, m: x @ m, d, N, NROOTS, m_max=M_MAX,
                              convergence_threshold=1e-4, operand=op, device=cuda)
    solver.run_on_device(_guess(d))   # the symmetry probe and the libraries' handles
    torch.cuda.synchronize()
    return solver, d


@pytest.mark.cuda
def test_h2d_bytes_counts_the_float32_guess(cuda):
    solver, d = _cuda_solver(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        solver.run_on_device(_guess(d))
    assert P.snapshot()["counters"]["h2d_bytes"] == NROOTS * N * 4


@pytest.mark.cuda
def test_device_extents_lie_within_the_iterations(cuda):
    solver, d = _cuda_solver(cuda)
    solve = fd.make_davidson_solve(solver.matvec, NROOTS, M_MAX, rr=solver.rr,
                                   fuse_chain=solver.fuse_chain)
    state = solver.init_state(_guess(d))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, iters = solve(state, solver.operand, solver.diag, solver.tol, solver.max_iter)
    spans = P.snapshot()["spans"]
    assert iters > 1 and spans["davidson.iteration"]["count"] == iters
    # the loop alone: every action is inside an iteration (the init's is not run)
    parts = [spans[f"davidson.{p}"]["device_s"] for p in ("rr", "ritz", "expand", "action")]
    assert all(p > 0 for p in parts)
    # event timestamps resolve to about half a microsecond
    assert sum(parts) <= spans["davidson.iteration"]["device_s"] + 1e-6 * iters


@pytest.mark.cuda
def test_spans_add_no_synchronisation(cuda, tmp_path, monkeypatch):
    solver, d = _cuda_solver(cuda)

    def syncs():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solver.run_on_device(_guess(d))
        torch.cuda.synchronize()
        return sum(1 for ev in _trace(prof, tmp_path) if ev.get("name") in SYNCS)

    syncs()   # the first profiled session's own set-up
    P.reset()
    with_spans = syncs()
    assert P.snapshot()["spans"]["davidson.solve"]["count"] == 1
    monkeypatch.setattr(fd, "span", lambda name: contextlib.nullcontext())
    assert with_spans <= syncs()
