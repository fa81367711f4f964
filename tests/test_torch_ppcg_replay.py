"""The replay of PPCG's per-root Rayleigh-Ritz from a CUDA graph, and the
guess narrowed on the device (solvers/fused_ppcg.py).

Off CUDA the step calls ``_rr3_coeffs`` as it is, once an iteration. On
the card (tests marked ``cuda``, which skip without one) the replayed
coefficients, a whole solve and the uploaded guess must have the bits of
the eager versions and of the host's conversion: the graph holds the same
kernels, and float64 to float32 rounds to nearest on either side. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ppcg_replay.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solver_torch.solvers import fused_ppcg as fp

N, NROOTS, RR_EVERY = 2048, 8, 2


def _problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(d), d


def _guess(d, nroots=NROOTS):
    v0 = np.zeros((nroots, d.shape[0]))
    v0[np.arange(nroots), np.argsort(d)[:nroots]] = 1.0
    return v0


def _rr3_args(nroots, seed, device, dead=None):
    """The (9, r) row dots and live masks of a per-root Rayleigh-Ritz over
    random unit rows of a dense operator, float32 on ``device``; ``dead``
    zeroes one row of w or every other row of p."""
    a, _ = _problem(256, seed)
    rng = np.random.default_rng(seed)
    x, w, p = (b / np.linalg.norm(b, axis=1, keepdims=True)
               for b in (rng.standard_normal((nroots, 256)) for _ in range(3)))
    live_w = np.ones(nroots, bool)
    live_p = np.ones(nroots, bool)
    if dead == "w":
        live_w[1], w[1] = False, 0.0
    elif dead == "p":
        live_p[::2], p[::2] = False, 0.0
    t = [torch.as_tensor(v, dtype=torch.float32, device=device)
         for v in (x, x @ a, w, w @ a, p, p @ a)]
    return (fp._rr3_dots(*t), torch.as_tensor(live_w, device=device),
            torch.as_tensor(live_p, device=device))


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and np.array_equal(a[2], b[2]) and a[3] == b[3])


# ---------------------------------------------------------------------------
# off CUDA


def test_replay_runs_fn_as_it_is_off_cuda():
    calls = []
    out = torch.ones(3)

    def fn(*args):
        calls.append(args)
        return out

    replay = fp._Replay(fn)
    arg = torch.zeros(3)
    assert replay(arg, arg) is out
    assert len(calls) == 1 and calls[0][0] is arg
    assert replay.graphs == {}


def test_step_takes_the_coefficients_through_replay(monkeypatch):
    seen = []
    call = fp._Replay.__call__

    def spy(self, *args):
        seen.append(self.fn.keywords["nroots"])
        return call(self, *args)

    monkeypatch.setattr(fp._Replay, "__call__", spy)
    a, d = _problem()
    solver = fp.FusedPPCG(lambda x, m: x @ m, d, N, NROOTS, rr_every=RR_EVERY,
                          convergence_threshold=1e-9, max_iter=200,
                          operand=torch.as_tensor(a), device="cpu")
    *_, iters = solver.run_on_device(_guess(d))
    assert iters > RR_EVERY and seen == [NROOTS] * iters


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and device conversion")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nroots", [8, 64])
def test_replayed_coefficients_equal_eager(cuda, nroots):
    replay = fp._Replay(lambda *args: fp._rr3_coeffs(*args, nroots=nroots))
    for seed, dead in ((0, None), (1, "w"), (2, "p"), (3, None)):
        args = _rr3_args(nroots, seed, cuda, dead)
        eager = fp._rr3_coeffs(*args, nroots=nroots)
        assert torch.equal(replay(*args), eager)
    assert len(replay.graphs) == 1


@pytest.mark.cuda
def test_graphed_solve_has_the_eager_bits(cuda, monkeypatch, tmp_path):
    a, d = _problem()
    op = torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def solver():
        return fp.FusedPPCG(lambda x, m: x @ m, d, N, NROOTS, rr_every=RR_EVERY,
                            convergence_threshold=1e-4, max_iter=200, operand=op,
                            device=cuda)

    graphed = solver()
    first = graphed.run_on_device(_guess(d))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = graphed.run_on_device(_guess(d))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert again[3] > RR_EVERY
    assert sum(1 for ev in events if ev.get("name") == "cudaGraphLaunch") == again[3]
    monkeypatch.setattr(fp._Replay, "__call__", lambda self, *args: self.fn(*args))
    eager = solver().run_on_device(_guess(d))
    assert _same(first, eager) and _same(again, eager)


@pytest.mark.cuda
def test_guess_narrows_on_the_card_to_the_host_bits(cuda):
    _, d = _problem()
    rng = np.random.default_rng(4)
    v0 = rng.standard_normal((NROOTS, N)) * np.logspace(-44, 30, N)
    v0[:, :16] = 1.0 + np.arange(16) * 2.0 ** -25       # halfway cases
    solver = fp.FusedPPCG(lambda x, m: x, d, N, NROOTS, device=cuda, check_symmetric=False)
    seen = []
    solver._init = lambda v, operand: seen.append(v)
    solver.init_state(v0)
    assert seen[0].dtype == torch.float32 and seen[0].is_cuda
    host = torch.as_tensor(v0, dtype=torch.float32)
    assert torch.equal(seen[0].cpu(), host)
