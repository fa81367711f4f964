"""PPCG's per-root 3x3 Rayleigh-Ritz as K8's two kernels
(ops/kernels/rr3.py), and the guess narrowed on the device
(solvers/fused_ppcg.py).

Off CUDA the step runs the eager chain, ``_rr3_coeffs`` once an iteration,
and ``rr3_dots_emulated`` stands in for the dots kernel's order of sums. On
the card (tests marked ``cuda``, which skip without one) the kernels'
coefficients and blocks must carry the eager chain's bits given the same
dots, the dots must repeat and equal their emulation, and whole solves,
one-card and sharded, must take K8 and agree with the eager path. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ppcg_rr3.py
"""

import numpy as np
import pytest
import torch

import torch_shard_worker as W
from iterative_solver_torch.ops.kernels import rr3
from iterative_solver_torch.solvers import fused_ppcg as fp
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

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


def _blocks(nroots, n, seed, device="cpu", dead=None):
    """Six float32 (nroots, n) blocks x, ax, w, aw, p, ap: unit rows, the
    actions a diagonal plus a rank-2 coupling; ``dead`` zeroes one row of w
    or every other row of p. Returns the blocks and the live masks."""
    rng = np.random.default_rng(seed)
    d = np.linspace(-2.0, 50.0, n)
    u = rng.standard_normal((2, n)) / np.sqrt(n)
    x, w, p = (b / np.linalg.norm(b, axis=1, keepdims=True)
               for b in (rng.standard_normal((nroots, n)) for _ in range(3)))
    live_w = np.ones(nroots, bool)
    live_p = np.ones(nroots, bool)
    if dead == "w":
        live_w[1], w[1] = False, 0.0
    elif dead == "p":
        live_p[::2], p[::2] = False, 0.0

    def act(v):
        return v * d + (v @ u.T) @ u

    blocks = [torch.as_tensor(v, dtype=torch.float32, device=device)
              for v in (x, act(x), w, act(w), p, act(p))]
    return blocks, torch.as_tensor(live_w, device=device), torch.as_tensor(live_p, device=device)


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and np.array_equal(a[2], b[2]) and a[3] == b[3])


# ---------------------------------------------------------------------------
# off CUDA


@pytest.mark.parametrize("nroots", [8, 64])
@pytest.mark.parametrize("n", [2048, 131072 - 1000])
def test_emulated_dots_match_float64(nroots, n):
    """The kernel's order of sums, in float64 and rounded once, is the
    float64 dot within float32 rounding; at n = 130072 the last step of
    1024 columns is cut and the chunks take unequal counts of steps."""
    blocks, _, _ = _blocks(nroots, n, seed=nroots + n)
    got = rr3.rr3_dots_emulated(*blocks)
    assert got.dtype == torch.float32 and got.shape == (9, nroots)
    b64 = [b.double() for b in blocks]
    ref = torch.stack([(b64[i] * b64[j]).sum(1) for i, j in rr3.RR3_PAIRS])
    scale = torch.stack([(b64[i] * b64[j]).abs().sum(1) for i, j in rr3.RR3_PAIRS])
    err = (got.double() - ref).abs()
    assert torch.all(err <= 2.0 ** -24 * ref.abs() + 1e-13 * scale)


def test_rr3_auto_only_float32_on_cuda():
    assert rr3.rr3_auto("cuda", torch.float32)
    assert rr3.rr3_auto(torch.device("cuda", 0), torch.float32)
    assert not rr3.rr3_auto("cuda", torch.float64)
    assert not rr3.rr3_auto("cpu", torch.float32)
    assert not rr3.rr3_auto("cpu", torch.float64)


def test_cpu_solve_takes_the_eager_chain(monkeypatch):
    seen = []
    coeffs = fp._rr3_coeffs

    def spy(dots, live_w, live_p, nroots):
        seen.append(nroots)
        return coeffs(dots, live_w, live_p, nroots)

    monkeypatch.setattr(fp, "_rr3_coeffs", spy)
    before = dict(rr3.LAUNCHES)
    a, d = _problem()
    solver = fp.FusedPPCG(lambda x, m: x @ m, d, N, NROOTS, rr_every=RR_EVERY,
                          convergence_threshold=1e-9, max_iter=200,
                          operand=torch.as_tensor(a), device="cpu")
    *_, iters = solver.run_on_device(_guess(d))
    assert iters > RR_EVERY and seen == [NROOTS] * iters
    assert rr3.LAUNCHES == before


@pytest.mark.parametrize("dead", ["w", "p"])
def test_dead_directions_get_zero_coefficients(dead):
    blocks, live_w, live_p = _blocks(NROOTS, N, seed=5, dead=dead)
    c = fp._rr3_coeffs(rr3.rr3_dots_emulated(*blocks), live_w, live_p, NROOTS)
    assert torch.all(torch.isfinite(c))
    if dead == "w":
        assert c[1, 1] == 0.0 and torch.all(c[live_w, 1] != 0.0)
    else:
        assert torch.all(c[::2, 2] == 0.0) and torch.all(c[1::2, 2] != 0.0)
    x_new, _, p_new, _ = rr3.rr3_update_plain(c, *blocks)
    assert torch.all(torch.isfinite(x_new)) and torch.all(torch.isfinite(p_new))


def test_update_wrapper_takes_only_the_card():
    blocks, live_w, live_p = _blocks(NROOTS, 64, seed=1)
    before = dict(rr3.LAUNCHES)
    with pytest.raises(TypeError):
        rr3.rr3_update(torch.zeros(9, NROOTS), live_w, live_p, *blocks)
    with pytest.raises(TypeError):
        rr3.rr3_dots(*blocks)
    assert rr3.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 and device conversion")
    return torch.device("cuda")


CASES = ((0, None), (1, "w"), (2, "p"), (3, None))


@pytest.mark.cuda
@pytest.mark.parametrize("nroots", [8, 64])
def test_kernel_coefficients_and_blocks_equal_eager(cuda, nroots):
    for seed, dead in CASES:
        blocks, live_w, live_p = _blocks(nroots, N, seed, cuda, dead)
        dots = rr3.rr3_dots(*blocks)
        *new, c = rr3.rr3_update(dots, live_w, live_p, *blocks)
        eager = fp._rr3_coeffs(dots, live_w, live_p, nroots)
        assert torch.equal(c, eager), (seed, dead)
        for got, ref in zip(new, rr3.rr3_update_plain(eager, *blocks)):
            assert torch.equal(got, ref), (seed, dead)


@pytest.mark.cuda
@pytest.mark.parametrize("nroots,n", [(8, 2048), (64, 131072 - 1000), (64, 131072), (3, 1001)])
def test_kernel_dots_repeat_and_equal_their_emulation(cuda, nroots, n):
    blocks, _, _ = _blocks(nroots, n, seed=7, device=cuda)
    first = rr3.rr3_dots(*blocks)
    for _ in range(3):
        assert torch.equal(rr3.rr3_dots(*blocks), first)
    assert torch.equal(first.cpu(), rr3.rr3_dots_emulated(*(b.cpu() for b in blocks)))


@pytest.mark.cuda
def test_card_solve_takes_k8_and_matches_eager(cuda, monkeypatch):
    a, d = _problem()
    op = torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def solver():
        return fp.FusedPPCG(lambda x, m: x @ m, d, N, NROOTS, rr_every=RR_EVERY,
                            convergence_threshold=1e-4, max_iter=200, operand=op,
                            device=cuda)

    kernel = solver()
    before = dict(rr3.LAUNCHES)
    first = kernel.run_on_device(_guess(d))
    iters = first[3]
    assert iters > RR_EVERY
    assert rr3.LAUNCHES == {k: v + iters for k, v in before.items()}
    assert _same(kernel.run_on_device(_guess(d)), first)
    monkeypatch.setattr(fp.rr3, "rr3_auto", lambda device, dtype: False)
    eager = solver().run_on_device(_guess(d))
    assert rr3.LAUNCHES == {k: v + 2 * iters for k, v in before.items()}
    assert eager[3] == iters
    assert np.max(np.abs(first[0] - eager[0])) <= 1e-5 * np.max(np.abs(eager[0]))


@pytest.mark.cuda
def test_sharded_card_solve_takes_k8_on_every_rank(cuda, tmp_path):
    W.run_workers(tmp_path, 2, ["ppcg_card"])
    ranks = [W.load(tmp_path, "ppcg_card", r) for r in range(2)]
    for out in ranks:
        iters = int(out["sharded_iters"][0])
        assert out["launches"].tolist() == [iters, iters]
        assert int(out["eager_iters"][0]) == iters
        eager = out["eager_evals"]
        assert np.max(np.abs(out["sharded_evals"] - eager)) <= 1e-5 * np.max(np.abs(eager))
    assert np.array_equal(ranks[0]["sharded_evals"], ranks[1]["sharded_evals"])


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
