"""The generators' structure, the byte counts, and each reference action
against a dense numpy product, at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CPU, tiny_cell


def dense(kind: str, gen: dict) -> np.ndarray:
    """The dense float64 operator that the generator's parts describe."""
    assert kind == "packed_int8"
    n = gen["sizes"]["n"]
    a = np.diag(gen["diag"].numpy())
    b, g2 = gen["sizes"]["tile"], gen["gq"] ** 2
    for q, i, j in zip(gen["q"], gen["ii"].tolist(), gen["jj"].tolist()):
        blk = g2 * q.double().numpy()
        a[i * b:(i + 1) * b, j * b:(j + 1) * b] += blk
        if i != j:
            a[j * b:(j + 1) * b, i * b:(i + 1) * b] += blk.T
    return a


@pytest.fixture(params=["fci-davidson-r16"])
def made(request):
    cell = tiny_cell(request.param)
    kind = cell.cfg["operator"]
    gen = harness.plugin("operators", kind).generate(cell.cfg, 2 ** 33 + 5, CPU)
    return cell, kind, gen


def test_symmetric_with_zero_diagonal_coupling(made):
    cell, kind, gen = made
    a = dense(kind, gen)
    assert np.array_equal(a, a.T)
    np.testing.assert_array_equal(np.diagonal(a), gen["diag"].numpy())
    d = np.sort(gen["diag"].numpy())
    assert d[0] == -2.0 and d[cell.cfg["n_low"] - 1] == 3.0 and d[-1] == 50.0


def test_int8_range(made):
    _, kind, gen = made
    q = gen["q"]
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127


def test_seed_draws_the_values(made):
    """One seed gives the same tensors twice; another seed other values on
    the same sizes, indices and diagonal, so the same spectrum's shape."""
    cell, kind, _ = made
    cfg = {**cell.cfg, "n": 2048, "tile": 256}
    mod = harness.plugin("operators", kind)
    a, b, a2 = (mod.generate(cfg, s, CPU) for s in (2 ** 33 + 5, 11, 2 ** 33 + 5))
    assert a["sizes"] == b["sizes"] and a["gq"] == b["gq"]
    for key, t in a.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, a2[key]), key
    for key in ("ii", "jj", "diag"):
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["q"], b["q"])


def test_fci_tiles():
    cell = tiny_cell("fci-davidson-r16")
    gen = harness.plugin("operators", "packed_int8").generate(cell.cfg, 3, CPU)
    nb = cell.cfg["n"] // cell.cfg["tile"]
    assert gen["sizes"]["pairs"] == nb * (nb + 1) // 2
    assert bool((gen["jj"] <= gen["ii"]).all())
    on = gen["ii"] == gen["jj"]
    q = gen["q"][on]
    assert torch.equal(q, q.transpose(1, 2))
    assert int(q.diagonal(dim1=1, dim2=2).abs().max()) == 0
    # sd(E) = coupling / sqrt(n)
    e = gen["gq"] ** 2 * gen["q"][~on].double()
    assert abs(float(e.std()) * np.sqrt(cell.cfg["n"]) / cell.cfg["coupling"] - 1) < 0.02


def test_byte_counts():
    p = 128 * 129 // 2
    nbytes, ops, peak = harness.plugin("operators", "packed_int8").action_cost(
        {"n": 131072, "tile": 1024, "pairs": p, "diag_pairs": 128}, 16)
    assert nbytes == p * 2 ** 20 + 8 * p + 8 * 131072 + 2 * 16 * 131072 * 4
    assert abs(nbytes / 2 ** 30 - 8.07) < 0.01
    # every entry of the dense matrix but the diagonal tiles' twice over
    assert ops == 2 * 16 * 2 ** 20 * (2 * (p - 128) + 128) and peak == "int8"


def test_reference_action_against_dense(made):
    _, kind, gen = made
    ref = harness.plugin("reference", kind)
    x = torch.randn((5, gen["sizes"]["n"]), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    y = ref.action(gen, x)
    want = x.numpy() @ dense(kind, gen)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_control_action_departs(made):
    """The control's lower precision, against the couplings' part of the
    action: on the CPU TF32 is plain float32 (the card alone rounds to
    TF32), so only int4 departs here, by far more than float32 rounding."""
    cell, kind, gen = made
    ref = harness.plugin("reference", kind)
    x = torch.randn((4, gen["sizes"]["n"]), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    y = ref.action(gen, x)
    precision = cell.cfg["control"]["action"]
    yc = ref.action(gen, x, precision=precision).double()
    coupling = (y - x * gen["diag"]).abs().max()
    gap = float((yc - y).abs().max() / coupling)
    assert gap > (0.05 if precision == "int4" else 1e-9)


def test_port_operand_matches_reference(made):
    """The port's operand built from the generator (its plain version on the
    CPU) against the reference action."""
    cell, kind, gen = made
    op = harness.plugin("operators", kind).build(gen, cell.cfg, CPU)
    x = torch.randn((16, op.n), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    y = op.matvec(x, op.operand)
    want = harness.plugin("reference", kind).action(gen, x)
    # int8 rows of x in the packed action
    assert float((y - want).abs().max() / want.abs().max()) < 2e-2
