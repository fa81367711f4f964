"""Tiny cells for the CPU tests: each configuration at a small n, run
through the same harness as on the card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CPU = torch.device("cpu")
# each cell's configuration cut to a size the CPU tests hold
TINY = {"fci-davidson-r16": {"n": 4096, "tile": 512}}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.cfg = {**cell.cfg, **TINY[name]}
    return cell


@pytest.fixture(params=sorted(TINY))
def cell(request):
    return tiny_cell(request.param)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
