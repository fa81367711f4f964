"""What every example in examples_torch/ shares: the ``--device`` flag, the
dense float64 reference, and the JSON line that ends each run.

Each example runs on the CUDA card unless it is given ``--device cpu``.
Without CUDA, ``--device cuda`` raises: nothing falls back to the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the ``--device`` flag; ``doc`` is the
    example's docstring."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the solvers run (default: the CUDA card)")
    return ap


def device(name: str) -> torch.device:
    """The device ``--device`` names; raises when it is CUDA and there is
    none."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: run on a CUDA card, or pass --device cpu")
    return torch.device(name)


def guess(diag, nroots: int) -> np.ndarray:
    """One-hot rows on the ``nroots`` lowest diagonal entries."""
    v0 = np.zeros((nroots, len(diag)))
    for row, i in enumerate(np.argsort(diag)[:nroots]):
        v0[row, i] = 1.0
    return v0


def lowest_eigenvalues(matrix, k: int, dev) -> np.ndarray:
    """The ``k`` lowest eigenvalues of a dense symmetric matrix, from a
    float64 eigvalsh on ``dev``."""
    a = torch.as_tensor(np.asarray(matrix), dtype=torch.float64, device=dev)
    return torch.linalg.eigvalsh(a)[:k].cpu().numpy()


def host(x) -> np.ndarray:
    """A real tensor as a float64 numpy array; an array as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x)


def f64_residuals(matrix, x) -> np.ndarray:
    """||A u - (uᵀ A u) u|| of each row u of ``x``, normalised, in float64."""
    u = host(x).astype(np.float64)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    au = u @ np.asarray(matrix).T
    return np.linalg.norm(au - np.sum(u * au, axis=1)[:, None] * u, axis=1)


def run_notebook(path: str) -> dict:
    """Run a notebook's code cells in order, in this process and from the
    notebook's directory, its output captured; return the JSON line the
    output ends with."""
    import contextlib
    import io
    import os

    with open(path) as f:
        cells = json.load(f)["cells"]
    printed = io.StringIO()
    cwd = os.getcwd()
    try:
        os.chdir(os.path.dirname(os.path.abspath(path)))
        with contextlib.redirect_stdout(printed):
            scope = {}
            for cell in cells:
                if cell["cell_type"] == "code":
                    exec("".join(cell["source"]), scope)
    finally:
        os.chdir(cwd)
    return json.loads(printed.getvalue().strip().splitlines()[-1])


def _plain(value):
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, torch.Tensor):
        value = host(value)
    if isinstance(value, np.ndarray):
        return _plain(value.tolist())
    if isinstance(value, (complex, np.complexfloating)):
        return [float(value.real), float(value.imag)]
    if isinstance(value, (np.bool_, bool)):
        return bool(value)
    if isinstance(value, (np.integer, int)):
        return int(value)
    if isinstance(value, (np.floating, float)):
        return float(value)
    return value


def report(result: dict) -> dict:
    """Print ``result`` as one JSON line (the run's last) and return it as
    printed: numpy and torch values become numbers and lists, a complex
    number a [real, imaginary] pair."""
    result = _plain(result)
    print(json.dumps(result), flush=True)
    return result
