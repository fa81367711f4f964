"""Device, dtype and matmul-precision policy of the PyTorch port.

Counterparts in the JAX package:

- the default dtype follows ``jax_enable_x64`` there
  (iterative_solver_tpu/solvers/fused_davidson.py:803-804); here it follows
  the device: float32 on CUDA, float64 on the CPU (the f64 test tier);
- every matmul there asks for ``Precision.HIGHEST``; here float32 matmuls
  are pinned to full float32, with TF32 off for cuBLAS and cuDNN alike.

The entry points run on the card unless the caller asks for the CPU.
Without CUDA they raise: nothing falls back to the host silently.

The ambient option store (iterative_solver_tpu/config.py:24-57, the
reference's molpro::Options("ITERATIVE-SOLVER")) is kept with the same
names and precedence: ``set_option``, then environment variables prefixed
``ITERATIVE_SOLVER_``, then the defaults. Knobs:

- ``BSR_BLOCK``       default block size of ``BSRMatrix.from_dense`` (128);
- ``GEMM_BUFFERS``    prefetch depth of the native vecstore pipeline (2);
- ``PROFILER_DEPTH``  max region nesting recorded by utils.Profiler (0 = off);
- ``PROFILER_OUTPUT``, ``PROFILER_DOTGRAPH``, ``PROFILER_THRESHOLD``: where
  a parity solver writes its profile tree at teardown;
- ``DEVICE``          where the C ABI's solvers run (bindings/c_api.py):
  "cpu" or "cuda"; empty (the default) is the CUDA card.

The JAX package's ``COMPILE_CACHE`` (XLA's persistent cache) has no
counterpart: PyTorch runs eagerly and the kernels cache their own builds.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_DEFAULTS: Dict[str, Any] = {
    "BSR_BLOCK": 128,
    "GEMM_BUFFERS": 2,
    "PROFILER_DEPTH": 0,
    "PROFILER_OUTPUT": "",
    "PROFILER_DOTGRAPH": "",
    "PROFILER_THRESHOLD": 0.01,
    "DEVICE": "",
}

_overrides: Dict[str, Any] = {}


def get_option(key: str, default: Any = None):
    key = key.upper()
    if key in _overrides:
        return _overrides[key]
    env = os.environ.get(f"ITERATIVE_SOLVER_{key}")
    if env is not None:
        base = _DEFAULTS.get(key, default)
        if isinstance(base, int):
            return int(env)
        if isinstance(base, float):
            return float(env)
        return env
    return _DEFAULTS.get(key, default)


def set_option(key: str, value: Any) -> None:
    _overrides[key.upper()] = value


def clear_options() -> None:
    _overrides.clear()


def default_device() -> torch.device:
    """The CUDA device; raises where CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "iterative_solver_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the host")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; anything else is taken as given."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


def default_dtype(device) -> torch.dtype:
    """float32 on an accelerator, float64 on the CPU."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
