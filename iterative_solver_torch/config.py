"""Device, dtype and matmul-precision policy of the PyTorch port.

Counterparts in the JAX package:

- the default dtype follows ``jax_enable_x64`` there
  (iterative_solver_tpu/solvers/fused_davidson.py:803-804); here it follows
  the device: float32 on CUDA, float64 on the CPU (the f64 test tier);
- every matmul there asks for ``Precision.HIGHEST``; here float32 matmuls
  are pinned to full float32, with TF32 off for cuBLAS and cuDNN alike.

The entry points run on the card unless the caller asks for the CPU.
Without CUDA they raise: nothing falls back to the host silently.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


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
