"""iterative_solver_torch — the PyTorch/CUDA port of iterative_solver_tpu.

The JAX package beside it stays the reference; this package mirrors its
names and layout so each function's counterpart is easy to find. It never
imports ``jax`` or ``iterative_solver_tpu``. Its hot kernels are hand-written
CUDA C++ for Hopper (``ops/kernels/csrc``), built with ``nvcc`` at first use.

Quick start (on a CUDA card)::

    from iterative_solver_torch import FusedDavidson
    solver = FusedDavidson.from_dense_symmetric(matrix, nroots=4)
    evals, x, errors, iters = solver.run_on_device(guess)

Pass ``device="cpu"`` to run the plain PyTorch versions on the host.
Importing this package needs no card.
"""

from . import config as config  # noqa: F401  (pins matmul precision)
from .solvers.fused_davidson import FusedDavidson

__version__ = "0.1.0"

__all__ = ["FusedDavidson"]
