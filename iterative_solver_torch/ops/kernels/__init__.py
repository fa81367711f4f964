"""Hand-written CUDA C++ kernels of the port (``csrc/``), each beside its
plain PyTorch version. Importing these modules builds nothing: a kernel is
built with ``nvcc`` at its first launch (``_build.py``). The dense int8
tiers (``dense_int8.py``) have no kernel of their own: their int8 product
is ``torch._int_mm``."""

from .dense_int8 import DenseInt8, DenseInt8Split

__all__ = ["DenseInt8", "DenseInt8Split"]
