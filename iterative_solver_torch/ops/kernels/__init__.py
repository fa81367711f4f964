"""Hand-written CUDA C++ kernels of the port (``csrc/``), each beside its
plain PyTorch version. Importing these modules builds nothing: a kernel is
built with ``nvcc`` at its first launch (``_build.py``). The dense int8
tiers (``dense_int8.py``) have no kernel of their own: their int8 product
is ``torch._int_mm``.

The JAX package exports its Pallas entry points under Pallas names; the
port exports its kernel wrappers under its own names instead:
``bsr_matmat_kernel`` answers ``bsr_matmat_pallas`` and
``masked_gram_kernel`` answers ``masked_gram_pallas``."""

from .dense_int8 import DenseInt8, DenseInt8Split
from .gram import masked_gram_kernel
from .spmv import BSRMatrix, BSRMatrixInt8, bsr_matmat, bsr_matmat_int8, bsr_matmat_kernel

__all__ = ["BSRMatrix", "BSRMatrixInt8", "bsr_matmat", "bsr_matmat_int8",
           "bsr_matmat_kernel", "masked_gram_kernel", "DenseInt8", "DenseInt8Split"]
