"""Block-vector operations of the port (the ArrayHandler layer): the
device basis store, the vector operations and the 1-D partition
bookkeeping. The offload stores and ``DistrArray`` are imported from their
modules, as in the JAX package."""

from . import vector_ops
from .basis_store import BasisStore
from .distribution import Distribution, spread_remainder

__all__ = ["BasisStore", "Distribution", "spread_remainder", "vector_ops"]
