"""Block-vector operations of the port (the ArrayHandler layer): the
device basis store and the vector operations. The offload stores are
imported from ``array.offload_store``, as in the JAX package.
``Distribution`` and ``spread_remainder`` (``array/distribution.py``) wait
for ROADMAP.md Queue 1, item 6b."""

from . import vector_ops
from .basis_store import BasisStore

__all__ = ["BasisStore", "vector_ops"]
