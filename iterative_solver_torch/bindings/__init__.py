"""The C ABI of the port (port of iterative_solver_tpu/bindings): the
instance-stack procedural API (``c_api``) and the builder of the embedded
shared library C and Fortran programs link against (``build_embedded``,
run as ``python -m iterative_solver_torch.bindings.build_embedded <outdir>``;
it needs cffi and a C compiler, and imports them only when it builds)."""

from . import c_api

__all__ = ["c_api"]
