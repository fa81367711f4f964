"""Model operators and problems of the port (counterparts of iterative_solver_tpu/models)."""

from . import synthetic_fci
from .matrix_problem import (
    ExampleProblem,
    MatrixProblem,
    QuadraticOptimizeProblem,
    RayleighQuotientProblem,
    TrigNonlinearProblem,
    load_hamiltonian,
)

__all__ = [
    "synthetic_fci",
    "ExampleProblem",
    "MatrixProblem",
    "QuadraticOptimizeProblem",
    "RayleighQuotientProblem",
    "TrigNonlinearProblem",
    "load_hamiltonian",
]
