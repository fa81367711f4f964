"""The P/Q/D subspace of the parity solvers (port of iterative_solver_tpu/subspace)."""
