"""Model operators of the port (counterparts of iterative_solver_tpu/models)."""
