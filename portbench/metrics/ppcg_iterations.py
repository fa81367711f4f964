"""ppcg_iterations: the mean iteration count that the PPCG solves of the
window returned (the solver's own count), read as ``iterations`` reads
it. Moves solve_s."""

from portbench.metrics.iterations import read  # noqa: F401
