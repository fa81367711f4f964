"""ppcg_launches_per_iter: the host's CUDA launch calls in the traced PPCG
solves (a graph launch counts once) over their iterations (device
trace), read as ``launches_per_iter`` reads it. Moves solve_s."""

from portbench.metrics.launches_per_iter import read  # noqa: F401
