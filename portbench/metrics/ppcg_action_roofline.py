"""ppcg_action_roofline: the operator action's share of its roofline at
the PPCG cell's 64 rows (K4's square walk), in percent, read as
``action_roofline`` reads it: the larger of the configuration's bytes
over the memory peak and its operations over the compute peak, over the
CUDA-event time of one call of the public matvec. Moves solve_s."""

from portbench.metrics.action_roofline import read  # noqa: F401
