"""host_wait_ms_per_solve: host milliseconds of the program's span
``davidson.wait`` (its blocking device-to-host reads: the convergence
checks and the final read of eigenvalues and errors) per
``davidson.solve``, over the traced solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    return spans.ms_per(run, "davidson.wait", "host_s", spans.SOLVE)
