"""ppcg_host_wait_ms_per_solve: host milliseconds of the program's span
``ppcg.wait`` (its blocking device-to-host reads: the convergence tests
and the final read of eigenvalues and errors) per ``ppcg.solve``, over
the traced solves. Moves solve_s."""

from portbench import ppcg_spans


def read(run: dict):
    return ppcg_spans.ms_per(run, "ppcg.wait", "host_s", ppcg_spans.SOLVE)
