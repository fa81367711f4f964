"""expand_ms_per_iter: device milliseconds of the program's span
``davidson.expand`` (the preconditioner, Gram-Schmidt or the chain
kernel, and the whitening) per ``davidson.iteration``, over the traced
solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    return spans.ms_per(run, "davidson.expand", "device_s", spans.ITERATION)
