"""rr_ms_per_iter: device milliseconds of the program's span
``davidson.rr`` (the Rayleigh-Ritz step: the subspace matrix and its
eigh) per ``davidson.iteration``, over the traced solves. Moves
solve_s."""

from portbench import spans


def read(run: dict):
    return spans.ms_per(run, "davidson.rr", "device_s", spans.ITERATION)
