"""ritz_ms_per_iter: device milliseconds of the program's span
``davidson.ritz`` (the Ritz vectors and their actions from the basis,
the Rayleigh-quotient row dots, the residuals and their norms) per
``davidson.iteration``, over the traced solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    return spans.ms_per(run, "davidson.ritz", "device_s", spans.ITERATION)
