"""ppcg_rr3_ms_per_iter: device milliseconds of the program's span
``ppcg.rr3`` (the per-root 3x3 Rayleigh-Ritz with its Jacobi sweeps, the
coefficient update and the Cholesky-QR) per ``ppcg.iteration``, over the
traced solves. Moves solve_s."""

from portbench import ppcg_spans


def read(run: dict):
    return ppcg_spans.ms_per(run, "ppcg.rr3", "device_s", ppcg_spans.ITERATION)
