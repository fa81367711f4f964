"""ppcg_full_rr_ms_per_solve: device milliseconds of the program's span
``ppcg.full_rr`` (the periodic full Rayleigh-Ritz: its eigh, the
rotations and the re-anchoring action) per ``ppcg.solve``, over the
traced solves. Moves solve_s."""

from portbench import ppcg_spans


def read(run: dict):
    return ppcg_spans.ms_per(run, "ppcg.full_rr", "device_s", ppcg_spans.SOLVE)
