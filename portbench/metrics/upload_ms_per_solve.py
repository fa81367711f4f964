"""upload_ms_per_solve: host milliseconds of the program's span
``davidson.upload`` (the guess converted, padded and put on the device)
per ``davidson.solve``, over the traced solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    return spans.ms_per(run, "davidson.upload", "host_s", spans.SOLVE)
