"""h2d_mb_per_solve: megabytes (1e6 bytes) that the program's counter
``h2d_bytes`` saw land on the card from host memory, per
``davidson.solve``, over the traced solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    reg = spans.registry(run)
    if reg is None:
        return None
    return reg["counters"].get("h2d_bytes", 0) / 1e6 / reg["spans"][spans.SOLVE]["count"]
