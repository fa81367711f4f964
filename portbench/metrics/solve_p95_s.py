"""solve_p95_s: the 95th percentile of the wall time of every solve in the
window, each ending in a synchronise (host clock)."""

from portbench import measure


def read(run: dict):
    if not run.get("solve_times"):
        return None
    return measure.percentile(run["solve_times"], 95)
