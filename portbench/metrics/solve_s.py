"""solve_s: seconds to a converged solution, the window's wall time from
the first solve's start to the last solve's synchronise over the solves
completed (host clock)."""

from portbench import measure


def read(run: dict):
    if not run.get("attempted"):
        return None
    return measure.window_rate(run["window_s"], run["attempted"])
