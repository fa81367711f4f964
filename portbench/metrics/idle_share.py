"""idle_share: the share of the traced solves' wall time in which no
kernel, copy or set ran on the device, in percent (device trace). Moves
solve_s."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["window_s"] > 0 or not tr["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
