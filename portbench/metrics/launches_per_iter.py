"""launches_per_iter: the host's CUDA launch calls in the traced solves
(a graph launch counts once) over their iterations (device trace). Moves
solve_s."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["launch_calls"] or not tr["iterations"]:
        return None
    return tr["launch_calls"] / tr["iterations"]
