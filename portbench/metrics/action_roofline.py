"""action_roofline: the operator action's share of its roofline, in
percent: the larger of the configuration's bytes over the memory peak and
its operations over the compute peak, over the CUDA-event time of one
call of the public matvec at the cell's row count. Moves solve_s."""

from portbench import measure


def read(run: dict):
    a = run.get("action")
    if not a or not a["ms"] > 0:
        return None
    return measure.roofline_percent(a["bytes"], a["ops"], a["peak"], a["ms"])
