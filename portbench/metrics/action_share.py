"""action_share: the device extent of the program's span
``davidson.action`` (every call of the operator's action) over that of
``davidson.solve``, in percent, over the traced solves. Moves solve_s."""

from portbench import spans


def read(run: dict):
    reg = spans.registry(run)
    if reg is None or "davidson.action" not in reg["spans"]:
        return None
    solve = reg["spans"][spans.SOLVE]["device_s"]
    if not solve > 0:
        return None
    return 100.0 * reg["spans"]["davidson.action"]["device_s"] / solve
