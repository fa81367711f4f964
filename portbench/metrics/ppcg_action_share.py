"""ppcg_action_share: the device extent of the program's span
``ppcg.action`` (every call of the operator's action: the init's, the
step's and the full Rayleigh-Ritz's re-anchoring) over that of
``ppcg.solve``, in percent, over the traced solves. Moves solve_s."""

from portbench import ppcg_spans


def read(run: dict):
    reg = ppcg_spans.registry(run)
    if reg is None or "ppcg.action" not in reg["spans"]:
        return None
    solve = reg["spans"][ppcg_spans.SOLVE]["device_s"]
    if not solve > 0:
        return None
    return 100.0 * reg["spans"]["ppcg.action"]["device_s"] / solve
