"""iterations: the mean iteration count that the solves of the window
returned (the solver's own count). Moves solve_s."""


def read(run: dict):
    its = run.get("iterations")
    if not its:
        return None
    return sum(its) / len(its)
