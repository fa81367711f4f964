"""setup_s: process start to the first timed solve (host clock): the
program's import, generation on the card, the operand, the first action
(the kernels built or loaded), the solver and the warm solve."""


def read(run: dict):
    return run.get("setup_s")
