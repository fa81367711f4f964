"""first_solve_s: the first solve of set-up (host clock): the symmetry
probe, the libraries' handles and the allocator's growth on top of one
solve. Moves setup_s."""


def read(run: dict):
    return run.get("first_solve_s")
