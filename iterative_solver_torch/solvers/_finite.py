"""Non-finite detection for the fused solver families (port of
iterative_solver_tpu/solvers/_finite.py).

Every fused solve loop's condition includes ``err > tol``; a NaN error makes
that comparison False, so the loop exits early *looking like* normal
convergence. The reference instead throws (``solve_DIIS`` raises
``overflow_error`` on NaN coefficients, helper-implementation.h:619-669).
Each fused ``run``/``solve`` calls ``check_finite`` on the fetched final
errors and raises ``FloatingPointError`` rather than returning NaN-filled
solutions.
"""

from __future__ import annotations

import numpy as np


def check_finite(errors, solver: str) -> None:
    """Raise FloatingPointError if any fetched error/metric is not finite."""
    arr = np.asarray(errors)
    if not np.all(np.isfinite(arr)):
        raise FloatingPointError(
            f"{solver}: solve diverged to non-finite residual norms "
            f"({arr!r}); the iteration exited on NaN, not convergence. "
            "Check the operator/preconditioner scaling or loosen the "
            "preconditioner regularisation."
        )
