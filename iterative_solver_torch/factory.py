"""String-keyed solver factory (port of iterative_solver_tpu/factory.py;
reference: SolverFactory.h:106-184).

``create_linear_eigensystem(n, nroots, "Davidson", "max_size_qspace=6,...")``
mirrors create_LinearEigensystem<R,Q,P>(method, options). Keyword arguments
go to the solver: ``device="cpu"`` runs it on the host (the default is the
CUDA device), ``dtype=`` sets its working dtype.

The optimisers' and DIIS factories wait for their solvers and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from . import options as opt
from .solvers.core import IterativeSolverTemplate
from .solvers.linear_eigensystem import LinearEigensystemDavidson, LinearEigensystemRSPT
from .solvers.linear_equations import LinearEquationsDavidson

_NONLINEAR = "the optimisers and DIIS are not ported yet (ROADMAP.md Queue 1, item 4)"


def _apply_common(solver: IterativeSolverTemplate, o: opt.Options) -> None:
    if o.n_roots is not None:
        solver.set_n_roots(o.n_roots)
    if o.convergence_threshold is not None:
        solver.convergence_threshold = o.convergence_threshold
    if o.convergence_threshold_value is not None:
        solver.convergence_threshold_value = o.convergence_threshold_value
    if o.verbosity is not None:
        solver.verbosity = o.verbosity
    if o.max_iter is not None:
        solver.max_iter = o.max_iter
    if o.max_p is not None:
        solver.max_p = o.max_p
    if o.p_threshold is not None:
        solver.p_threshold = o.p_threshold


def create_linear_eigensystem(
    n: int, nroots: int = 1, method: str = "Davidson", options: str = "", **kwargs
):
    method = (method or "Davidson").strip()
    if method.lower() == "davidson" or method == "":
        o = opt.LinearEigensystemDavidsonOptions.from_string(options)
        solver = LinearEigensystemDavidson(n, nroots, **kwargs)
        _apply_common(solver, o)
        if o.reset_D is not None:
            solver.set_reset_D(o.reset_D)
        if o.reset_D_max_Q_size is not None:
            solver.set_reset_D_maxQ_size(o.reset_D_max_Q_size)
        if o.max_size_qspace is not None:
            solver.set_max_size_qspace(o.max_size_qspace)
        if o.norm_thresh is not None:
            solver.propose_rspace_norm_thresh = o.norm_thresh
        if o.svd_thresh is not None:
            solver.propose_rspace_svd_thresh = o.svd_thresh
        if o.hermiticity is not None:
            solver.set_hermiticity(o.hermiticity)
        return solver
    if method.upper() == "RSPT":
        o = opt.LinearEigensystemRSPTOptions.from_string(options)
        solver = LinearEigensystemRSPT(n, nroots, **kwargs)
        _apply_common(solver, o)
        if o.norm_thresh is not None:
            solver.propose_rspace_norm_thresh = o.norm_thresh
        if o.svd_thresh is not None:
            solver.propose_rspace_svd_thresh = o.svd_thresh
        return solver
    raise ValueError(f"Unknown LinearEigensystem method: {method}")


def create_linear_equations(
    n: int, nroots: int = 1, method: str = "Davidson", options: str = "", **kwargs
):
    method = (method or "Davidson").strip()
    if method.lower() not in ("davidson", ""):
        raise ValueError(f"Unknown LinearEquations method: {method}")
    o = opt.LinearEquationsDavidsonOptions.from_string(options)
    solver = LinearEquationsDavidson(n, nroots, **kwargs)
    _apply_common(solver, o)
    if o.reset_D is not None:
        solver.set_reset_D(o.reset_D)
    if o.reset_D_max_Q_size is not None:
        solver.set_reset_D_maxQ_size(o.reset_D_max_Q_size)
    if o.max_size_qspace is not None:
        solver.set_max_size_qspace(o.max_size_qspace)
    if o.norm_thresh is not None:
        solver.propose_rspace_norm_thresh = o.norm_thresh
    if o.svd_thresh is not None:
        solver.propose_rspace_svd_thresh = o.svd_thresh
    if o.hermiticity is not None:
        solver.set_hermiticity(o.hermiticity)
    if o.augmented_hessian is not None:
        solver.set_augmented_hessian(o.augmented_hessian)
    return solver


def create_nonlinear_equations(*args, **kwargs):
    raise NotImplementedError(_NONLINEAR)


def create_optimize(*args, **kwargs):
    raise NotImplementedError(_NONLINEAR)
