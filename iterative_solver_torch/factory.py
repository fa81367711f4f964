"""String-keyed solver factory (port of iterative_solver_tpu/factory.py;
reference: SolverFactory.h:106-184).

``create_linear_eigensystem(n, nroots, "Davidson", "max_size_qspace=6,...")``
mirrors create_LinearEigensystem<R,Q,P>(method, options). Keyword arguments
go to the solver: ``device="cpu"`` runs it on the host (the default is the
CUDA device), ``dtype=`` sets its working dtype. ``create_optimize`` (BFGS,
SD) and ``create_nonlinear_equations`` (DIIS) build the nonlinear families.
"""

from __future__ import annotations

from . import options as opt
from .solvers.core import IterativeSolverTemplate
from .solvers.linear_eigensystem import LinearEigensystemDavidson, LinearEigensystemRSPT
from .solvers.linear_equations import LinearEquationsDavidson
from .solvers.nonlinear_diis import NonLinearEquationsDIIS
from .solvers.optimize import OptimizeBFGS, OptimizeSD


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


def create_nonlinear_equations(n: int, method: str = "DIIS", options: str = "", **kwargs):
    method = (method or "DIIS").strip()
    if method.upper() not in ("DIIS", ""):
        raise ValueError(f"Unknown NonLinearEquations method: {method}")
    o = opt.NonLinearEquationsDIISOptions.from_string(options)
    solver = NonLinearEquationsDIIS(n, **kwargs)
    _apply_common(solver, o)
    if o.max_size_qspace is not None:
        solver.max_size_qspace = o.max_size_qspace
    if o.norm_thresh is not None:
        solver.norm_thresh = o.norm_thresh
    if o.svd_thresh is not None:
        solver.svd_thresh = o.svd_thresh
    return solver


def create_optimize(n: int, method: str = "BFGS", options: str = "", **kwargs):
    method = (method or "BFGS").strip()
    if method.upper() in ("BFGS", ""):
        o = opt.OptimizeBFGSOptions.from_string(options)
        solver = OptimizeBFGS(n, **kwargs)
        _apply_common(solver, o)
        if o.max_size_qspace is not None:
            solver.max_size_qspace = o.max_size_qspace
        if o.strong_Wolfe is not None:
            solver.strong_wolfe = o.strong_Wolfe
        if o.Wolfe_1 is not None:
            solver.wolfe_1 = o.Wolfe_1
        if o.Wolfe_2 is not None:
            solver.wolfe_2 = o.Wolfe_2
        if o.linesearch_tolerance is not None:
            solver.linesearch_tolerance = o.linesearch_tolerance
        if o.linesearch_grow_factor is not None:
            solver.linesearch_grow_factor = o.linesearch_grow_factor
        return solver
    if method.upper() == "SD":
        o = opt.OptimizeSDOptions.from_string(options)
        solver = OptimizeSD(n, **kwargs)
        _apply_common(solver, o)
        return solver
    raise ValueError(f"Unknown Optimize method: {method}")
