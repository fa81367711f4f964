"""Procedural C-ABI-style interface with an instance stack (port of
iterative_solver_tpu/bindings/c_api.py).

Mirrors the reference's C binding semantics (IterativeSolverC.h:6-74,
IterativeSolverCMPI.cpp; SURVEY.md Appendix B): a stack of solver
instances of which only the top is active, Initialize/Finalize push/pop,
vector arguments are the caller's full replicated (nbuffer, dimension)
host buffers, and ``sync`` re-replicates results (a no-op here: the
buffers are host float64 numpy arrays, written back in place).

This module is both the Python-procedural API and the implementation the
embedded C shared library (bindings/build_embedded.py) dispatches into. The
function names, arguments and return values are the JAX package's.

Device. The Initialize functions take ``device=None``: the option store's
``DEVICE`` (``config.get_option``, the environment variable
``ITERATIVE_SOLVER_DEVICE``), and where that is unset the CUDA card. A C
program has no argument to pass, so the embedded library is steered by the
environment alone (``ITERATIVE_SOLVER_DEVICE=cpu`` runs it on the host); an
unknown value raises. The solvers work in float64 on either device: the
ABI's buffers are double, as the reference's are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import config
from ..array import vector_ops as vops
from ..factory import (
    create_linear_eigensystem,
    create_linear_equations,
    create_nonlinear_equations,
    create_optimize,
)


@dataclasses.dataclass
class _Instance:
    solver: object
    dimension: int
    nroot: int
    diagonals: Optional[np.ndarray] = None
    last_value: float = float("nan")
    # functional R blocks threaded between AddVector/EndIteration calls
    params: Optional[object] = None
    actions: Optional[object] = None


_stack: List[_Instance] = []


def _top() -> _Instance:
    if not _stack:
        raise RuntimeError("no active IterativeSolver instance")
    return _stack[-1]


def _verbosity_to_int(v) -> int:
    return int(v)


def _solver_kwargs(device) -> dict:
    """The factory's device and dtype: ``device``, else the ``DEVICE``
    option, else the card (``None``); float64 throughout."""
    if device is None:
        setting = str(config.get_option("DEVICE") or "").strip()
        if setting:
            try:
                device = torch.device(setting)
            except RuntimeError as err:
                raise ValueError(f"ITERATIVE_SOLVER_DEVICE={setting!r} is not a device "
                                 "(use 'cpu' or 'cuda')") from err
            if device.type not in ("cpu", "cuda"):
                raise ValueError(f"ITERATIVE_SOLVER_DEVICE={setting!r}: the solvers run on "
                                 "'cpu' or 'cuda'")
    return {"device": device, "dtype": torch.float64}


# ---------------------------------------------------------------------------
def IterativeSolverLinearEigensystemInitialize(
    n, nroot, thresh=1e-8, thresh_value=1e50, hermitian=True, verbosity=0,
    algorithm="", options="", device=None,
):
    solver = create_linear_eigensystem(int(n), int(nroot), algorithm or "Davidson", options,
                                       **_solver_kwargs(device))
    solver.convergence_threshold = thresh
    solver.convergence_threshold_value = thresh_value
    if hasattr(solver, "set_hermiticity"):
        solver.set_hermiticity(bool(hermitian))
    solver.verbosity = int(verbosity)
    _stack.append(_Instance(solver, int(n), int(nroot)))
    return 0, int(n)  # local range [begin, end) — whole vector on one process


def IterativeSolverLinearEquationsInitialize(
    n, nroot, rhs, aughes=0.0, thresh=1e-8, thresh_value=1e50, hermitian=True,
    verbosity=0, algorithm="", options="", device=None,
):
    solver = create_linear_equations(int(n), int(nroot), algorithm or "Davidson", options,
                                     **_solver_kwargs(device))
    solver.convergence_threshold = thresh
    solver.convergence_threshold_value = thresh_value
    solver.set_hermiticity(bool(hermitian))
    solver.set_augmented_hessian(float(aughes))
    solver.verbosity = int(verbosity)
    rhs = np.asarray(rhs, dtype=np.float64).reshape(int(nroot), int(n))
    solver.add_equations(rhs)
    _stack.append(_Instance(solver, int(n), int(nroot)))
    return 0, int(n)


def IterativeSolverNonLinearEquationsInitialize(
    n, thresh=1e-8, verbosity=0, algorithm="", options="", device=None,
):
    solver = create_nonlinear_equations(int(n), algorithm or "DIIS", options,
                                        **_solver_kwargs(device))
    solver.convergence_threshold = thresh
    solver.verbosity = int(verbosity)
    _stack.append(_Instance(solver, int(n), 1))
    return 0, int(n)


def IterativeSolverOptimizeInitialize(
    n, thresh=1e-8, thresh_value=1e50, verbosity=0, minimize=True,
    algorithm="", options="", device=None,
):
    solver = create_optimize(int(n), algorithm or "BFGS", options, **_solver_kwargs(device))
    solver.convergence_threshold = thresh
    solver.convergence_threshold_value = thresh_value
    solver.verbosity = int(verbosity)
    _stack.append(_Instance(solver, int(n), 1))
    return 0, int(n)


def IterativeSolverFinalize():
    if _stack:
        _stack.pop()


# ---------------------------------------------------------------------------
def _to_block(inst: _Instance, buf: np.ndarray, nbuffer: int):
    block = np.asarray(buf, dtype=np.float64).reshape(-1)[: nbuffer * inst.dimension]
    return vops.to_device(block.reshape(nbuffer, inst.dimension), inst.solver.dtype,
                          inst.solver.device, inst.solver.sharding)


def _host(block) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        return block.detach().to("cpu", torch.float64).numpy()
    return np.asarray(block)


def _write_back(buf: np.ndarray, block, nbuffer: int, dimension: int):
    flat = np.asarray(buf).reshape(-1)
    flat[: nbuffer * dimension] = _host(block)[:nbuffer].reshape(-1)


def IterativeSolverAddVector(nbuffer, parameters, action, sync=1):
    inst = _top()
    nbuffer = int(nbuffer)
    p = _to_block(inst, parameters, nbuffer)
    a = _to_block(inst, action, nbuffer)
    nwork, p, a = inst.solver.add_vector(p, a)
    inst.params, inst.actions = p, a
    _write_back(parameters, p, nbuffer, inst.dimension)
    _write_back(action, a, nbuffer, inst.dimension)
    return nwork


def IterativeSolverAddValue(value, parameters, action, sync=1):
    inst = _top()
    p = _to_block(inst, parameters, 1)
    a = _to_block(inst, action, 1)
    nwork, p, a = inst.solver.add_vector(p, a, float(value))
    inst.params, inst.actions = p, a
    inst.last_value = float(value)
    _write_back(parameters, p, 1, inst.dimension)
    _write_back(action, a, 1, inst.dimension)
    return nwork


def IterativeSolverEndIteration(nbuffer, solution, residual, sync=1):
    inst = _top()
    nbuffer = int(nbuffer)
    p = _to_block(inst, solution, nbuffer)
    a = _to_block(inst, residual, nbuffer)
    nwork, p, a = inst.solver.end_iteration(p, a)
    inst.params, inst.actions = p, a
    _write_back(solution, p, nbuffer, inst.dimension)
    _write_back(residual, a, nbuffer, inst.dimension)
    return nwork


def IterativeSolverEndIterationNeeded():
    return 1 if _top().solver.end_iteration_needed else 0


def IterativeSolverSolution(nroot, roots, parameters, action, sync=1):
    inst = _top()
    roots = [int(r) for r in np.asarray(roots).reshape(-1)[: int(nroot)]]
    p, r = inst.solver.solution(roots)
    _write_back(parameters, p, len(roots), inst.dimension)
    _write_back(action, r, len(roots), inst.dimension)


def IterativeSolverAddP(nbuffer, nP, offsets, indices, coefficients, pp,
                        parameters, action, sync=1, func: Optional[Callable] = None):
    """Install a sparse P space. offsets (nP+1) delimit each vector's
    indices/coefficients; pp is the nP x nP model matrix; func applies the
    P-space action (pcoeff (m, nP) -> (m, N) contribution)."""
    inst = _top()
    nP = int(nP)
    offsets = np.asarray(offsets, dtype=np.int64).reshape(-1)
    indices = np.asarray(indices, dtype=np.int64).reshape(-1)
    coefficients = np.asarray(coefficients, dtype=np.float64).reshape(-1)
    pvectors: List[Dict[int, float]] = []
    for i in range(nP):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        pvectors.append({int(indices[j]): float(coefficients[j]) for j in range(lo, hi)})
    pp_mat = np.asarray(pp, dtype=np.float64).reshape(nP, nP)
    nbuffer = int(nbuffer)
    p = _to_block(inst, parameters, nbuffer)
    a = _to_block(inst, action, nbuffer)

    if func is not None:
        def apply_p(pcoeff, pvecs):
            out = func(_host(pcoeff), pvecs)
            return vops.to_device(_host(out), inst.solver.dtype, inst.solver.device)
    else:
        apply_p = None

    nwork, p, a = inst.solver.add_p(pvectors, pp_mat, p, a, apply_p)
    inst.params, inst.actions = p, a
    _write_back(parameters, p, nbuffer, inst.dimension)
    _write_back(action, a, nbuffer, inst.dimension)
    return nwork


def IterativeSolverErrors(errors):
    inst = _top()
    out = np.asarray(errors).reshape(-1)
    vals = inst.solver.errors
    out[: len(vals)] = vals


def IterativeSolverEigenvalues(eigenvalues):
    inst = _top()
    out = np.asarray(eigenvalues).reshape(-1)
    vals = _host(inst.solver.eigenvalues())
    out[: vals.size] = vals


def IterativeSolverWorkingSetEigenvalues(eigenvalues):
    inst = _top()
    out = np.asarray(eigenvalues).reshape(-1)
    try:
        vals = _host(inst.solver.working_set_eigenvalues())
    except Exception:
        vals = np.zeros(len(inst.solver.working_set))
    out[: vals.size] = vals


def IterativeSolverSuggestP(solution, residual, maximum_number, threshold, indices):
    """Suggest P-space indices from the current solution/residual blocks
    (IterativeSolverC.h:47-48). The reference's template leaves suggest_p
    unimplemented (IterativeSolverTemplate.h:458-461, returns {}); here it
    runs the solver's real top-|solution_i * residual_i| selection
    (core.py suggest_p). Writes 0-based indices into ``indices`` and
    returns the count."""
    inst = _top()
    if not hasattr(inst.solver, "suggest_p"):
        return 0
    nroot, dim = inst.nroot, inst.dimension
    sol = np.asarray(solution, dtype=np.float64).reshape(-1)[: nroot * dim]
    res = np.asarray(residual, dtype=np.float64).reshape(-1)[: nroot * dim]
    idx = inst.solver.suggest_p(
        _to_block(inst, sol, nroot), _to_block(inst, res, nroot),
        int(maximum_number), float(threshold))
    # write through the CALLER's buffer: np.asarray on a list/array-like
    # would copy, the results would land in the temporary, and the caller
    # would misread its untouched zeros as suggestions (review round 4)
    if isinstance(indices, np.ndarray):
        indices.reshape(-1)[: len(idx)] = idx
    else:
        indices[: len(idx)] = idx
    return len(idx)


def IterativeSolverPrintStatistics():
    print(_top().solver.stats)


def IterativeSolverNonLinear():
    return 1 if _top().solver.nonlinear else 0


def IterativeSolverHasValues():
    return 1 if _top().solver.nonlinear and hasattr(_top().solver, "value") else 0


def IterativeSolverHasEigenvalues():
    return 1 if _top().solver.linear_eigensystem else 0


def IterativeSolverSetDiagonals(diagonals):
    inst = _top()
    inst.diagonals = np.asarray(diagonals, dtype=np.float64)[: inst.dimension].copy()


def IterativeSolverDiagonals(diagonals):
    inst = _top()
    if inst.diagonals is None:
        raise RuntimeError("no diagonals stored")
    np.asarray(diagonals).reshape(-1)[: inst.dimension] = inst.diagonals


def IterativeSolverValue():
    return _top().solver.value


def IterativeSolverVerbosity():
    return _verbosity_to_int(_top().solver.verbosity)


def IterativeSolverMaxIter():
    return _top().solver.max_iter


def IterativeSolverSetMaxIter(max_iter):
    _top().solver.max_iter = int(max_iter)


def IterativeSolver_mpicomm_global():
    return 0  # no MPI communicators: a process group is set up in Python


def IterativeSolver_mpicomm_self():
    return 0
