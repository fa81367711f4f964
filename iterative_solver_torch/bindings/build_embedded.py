"""Build the embedded C shared library exposing the reference's C ABI
(port of iterative_solver_tpu/bindings/build_embedded.py).

Produces ``libiterative_solver_torch_c.so``, which a C (or Fortran, via
BIND(C)) program links against with the repository's unchanged header
``include/iterative_solver_c.h``: the same symbols, one ``@ffi.def_extern``
per header prototype. Calls run the port's solvers (``bindings/c_api.py``)
in an embedded Python interpreter (cffi embedding). The ABI is the
reference's IterativeSolverC.h:6-74 minus the MPI communicator plumbing
(the fcomm arguments are accepted and ignored).

The embedded interpreter imports ``iterative_solver_torch`` from its
``PYTHONPATH``; the solvers run where ``ITERATIVE_SOLVER_DEVICE`` says
("cpu" or "cuda"; unset is the CUDA card), in float64. Building needs cffi
and a C compiler; the header is not written, so the repository's stays as
it is.

Usage: python -m iterative_solver_torch.bindings.build_embedded [outdir]
(``outdir`` defaults to build/torch_c, which .gitignore lists).
"""

from __future__ import annotations

import os
import sys

# declarations for cffi (no preprocessor directives allowed)
DECLS = """
void IterativeSolverLinearEigensystemInitialize(size_t n, size_t nroot, size_t* range_begin,
                                                size_t* range_end, double thresh, double thresh_value,
                                                int hermitian, int verbosity, const char* fname,
                                                int64_t fcomm, const char* algorithm, const char* options);
void IterativeSolverLinearEquationsInitialize(size_t n, size_t nroot, size_t* range_begin, size_t* range_end,
                                              const double* rhs, double aughes, double thresh,
                                              double thresh_value, int hermitian, int verbosity,
                                              const char* fname, int64_t fcomm, const char* algorithm,
                                              const char* options);
void IterativeSolverNonLinearEquationsInitialize(size_t n, size_t* range_begin, size_t* range_end,
                                                 double thresh, int verbosity, const char* fname,
                                                 int64_t fcomm, const char* algorithm, const char* options);
void IterativeSolverOptimizeInitialize(size_t n, size_t* range_begin, size_t* range_end, double thresh,
                                       double thresh_value, int verbosity, int minimize, const char* fname,
                                       int64_t fcomm, const char* algorithm, const char* options);
void IterativeSolverFinalize();
size_t IterativeSolverAddVector(size_t buffer_size, double* parameters, double* action, int sync);
void IterativeSolverSolution(int nroot, int* roots, double* parameters, double* action, int sync);
size_t IterativeSolverAddValue(double value, double* parameters, double* action, int sync);
size_t IterativeSolverEndIteration(size_t buffer_size, double* solution, double* residual, int sync);
int IterativeSolverEndIterationNeeded();
size_t IterativeSolverAddP(size_t buffer_size, size_t nP, const size_t* offsets, const size_t* indices,
                           const double* coefficients, const double* pp, double* parameters, double* action,
                           int sync, void (*func)(const double*, double*, size_t, const size_t*));
size_t IterativeSolverSuggestP(const double* solution, const double* residual, size_t maximum_number,
                               double threshold, size_t* indices);
void IterativeSolverErrors(double* errors);
void IterativeSolverEigenvalues(double* eigenvalues);
void IterativeSolverWorkingSetEigenvalues(double* eigenvalues);
void IterativeSolverPrintStatistics();
int IterativeSolverNonLinear();
int IterativeSolverHasValues();
int IterativeSolverHasEigenvalues();
void IterativeSolverSetDiagonals(const double* diagonals);
void IterativeSolverDiagonals(double* diagonals);
double IterativeSolverValue();
int IterativeSolverVerbosity();
int IterativeSolverMaxIter();
void IterativeSolverSetMaxIter(int max_iter);
int64_t IterativeSolver_mpicomm_global();
int64_t IterativeSolver_mpicomm_self();
"""

INIT_CODE = r'''
from iterative_solver_torch_c import ffi

import numpy as np


def _buf(ptr, count):
    """numpy view over a C double buffer (zero copy)."""
    return np.frombuffer(ffi.buffer(ptr, count * 8), dtype=np.float64)


def _str(p):
    return ffi.string(p).decode() if p != ffi.NULL else ""


def _api():
    from iterative_solver_torch.bindings import c_api
    return c_api


def _dim():
    from iterative_solver_torch.bindings.c_api import _top
    return _top().dimension


def _nroot():
    from iterative_solver_torch.bindings.c_api import _top
    return _top().nroot


@ffi.def_extern()
def IterativeSolverLinearEigensystemInitialize(n, nroot, range_begin, range_end, thresh,
                                               thresh_value, hermitian, verbosity, fname,
                                               fcomm, algorithm, options):
    lo, hi = _api().IterativeSolverLinearEigensystemInitialize(
        n, nroot, thresh, thresh_value, bool(hermitian), verbosity,
        _str(algorithm), _str(options))
    range_begin[0] = lo
    range_end[0] = hi


@ffi.def_extern()
def IterativeSolverLinearEquationsInitialize(n, nroot, range_begin, range_end, rhs, aughes,
                                             thresh, thresh_value, hermitian, verbosity,
                                             fname, fcomm, algorithm, options):
    rhs_arr = _buf(rhs, int(n) * int(nroot)).copy()
    lo, hi = _api().IterativeSolverLinearEquationsInitialize(
        n, nroot, rhs_arr, aughes, thresh, thresh_value, bool(hermitian),
        verbosity, _str(algorithm), _str(options))
    range_begin[0] = lo
    range_end[0] = hi


@ffi.def_extern()
def IterativeSolverNonLinearEquationsInitialize(n, range_begin, range_end, thresh, verbosity,
                                                fname, fcomm, algorithm, options):
    lo, hi = _api().IterativeSolverNonLinearEquationsInitialize(
        n, thresh, verbosity, _str(algorithm), _str(options))
    range_begin[0] = lo
    range_end[0] = hi


@ffi.def_extern()
def IterativeSolverOptimizeInitialize(n, range_begin, range_end, thresh, thresh_value,
                                      verbosity, minimize, fname, fcomm, algorithm, options):
    lo, hi = _api().IterativeSolverOptimizeInitialize(
        n, thresh, thresh_value, verbosity, bool(minimize), _str(algorithm), _str(options))
    range_begin[0] = lo
    range_end[0] = hi


@ffi.def_extern()
def IterativeSolverFinalize():
    _api().IterativeSolverFinalize()


@ffi.def_extern()
def IterativeSolverAddVector(buffer_size, parameters, action, sync):
    n = _dim()
    p = _buf(parameters, int(buffer_size) * n)
    a = _buf(action, int(buffer_size) * n)
    nwork = _api().IterativeSolverAddVector(buffer_size, p, a, sync)
    return max(int(nwork), 0)


@ffi.def_extern()
def IterativeSolverSolution(nroot, roots, parameters, action, sync):
    n = _dim()
    roots_arr = np.frombuffer(ffi.buffer(roots, int(nroot) * 4), dtype=np.int32)
    p = _buf(parameters, int(nroot) * n)
    a = _buf(action, int(nroot) * n)
    _api().IterativeSolverSolution(nroot, roots_arr, p, a, sync)


@ffi.def_extern()
def IterativeSolverAddValue(value, parameters, action, sync):
    n = _dim()
    p = _buf(parameters, n)
    a = _buf(action, n)
    nwork = _api().IterativeSolverAddValue(value, p, a, sync)
    return max(int(nwork), 0)


@ffi.def_extern()
def IterativeSolverEndIteration(buffer_size, solution, residual, sync):
    n = _dim()
    p = _buf(solution, int(buffer_size) * n)
    a = _buf(residual, int(buffer_size) * n)
    nwork = _api().IterativeSolverEndIteration(buffer_size, p, a, sync)
    return max(int(nwork), 0)


@ffi.def_extern()
def IterativeSolverEndIterationNeeded():
    return _api().IterativeSolverEndIterationNeeded()


@ffi.def_extern()
def IterativeSolverAddP(buffer_size, nP, offsets, indices, coefficients, pp,
                        parameters, action, sync, func):
    """P-space installation with the caller's action callback — the
    Fortran/C trampoline of the reference (apply_on_p_c,
    IterativeSolverCMPI.cpp:143-160): func(pcoeffs_flat, action_rows,
    update_size, ranges) ADDS the P action into contiguous row buffers."""
    n = _dim()
    nP = int(nP)
    offs = np.frombuffer(ffi.buffer(offsets, (nP + 1) * 8), dtype=np.uint64)
    nidx = int(offs[nP])
    idx = np.frombuffer(ffi.buffer(indices, max(nidx, 1) * 8), dtype=np.uint64)
    coeffs = np.frombuffer(ffi.buffer(coefficients, max(nidx, 1) * 8), dtype=np.float64)
    pp_arr = _buf(pp, nP * nP).copy()
    p = _buf(parameters, int(buffer_size) * n)
    a = _buf(action, int(buffer_size) * n)

    def apply_p(pcoeff, pvecs):
        m = pcoeff.shape[0]
        out = np.zeros((m, n), dtype=np.float64)
        ranges = np.zeros(2 * m, dtype=np.uint64)
        ranges[1::2] = n
        flat = np.ascontiguousarray(np.asarray(pcoeff, dtype=np.float64)).reshape(-1)
        func(
            ffi.cast("const double*", ffi.from_buffer(flat)),
            ffi.cast("double*", ffi.from_buffer(out)),
            m,
            ffi.cast("const size_t*", ffi.from_buffer(ranges)),
        )
        return out

    nwork = _api().IterativeSolverAddP(
        buffer_size, nP, offs, idx, coeffs, pp_arr, p, a, sync, func=apply_p
    )
    return max(int(nwork), 0)


@ffi.def_extern()
def IterativeSolverSuggestP(solution, residual, maximum_number, threshold, indices):
    n = _dim()
    nroot = _nroot()
    sol = _buf(solution, nroot * n)
    res = _buf(residual, nroot * n)
    mx = max(int(maximum_number), 1)
    idx = np.frombuffer(ffi.buffer(indices, mx * 8), dtype=np.uint64)
    cnt = _api().IterativeSolverSuggestP(sol, res, maximum_number, threshold, idx)
    return int(cnt)


@ffi.def_extern()
def IterativeSolverErrors(errors):
    out = _buf(errors, _nroot())
    _api().IterativeSolverErrors(out)


@ffi.def_extern()
def IterativeSolverEigenvalues(eigenvalues):
    out = _buf(eigenvalues, _nroot())
    _api().IterativeSolverEigenvalues(out)


@ffi.def_extern()
def IterativeSolverWorkingSetEigenvalues(eigenvalues):
    out = _buf(eigenvalues, _nroot())
    _api().IterativeSolverWorkingSetEigenvalues(out)


@ffi.def_extern()
def IterativeSolverPrintStatistics():
    _api().IterativeSolverPrintStatistics()


@ffi.def_extern()
def IterativeSolverNonLinear():
    return _api().IterativeSolverNonLinear()


@ffi.def_extern()
def IterativeSolverHasValues():
    return _api().IterativeSolverHasValues()


@ffi.def_extern()
def IterativeSolverHasEigenvalues():
    return _api().IterativeSolverHasEigenvalues()


@ffi.def_extern()
def IterativeSolverSetDiagonals(diagonals):
    _api().IterativeSolverSetDiagonals(_buf(diagonals, _dim()))


@ffi.def_extern()
def IterativeSolverDiagonals(diagonals):
    _api().IterativeSolverDiagonals(_buf(diagonals, _dim()))


@ffi.def_extern()
def IterativeSolverValue():
    return _api().IterativeSolverValue()


@ffi.def_extern()
def IterativeSolverVerbosity():
    return _api().IterativeSolverVerbosity()


@ffi.def_extern()
def IterativeSolverMaxIter():
    return _api().IterativeSolverMaxIter()


@ffi.def_extern()
def IterativeSolverSetMaxIter(max_iter):
    _api().IterativeSolverSetMaxIter(max_iter)


@ffi.def_extern()
def IterativeSolver_mpicomm_global():
    return 0


@ffi.def_extern()
def IterativeSolver_mpicomm_self():
    return 0
'''


def build(outdir: str = os.path.join("build", "torch_c")) -> str:
    """Compile the library into ``outdir``; returns its path."""
    import cffi

    ffibuilder = cffi.FFI()
    ffibuilder.embedding_api(DECLS)
    ffibuilder.set_source("iterative_solver_torch_c",
                          "#include <stddef.h>\n#include <stdint.h>\n")
    ffibuilder.embedding_init_code(INIT_CODE)
    os.makedirs(outdir, exist_ok=True)
    return ffibuilder.compile(tmpdir=outdir, target="libiterative_solver_torch_c.*",
                              verbose=False)


if __name__ == "__main__":
    print(build(*sys.argv[1:2]))
