"""Generic iteration engine shared by the parity solver families (port of
iterative_solver_tpu/solvers/core.py).

The counterpart of IterativeSolverTemplate (reference:
src/molpro/linalg/itsolv/IterativeSolverTemplate.h:126-600). Control flow
and the tiny subspace matrices live on the host; every O(N) operation —
overlap construction (add_vector), solution reconstruction (solution), error
norms — is a device call through the XSpace basis stores.

Interface style is functional: ``add_vector`` / ``end_iteration`` take and
return ``(m, N)`` row-blocks instead of mutating VecRef views.

``device=None`` is the CUDA device and raises where CUDA is absent; pass
``device="cpu"`` for the host (the tests do). ``dtype=None`` is float32 on
CUDA and float64 on the CPU. ``offload=`` moves the basis history to the
host/disk spill tier (array/offload_store.py).

``sharding=`` (parallel/mesh.py, ``block_sharding(mesh)``) runs every
family one process per shard of the vector axis (SPMD): the basis stores
(the device ``BasisStore`` or an ``offload=`` store) hold each rank's
slice, every overlap, dot and norm over N is all-reduced, the caller's
blocks and the problem's vectors are each rank's slices (a global numpy
block is cut to the rank's slice), and the host's subspace work sees the
same all-reduced numbers on every rank. A nonlinear family's
``Problem.residual`` then takes the rank's slice and returns the GLOBAL
value with the rank's slice of the residual.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..array import vector_ops as vops
from ..array.basis_store import _host
from ..parallel.collectives import psum
from ..parallel.mesh import check_sharding
from ..problem import Problem
from ..subspace.xspace import XSpace
from ..utils import Logger, Profiler, Statistics, null_profiler

Tensor = torch.Tensor

def _rows(x) -> Tensor:
    """``x`` as a 2-D row block (a vector becomes one row)."""
    return x if x.dim() >= 2 else x.unsqueeze(0)


def select_working_set(
    nw: int,
    errors: Sequence[float],
    threshold: float,
    value_errors: Sequence[float] = (),
    value_threshold: float = np.inf,
) -> List[int]:
    """Indices of the <=nw roots with largest error above threshold, ascending.

    (IterativeSolverTemplate.h:105-117.)
    """
    candidates = [
        (errors[i], i)
        for i in range(len(errors))
        if errors[i] > threshold or (i < len(value_errors) and value_errors[i] > value_threshold)
    ]
    candidates.sort(key=lambda t: (-t[0], t[1]))
    working = sorted(i for _, i in candidates[:nw])
    return working


class Verbosity:
    NONE = 0
    SUMMARY = 1
    ITERATION = 2
    DETAILED = 3


class IterativeSolverTemplate:
    nonlinear: bool = False
    linear_eigensystem: bool = False

    def __init__(
        self,
        n: int,
        nroots: int = 1,
        dtype=None,
        sharding=None,
        capacity: Optional[int] = None,
        logger: Optional[Logger] = None,
        profiler: Optional[Profiler] = None,
        offload=False,
        device=None,
    ):
        self.sharding = check_sharding(sharding)
        self.device = (self.sharding.mesh.device if self.sharding is not None
                       else config.resolve_device(device))
        if dtype is None:
            dtype = config.default_dtype(self.device)
        self.n = int(n)
        self.dtype = dtype
        self.logger = logger or Logger()
        if profiler is None:
            # ambient PROFILER_DEPTH enables region timing, PROFILER_OUTPUT
            # dumps the tree at teardown (molpro::Options parity,
            # IterativeSolverTemplate.h:485-501)
            depth = int(config.get_option("PROFILER_DEPTH"))
            profiler = Profiler(max_depth=depth) if depth > 0 else null_profiler()
        self.profiler = profiler
        self.stats = Statistics()
        cap = capacity if capacity is not None else max(16, 4 * nroots)
        store_factory = None
        if offload:
            # host/disk spill tier for basis histories beyond device memory:
            # True -> host-f64 OffloadBasisStore (parity numerics);
            # "streamed" -> StreamedOffloadStore (block numerics streamed
            # through the device, the BufferManager analogue);
            # a callable -> the factory itself, called as BasisStore is
            from ..array.offload_store import OffloadBasisStore, StreamedOffloadStore

            if callable(offload):
                store_factory = offload
            elif offload == "streamed":
                store_factory = StreamedOffloadStore
            else:
                store_factory = OffloadBasisStore
        self.xspace = XSpace(
            n, dtype, self.sharding, capacity=cap, logger=self.logger, stats=self.stats,
            store_factory=store_factory, device=self.device,
        )
        self.subspace_solver = None  # set by concrete solver
        self.errors: List[float] = []
        self.value_errors: List[float] = []
        self.working_set: List[int] = list(range(nroots))
        self.nroots = nroots
        self.convergence_threshold = 1.0e-8
        self.convergence_threshold_value = np.finfo(np.float64).max
        self.verbosity = Verbosity.ITERATION
        self.max_iter = 100
        self.max_p = 0
        self.p_threshold = np.finfo(np.float64).max
        self.apply_p: Optional[Callable] = None
        self.normalise_solution = False
        self._end_iteration_needed = True

    def __del__(self):
        profiler = getattr(self, "profiler", None)
        if profiler is None or profiler.max_depth <= 0:
            return
        try:
            out = config.get_option("PROFILER_OUTPUT")
            if out:
                with open(out, "w") as f:
                    f.write(profiler.report() + "\n")
            dot = config.get_option("PROFILER_DOTGRAPH", "")
            if dot:
                thresh = float(config.get_option("PROFILER_THRESHOLD", 0.01))
                with open(dot, "w") as f:
                    f.write(profiler.dotgraph(thresh) + "\n")
        except OSError:  # teardown must not raise; the profile is optional
            pass

    # ------------------------------------------------------------------
    def set_n_roots(self, nroots: int) -> None:
        self.nroots = nroots
        self.working_set = list(range(nroots))

    def n_roots(self) -> int:
        return self.nroots

    @property
    def end_iteration_needed(self) -> bool:
        return self._end_iteration_needed

    def eigenvalues(self):
        return np.asarray(self.subspace_solver.eigenvalues)

    def working_set_eigenvalues(self) -> np.ndarray:
        ev = self.subspace_solver.eigenvalues
        return np.asarray([ev[i] for i in self.working_set])

    def dimensions(self):
        return self.xspace.dimensions

    @property
    def value(self) -> float:
        if self.xspace.value.size:
            return float(self.xspace.value[0, 0])
        return float("nan")

    # ------------------------------------------------------------------
    def add_vector(self, parameters: Tensor, actions: Tensor, value: Optional[float] = None):
        """Update the Q space from working-set rows, re-solve the subspace and
        return ``(nwork, parameters, actions)`` with the new working set's
        solutions/residuals in the leading rows.

        (IterativeSolverTemplate.h:140-166.)
        """
        with self.profiler.push("add_vector"):
            parameters = _rows(parameters)
            actions = _rows(actions)
            if self.xspace.dimensions.nP != 0 and self.apply_p is None:
                raise RuntimeError("Solver contains P space but no valid apply_p function")
            nW = min(len(self.working_set), parameters.shape[0])
            self.stats.r_creations += nW
            with self.profiler.push("update_qspace"):
                self.xspace.update_qspace(parameters[:nW], actions[:nW])
            nwork, parameters, actions = self._solve_and_generate_working_set(parameters, actions)
            self._end_iteration_needed = True
            return nwork, parameters, actions

    def add_p(
        self,
        pvectors,
        pp_action_matrix,
        parameters: Tensor,
        actions: Tensor,
        apply_p: Callable,
    ):
        """Install a P space on an empty subspace (IterativeSolverTemplate.h:177-188)."""
        if len(pvectors) and len(pvectors) < self.nroots:
            raise RuntimeError("P space must be empty or at least as large as number of roots sought")
        if apply_p is not None:
            self.apply_p = apply_p
        self.xspace.update_pspace(pvectors, pp_action_matrix)
        return self._solve_and_generate_working_set(parameters, actions)

    # ------------------------------------------------------------------
    def solution(self, roots: Sequence[int]) -> Tuple[Tensor, Tensor]:
        """Reconstruct full-space solutions and residuals for ``roots``.

        (IterativeSolverTemplate.h:191-215 + construct_solution at :33-65.)
        """
        params = self._construct_solution_params(roots)
        residual = self._construct_residual_actions(roots)
        if self.normalise_solution:
            norms = _host(vops.norms_rows(params, self.sharding))
            scale = np.where(norms > 1e-14, 1.0 / np.where(norms > 1e-14, norms, 1.0), 1.0)
            scale_dev = vops.to_device(scale, self.dtype, self.device)
            params = vops.scale_rows(scale_dev, params)
            residual = vops.scale_rows(scale_dev, residual)
        if self.apply_p is not None and self.xspace.dimensions.nP:
            sol = self.subspace_solver.solutions
            dims = self.xspace.dimensions
            pcoeff = sol[np.asarray(list(roots)), dims.oP : dims.oP + dims.nP]
            residual = residual + self.apply_p(pcoeff, self.xspace.p_sparse)
        residual = self.construct_residual(list(roots), params, residual)
        return params, residual

    def solution_params(self, roots: Sequence[int]) -> Tensor:
        return self._construct_solution_params(roots)

    def suggest_p(self, solution: Tensor, residual: Tensor, max_number: int, threshold: float):
        """Suggest P-space indices by largest |solution_i * residual_i|
        contributions above threshold. (The reference declares this interface
        but leaves it unimplemented, IterativeSolverTemplate.h:458-461; the
        natural device implementation is a top-k over the contribution
        vector — the same rule its select_max_dot handler encodes.)"""
        solution = _rows(solution)
        residual = _rows(residual)
        contrib = torch.amax(torch.abs(solution * residual), dim=0)
        if self.sharding is not None:
            contrib = self.sharding.gather(contrib, self.n)
        k = min(max_number, self.n)
        vals, idx = torch.topk(contrib, k)
        vals = _host(vals)
        idx = _host(idx)
        return [int(i) for i, v in zip(idx, vals) if v > threshold]

    def _construct_solution_params(self, roots: Sequence[int]) -> Tensor:
        sol = self.subspace_solver.solutions
        dims = self.xspace.dimensions
        roots = np.asarray(list(roots), dtype=int)
        coeff_v = np.concatenate(
            [
                sol[roots, dims.oP : dims.oP + dims.nP],
                sol[roots, dims.oQ : dims.oQ + dims.nQ],
                sol[roots, dims.oD : dims.oD + dims.nD],
            ],
            axis=1,
        )
        slots_v = (
            list(self.xspace.p_slots)
            + [s[0] for s in self.xspace.q_slots]
            + [s[0] for s in self.xspace.d_slots]
        )
        self.stats.gemm_outer_ops += 1
        return self.xspace.store_v.combine(coeff_v, slots_v)

    def _construct_residual_actions(self, roots: Sequence[int]) -> Tensor:
        sol = self.subspace_solver.solutions
        dims = self.xspace.dimensions
        roots = np.asarray(list(roots), dtype=int)
        coeff_a = np.concatenate(
            [
                sol[roots, dims.oQ : dims.oQ + dims.nQ],
                sol[roots, dims.oD : dims.oD + dims.nD],
            ],
            axis=1,
        )
        slots_a = [s[1] for s in self.xspace.q_slots] + [s[1] for s in self.xspace.d_slots]
        self.stats.gemm_outer_ops += 1
        return self.xspace.store_a.combine(coeff_a, slots_a)

    # -- solver-specific hooks ------------------------------------------
    def construct_residual(self, roots: List[int], params: Tensor, actions: Tensor) -> Tensor:
        """Turn reconstructed actions into residuals (solver specific)."""
        raise NotImplementedError

    def set_value_errors(self) -> None:
        self.value_errors = []

    def end_iteration(self, parameters: Tensor, actions: Tensor):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _solve_and_generate_working_set(self, parameters: Tensor, actions: Tensor):
        """(IterativeSolverTemplate.h:518-563. When all nsol solutions fit the
        caller's working buffer they are reconstructed in one device pass;
        otherwise the bounded-memory batched path below mirrors the
        reference's parameter_batches + temp-Q construction.)"""
        with self.profiler.push("subspace_solve"):
            self.subspace_solver.solve(self.xspace, self.n_roots())
        nsol = self.subspace_solver.size
        nrows_buf = int(parameters.shape[0])
        if nsol > nrows_buf and nrows_buf > 0:
            return self._solve_working_set_batched(parameters, actions, nsol,
                                                   nrows_buf)
        roots = list(range(nsol))
        with self.profiler.push("construct_solutions"):
            sol_params, sol_residuals = self.solution(roots)
            errors = _host(vops.norms_rows(sol_residuals, self.sharding)).astype(float)
        self.subspace_solver.set_errors(roots, errors)
        self.set_value_errors()
        self.errors = list(self.subspace_solver.errors)
        nrows = parameters.shape[0]
        self.working_set = select_working_set(
            nrows,
            self.errors,
            self.convergence_threshold,
            self.value_errors,
            self.convergence_threshold_value,
        )
        # Mirror the reference's row layout: solution() writes ALL
        # reconstructed solutions/residuals into the leading R rows
        # (IterativeSolverTemplate.h:526-534), then the working-set pass only
        # moves root solutions up (:536-556). Rows beyond the working set keep
        # the reconstruction of their own root index.
        k = min(nsol, nrows)
        row_roots = list(range(k))
        for i, root in enumerate(self.working_set):
            if i < k:
                row_roots[i] = root
        if k:
            idx = torch.as_tensor(row_roots, dtype=torch.long, device=sol_params.device)
            parameters = torch.cat([sol_params[idx], parameters[k:]], dim=0)
            actions = torch.cat([sol_residuals[idx], actions[k:]], dim=0)
        return len(self.working_set), parameters, actions

    def _solve_working_set_batched(self, parameters: Tensor, actions: Tensor,
                                   nsol: int, nrows: int):
        """Bounded-memory solution construction: more subspace solutions than
        working-buffer rows (nsol > nrows).

        Mirrors the reference's batching exactly
        (IterativeSolverTemplate.h:21-31 ``parameter_batches``, :526-556):
        solutions are reconstructed ``nrows`` at a time — never more than the
        caller's working buffer lives in device memory — and every batch is
        copied to a temporary Q-tier store (the native disk-backed VecStore,
        the analogue of the reference's ``handlers.qr().copy`` temp Q
        vectors, counted in ``stats.q_creations`` like the reference's
        ``m_stats->q_creations += 2*roots.size()``). After the working set is
        selected from the full error list, its rows are fetched back into
        the leading rows of the caller's buffers.
        """
        from ..native.vecstore import VecStore

        temp = VecStore(2 * nsol, int(parameters.shape[-1]))
        try:
            errors = np.zeros(nsol)
            slot_pairs = []
            with self.profiler.push("construct_solutions_batched"):
                for start in range(0, nsol, nrows):
                    roots_b = list(range(start, min(start + nrows, nsol)))
                    p_b, r_b = self.solution(roots_b)
                    errors[start : start + len(roots_b)] = _host(
                        vops.norms_rows(r_b, self.sharding))
                    p_host = _host(p_b.to(torch.float64))
                    r_host = _host(r_b.to(torch.float64))
                    for i in range(len(roots_b)):
                        slot_pairs.append(
                            (temp.append(p_host[i]), temp.append(r_host[i])))
                    self.stats.q_creations += 2 * len(roots_b)
            self.subspace_solver.set_errors(list(range(nsol)), errors)
            self.set_value_errors()
            self.errors = list(self.subspace_solver.errors)
            self.working_set = select_working_set(
                nrows,
                self.errors,
                self.convergence_threshold,
                self.value_errors,
                self.convergence_threshold_value,
            )
            # same row contract as the one-pass path: the leading
            # min(nsol, nrows) rows hold root reconstructions (their own
            # index, overridden by working-set roots) — NOT only the
            # working set. At convergence the working set is EMPTY and a
            # working-set-only copy-back would leave the caller's buffer
            # holding the previous iteration's preconditioned directions
            # while reporting converged=True (confirmed: returned rows had
            # overlap 0.0 with the eigenvectors).
            k_rows = min(nsol, nrows)
            row_roots = list(range(k_rows))
            for i, root in enumerate(self.working_set):
                if i < k_rows:
                    row_roots[i] = root
            if k_rows:
                sel_p = np.stack(
                    [temp.get(slot_pairs[root][0]) for root in row_roots])
                sel_r = np.stack(
                    [temp.get(slot_pairs[root][1]) for root in row_roots])
                dev_p = vops.to_device(sel_p, self.dtype, self.device)
                dev_r = vops.to_device(sel_r, self.dtype, self.device)
                parameters = torch.cat([dev_p, parameters[k_rows:]], dim=0)
                actions = torch.cat([dev_r, actions[k_rows:]], dim=0)
        finally:
            temp.close()
        return len(self.working_set), parameters, actions

    def _block(self, x) -> Tensor:
        """A caller's (rows, N) block (numpy or tensor) on the solver's
        device; under sharding a global block is cut to this rank's slice."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float64)
        return _rows(self._vector(x))

    def _vector(self, x) -> Tensor:
        """``x`` (..., N) on the solver's device: under sharding a global
        array is cut to this rank's slice and a slice is kept as it is."""
        if self.sharding is not None and np.shape(x)[-1] == self.n:
            return vops.to_device(x, self.dtype, sharding=self.sharding)
        return vops.to_device(x, self.dtype, self.device)

    def _global_smallest(self, diagonals: Tensor, k: int):
        """Indices and values of the k smallest diagonal entries over the
        whole vector (the diagonal gathered under sharding)."""
        if self.sharding is not None:
            diagonals = self.sharding.gather(diagonals, self.n)
        return vops.select_smallest(diagonals, k)

    # ------------------------------------------------------------------
    def report(self, iteration: Optional[int] = None) -> None:
        it = self.stats.iterations if iteration is None else iteration
        msg = f"iteration {it}"
        if self.errors:
            imax = int(np.argmax(self.errors))
            label = f"|residual[{imax}]|" if self.n_roots() > 1 else "|residual|"
            msg += f", {label} = {self.errors[imax]:e}"
        print(msg)

    # ------------------------------------------------------------------
    def solve(
        self,
        parameters,
        actions=None,
        problem: Optional[Problem] = None,
        generate_initial_guess: bool = False,
        max_iter: Optional[int] = None,
    ):
        """One-call driver (IterativeSolverTemplate.h:322-408).

        ``parameters``/``actions`` are (nwork_rows, N) initial blocks (numpy or
        tensors); returns ``(converged, parameters, actions)`` with tensors on
        the solver's device.
        """
        if problem is None:
            raise ValueError("problem must be provided")
        parameters = self._block(parameters)
        if actions is None:
            actions = torch.zeros_like(parameters)
        else:
            actions = self._block(actions)
        if max_iter is not None:
            self.max_iter = max_iter
        diagonals = problem.diagonals()
        use_diagonals = diagonals is not None
        if use_diagonals:
            diagonals = self._vector(diagonals)

        if generate_initial_guess:
            if self.linear_eigensystem:
                if not use_diagonals:
                    raise RuntimeError("Default initial guess requested, but diagonal elements are not available")
                idx, _ = self._global_smallest(diagonals, min(parameters.shape[0], self.n))
                guess = np.zeros((parameters.shape[0], self.n))
                for row, i in enumerate(_host(idx)):
                    guess[row, int(i)] = 1.0
                if self.verbosity >= Verbosity.SUMMARY:
                    print("Initial guess generated from diagonal elements")
            else:
                # LinearEquations: unit vectors e_i per root, as in the
                # reference Python driver (iterative_solver_extension.pyx:126)
                guess = np.zeros((parameters.shape[0], self.n))
                for row in range(parameters.shape[0]):
                    guess[row, row % self.n] = 1.0
            parameters = self._vector(guess)

        nwork = parameters.shape[0]
        pspace = []
        if use_diagonals and self.max_p > 0:
            nwork, parameters, actions, pspace = self._auto_pspace(
                problem, diagonals, parameters, actions
            )

        for it in range(self.max_iter):
            if nwork <= 0:
                break
            value = None
            if self.nonlinear:
                value, res = problem.residual(parameters[0])
                actions = torch.cat([res[None, :], actions[1:]], dim=0)
                nwork, parameters, actions = self.add_vector(parameters, actions, value)
            elif it > 0 or not pspace:
                with self.profiler.push("problem.action"):
                    act = problem.action(parameters[:nwork])
                actions = torch.cat([act, actions[nwork:]], dim=0) if nwork < actions.shape[0] else act
                nwork, parameters, actions = self.add_vector(parameters, actions)
            while self.end_iteration_needed:
                if nwork > 0:
                    shifts = (
                        self.working_set_eigenvalues()
                        if self.linear_eigensystem
                        else np.zeros(nwork)
                    )
                    with self.profiler.push("precondition"):
                        prec = problem.precondition(
                            actions[:nwork], shifts[:nwork], diagonals if use_diagonals else None
                        )
                    actions = (
                        torch.cat([prec, actions[nwork:]], dim=0)
                        if nwork < actions.shape[0]
                        else prec
                    )
                nwork, parameters, actions = self.end_iteration(parameters, actions)
            if self.verbosity >= Verbosity.ITERATION:
                self.report()
        if self.verbosity == Verbosity.SUMMARY:
            self.report()
        converged = nwork == 0 and max(self.errors) <= self.convergence_threshold
        if self.verbosity >= Verbosity.SUMMARY and not converged:
            print(f"Solver has not converged to threshold {self.convergence_threshold}")
        return converged, parameters, actions

    def _auto_pspace(self, problem: Problem, diagonals: Tensor, parameters: Tensor, actions: Tensor):
        """Automatic P-space selection from smallest diagonals
        (IterativeSolverTemplate.h:353-376)."""
        idx, vals = self._global_smallest(diagonals, min(self.max_p, self.n))
        idx = _host(idx)
        vals = _host(vals).astype(float)
        keep = [0] if len(idx) else []
        for i in range(1, len(idx)):
            if vals[i] > vals[0] + self.p_threshold:
                break
            keep.append(i)
        pspace = [{int(idx[i]): 1.0} for i in keep]
        if self.verbosity >= Verbosity.SUMMARY and pspace:
            print(f"{len(pspace)}-dimensional P space selected")

        def apply_on_p(pcoeff: np.ndarray, pvectors) -> Tensor:
            return problem.p_action(pcoeff, pvectors)

        action_matrix = problem.pp_action_matrix(pspace)
        nwork, parameters, actions = self.add_p(pspace, action_matrix, parameters, actions, apply_on_p)
        return nwork, parameters, actions, pspace

    # ------------------------------------------------------------------
    def test_problem(self, problem: Problem, verbosity: int = 0, threshold: float = 1e-5) -> bool:
        """Numerical consistency check of the user's problem definition
        (IterativeSolverTemplate.h:420-474)."""
        success = True
        if self.nonlinear:
            v0 = problem.test_parameters(0)
            if v0 is None:
                return True
            v0 = self._vector(v0)
            value0, res0 = problem.residual(v0)
            parameters0, residual0 = v0, res0
            instance = 1
            while True:
                v1 = problem.test_parameters(instance)
                if v1 is None:
                    break
                v1 = self._vector(v1)
                value1, res1 = problem.residual(v1)
                mean_res = 0.5 * (res1 + residual0)
                step = v1 - parameters0
                dv_analytic = float(psum(torch.dot(mean_res, step), self.sharding))
                ok = abs(dv_analytic - (value1 - value0)) < threshold
                success = success and ok
                if verbosity > 0 or not ok:
                    print(f"{{actual, extrapolated}} value change: {{{value1 - value0}, {dv_analytic}}}")
                instance += 1
        else:
            instance = 0
            while True:
                v0 = problem.test_parameters(instance)
                if v0 is None:
                    break
                v0 = self._block(v0)
                a0 = problem.action(v0)
                norm2_residual = float(torch.sqrt(psum(torch.sum(a0 * a0), self.sharding)))
                scale = 10.0
                a1 = problem.action(v0 * scale)
                defect = a1 - scale * a0
                norm2 = float(torch.sqrt(psum(torch.sum(defect * defect), self.sharding)))
                ok = abs(norm2 / norm2_residual) < threshold
                success = success and ok
                if verbosity > 0 or not ok:
                    print(f"Length of residual: {norm2_residual}, scaling defect: {norm2}")
                instance += 1
        return success
