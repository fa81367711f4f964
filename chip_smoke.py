#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py    # build, check, solve, profile; a few minutes

It drives the port's main path, ``FusedDavidson.from_dense_symmetric`` then
``run_on_device``, at the size of bench.py's headline leg: a dense symmetric
8192 x 8192 operator (the bench matrix: spectrum linspace(-2, 3, 32) and
linspace(6, 50, N-32), couplings 0.05/sqrt(N), ``default_rng(0)``), 16
roots, a 64-row basis; and ``FusedPPCG`` at bench.py's flagship leg: 64
roots of a packed int8 operator of n = 32768 generated directly
(``synthetic_packed_int8(32768, b=1024, seed=0)``). It imports nothing of
JAX or of the JAX package.

Phases, one JSON line each:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. the build of every kernel from ``iterative_solver_torch/ops/kernels/csrc``
   with nvcc for sm_90a, all sources compiled in parallel;
   Then the SASS of the K1/K3 and the K4/K5 libraries (cuobjdump): their
   tensor-core (HMMA, IMMA), ldmatrix, byte-permute, cp.async and
   reduction instructions, counted;
3. every kernel against its plain PyTorch version on the same inputs on the
   card, at the main path's shapes. K1 (bf16 and f32 tiles), K2 and K3 at
   x 16 x 8192 (K2 with a 64-row basis), and K1/K3 again at 16 x 32768 on
   operators generated on the card (``packed_on_card``: bf16 at b = 1024,
   f32 and split at b = 512), tolerance 1e-5 of the plain
   result's max magnitude: K1, K3 and K2 add their partial sums in fixed
   orders of their own, other than the plain version's, so each is also
   held to the same bits on a second call (K1 and K3 at 16, 4 and 1 rows
   of x; K2 also to 1e-5 of float64). Library yardsticks: one ``torch.matmul``
   on the dense matrix the tiles imply (bf16, or f32 with TF32 off), and
   for K3 one bf16 product of [xh xh xl] with [A_hi; A_lo; A_hi], the same
   three products in one call. K4 at 16 x 8192 and at 64 x 32768 (the
   flagship operator) and K5 at 16 x 8192, tolerance 0: they add integer
   partial sums and round the epilogue in the plain version's order, so y
   must be bit-identical; K4's and K5's rows also count their reds per
   call (``flush_atomics``) and the int32 sums they carry (``flush_sums``),
   and their ``torch._int_mm`` yardstick (one call per int8 product against
   the dense int8 plane the tiles imply, column-major as cuBLASLt's int8
   path takes it, and row-major beside it; each equal to the plain
   accumulator bit for bit) reads its device ms too. K8 (PPCG's per-root
   3x3 RR) at 64 x 131072, all directions live and every p dead: given its
   own dots, coefficients and blocks to the eager chain's bits; the dots
   within float32 rounding of float64 and the same bits on a second call.
   Times from CUDA events, kernel and plain timed in turns (plain, kernel,
   kernel, plain);
4. the headline solve: tier "fast", rr "window", fused chain, tol 2e-4;
5. the "precise" solve: rr "full", tol 1e-5 (bench.py's precise leg);
6. the "exact" solve, same settings as 5, which drives K1's f32 tiles;
7. the "int8" solve (bench.py's turbo_int8 leg): rr "window", tol 5e-3;
8. the "int8_precise" solve (bench.py's int8_precise leg): rr "anchored",
   anchor_every 2, tol 1e-5;
9. the PPCG flagship: n = 32768, 64 roots, rr_every 8, tol 5e-3, max_iter
   400, the one-hot guess on the 64 lowest diagonal entries, and a
   torch.profiler breakdown of one more such solve;
10. the same flagship at tol 1e-3, which takes more than rr_every
    iterations, so the periodic full Rayleigh-Ritz and its re-anchoring
    action run at this size too;
11. a torch.profiler breakdown of one more headline solve: device time by
    kernel family and the device's idle share;
12. the block-sparse kernels against their plain versions: K6 (the BSR
    action) on bench.py's sparse operator ``synthetic_fci_bsr(8192,
    block=128, density=0.3, seed=1)`` at 16 and 4 rows, and on the
    phenol-scale operator (benchmarks/phenol_scale.py's topology and int8
    values, n = 2^20, block 128, widened on the card to float32) at 16 rows;
    K7 (the masked Gram) at (64, 8192) and (64, 2^20) with 40 active rows.
    Tolerance 1e-5 of the plain result's max magnitude: both sum in their
    own fixed order, and a second call must give the same bits. Library
    yardsticks, in event and in profiler device ms: ``torch.sparse.mm`` on
    a ``sparse_bsr_tensor`` of the same operator (K6) and the bare
    ``v @ w.T`` (K7). Then K2 at the phenol solve's shape (16 rows, a 64-row
    basis, n = 2^20, the phenol diagonal), with its bound and its
    three-pass floor. Both K2 checks hold t, n0, n2 and g within 1e-5 of the
    plain version and of the plain version in float64 on the same inputs,
    and a second call to the same bits;
13. the sparse FusedDavidson at n = 8192 on the bench's sparse operator
    through the generic constructor with a K6 matvec (16 roots, m_max 64, rr
    "full", the fused chain, tol 1e-5): f64 residual <= 1e-4 against the
    dense matrix, the 4 lowest Rayleigh quotients within 1e-8 of
    REFERENCE_SPARSE_EIGENVALUES;
14. the parity entry point at n = 8192: ``create_linear_eigensystem(8192, 4,
    "Davidson", "convergence_threshold=1e-5")`` on a ``Problem`` whose
    action is K6, with the same limits; one K6 launch per iteration;
15. the phenol-scale sparse FusedDavidson (n = 2^20, 16 roots, m_max 64,
    the fused chain, tol PHENOL_TOL): the f64 residual against the stored
    operator widened to f64 on the card, max|X X^T - I|, and how far the
    sorted Rayleigh quotients lie from the 16 lowest diagonal entries (0.079
    apart, so a skipped root shows); host generation time, bytes on the
    card, steady seconds per iteration; and a torch.profiler breakdown of
    one more such solve.

16. after the headline profile (11), the slice of the linear systems:
    a. the P-space Davidson: tier "precise", rr "full", tol 1e-5, m_max 96,
       P the unit vectors of the 32 lowest diagonal entries with their
       exact f64 rows as ``p_actions``, the guess one-hot on the next 16;
       the limits of the precise solve, and the iteration count of the
       port's CPU run (PSPACE_ITERATIONS); K3 launches for init, probe,
       iterations and restarts, none for P;
    b. checkpoint and resume: the headline solve through ``run_fast``
       (sweeps of 3 steps), uninterrupted; one sweep checkpointed to an
       .npz in a temporary directory; ``resume_fast`` on a fresh solver:
       the same iteration count, Ritz values within 1e-6; a solver with 8
       roots must refuse the file. (The headline converges within its first
       sweep, so the resume returns the converged checkpoint; a resume that
       restarts and sweeps on is tests/test_torch_kernels_cuda.py's);
    c. the batched solve: examples/batched_scan.py's scan at 8 x n = 1024,
       3 roots, m_max 18, float32, tol 1e-5 (each element converged, its
       eigenvalues within 1e-5 of eigvalsh), its steady wall time beside 8
       sequential chunked solves';
    d. FusedLinearEquations on the bench matrix + 3 I (spectrum >= 1,
       condition number about 53) with 16 right-hand sides from
       default_rng(2), fused chain (K2 in raw mode), each tier at its
       tolerance (LINEAR_TOLS): converged, the f64 relative residual and
       the relative error against np.linalg.solve within LINEAR_LIMITS
       (from calibrate_linear_cpu.py), launches init + probe + iterations +
       restarts (K2: iterations); then a torch.profiler breakdown of one
       more "precise" linear solve;
    e. K2 in raw mode alone (16 rows, a 64-row basis, n = 8192, no
       diagonal), with K2's checks;
    f. refinement to 1e-8 (bench.py's precise_1e8 leg): the precise solve,
       then EigenpairRefiner (the f64 action on the card, the K3 matvec in
       the deflated CG): converged, f64 residual <= 1e-8, the 4 lowest
       eigenvalues within 1e-9; refine_on_host from the same vectors;
    g. after the parity eigen phase (14): ``create_linear_equations(8192, 4,
       "Davidson", "convergence_threshold=1e-5")`` on a Problem whose action
       is K6 on the sparse operator plus 3 I, 4 right-hand sides from
       default_rng(3): the f64 relative residual <= 1e-5, the iteration
       count and stats of the port's CPU run, one K6 launch per iteration.

17. after the linear profile (16d), the nonlinear families and the
    gradients, with K1-f32 (the "exact" tier, b = 512) in every matvec:
    a. ``solve_lbfgs``: FusedLBFGS minimising 1/2 xᵀ(A+3I)x − bᵀx (A the
       bench matrix, b the first of the linear right-hand sides), history
       10, gradient norm <= 3e-2, the gradient from torch.autograd through
       ``make_differentiable_symm_action``: K1 once forward and once as its
       own adjoint per evaluation (launches counted: two per evaluation);
       the f64 relative error against np.linalg.solve, the iteration count
       of the port's CPU float32 run within 2; a profile of one more solve;
    b. ``solve_fused_diis``: FusedDIIS on (A+3I)x + 0.05 x∘x − b, Jacobi on
       diag(A+3I), history 10, err <= 1e-4: the f64 relative residual
       recomputed on the host, the CPU iteration count within 2, one K1
       launch per residual;
    c. ``solve_parity_nonlinear``: create_optimize(8192, "BFGS",
       "max_size_qspace=6") and create_optimize(8192, "SD") on
       QuadraticOptimizeProblem(A+3I, np.linalg.solve(A+3I, b)), and
       create_nonlinear_equations(8192, "DIIS", "max_size_qspace=8") on
       TrigNonlinearProblem(8192), in float64 with dense torch.matmul: the
       CPU run's iterations and stats exactly, the quadratic solutions within
       1e-8 of np.linalg.solve;
    d. ``implicit_diff``: make_differentiable_eigenvalues on the bench
       matrix through the differentiable action (4 roots, m_max 24, tol
       1e-5): d(sum w lambda)/ds at s = 1 against sum w lambda, the tile
       gradient against the f64 outer-product tiles of the solver's own x;
       make_differentiable_eigenpairs for <x_0|M|x_0> (M diagonal,
       default_rng(7)): the response solve converged, the tile gradient
       against the same function with the plain action in float64 on the
       card.
    The K1-f32 check of phase 3 also holds the differentiable action's y,
    xbar and vbar at 16, 4 and 1 x 8192 (the rows the new phases launch K1
    at) against plain autograd through symm_matmat (1e-5) and times the
    adjoint launch at 1 x 8192 ("K1-f32-adjoint"). The limits and
    iteration counts come from ``calibrate_nonlinear_cpu.py``.

18. after the refinement (16f), the non-hermitian slice on bench.py's
    leg_nonsym operator (``nonsym_matrix``: n = 8192, couplings
    0.05/sqrt(n) from default_rng(7), diagonal linspace(-2, 0, 32) and
    linspace(2, 20, n - 32), the strict lower triangle scaled by 0.9), 16
    roots, m_max 64, max_iter 60, the one-hot guess on the 16 lowest
    diagonal entries, float32 (a dense f32 operator of 268 MB on the card):
    a. ``FusedNonSymDavidson.from_dense(tier="precise", rr="device")`` at
       tol 2e-4; b. the same with rr "host"; c. "int8_precise" (5e-4),
       "fast" and "int8" with rr "device", then the dense int8 actions
       (``torch._int_mm``, one and two planes) timed at 16 x 8192;
       g. phase a in chunks of 4 iterations, stopped after 8 with a
       checkpoint and resumed on a fresh solver: the same iteration count,
       Ritz values within 1e-6; h. a torch.profiler breakdown of one more
       phase-a solve; e. ``FusedNonSymLinearEquations.from_dense`` on the
       operator + 3 I with 16 right-hand sides from default_rng(2),
       "precise" and "int8_precise", each with rr "device" and "host": the
       f64 relative residual and the error against np.linalg.solve;
       f. ``make_batched_nonsym_lineq_solve`` with operand_axes=(None, 0)
       over 4 shifts of that operator with 2 right-hand sides, and
       ``make_batched_nonsym_solve`` over 8 systems at n = 1024
       (TestBatchedNonSym's generator), then ``finalize_nonsym_batch``;
       d. complex pairs at full width (``pair_matrix``: 6 roots, m_max 24,
       rr "device"): it must escalate to two refinement passes and give
       PAIR_REFERENCE_EIGENVALUES' pairs.
    Each eigen phase: converged, the f64 residual of each row on the card
    (a real root ||x Aᵀ − λ x||, a pair its 2 x 2 block on (x_p, x_q)), the
    eigenvalues against NONSYM_REFERENCE_EIGENVALUES (the JAX package in
    float64), the port's CPU float32 iteration count within 2 for the real
    spectra, and no kernel of the port launched (the dense path runs
    cuBLAS, cuSOLVER and ``torch._int_mm``). The limits come from
    ``calibrate_nonsym_cpu.py``.

19. after the non-hermitian slice, the spill and many-root slice:
    a. ``offload_stream``: the streamed offload store at n = 2^20 (256 rows
       of unit N(0, 1) rows made on the card in float64 = 2.15 GB in the
       store's file in tempfile.gettempdir(), or 128 where that directory
       is short, printed with the directory; blocks of 64 rows; 16 rows of
       x): pipelined and serial (prefetch=False) gram and combine in 3
       turns, the overlap factor (serial over pipelined wall; min, median,
       max), each stage alone (the reads into a pinned buffer in GB/s, the
       host cast to float32, the pinned H2D copy of a block in float64 and
       float32, the products on device-resident blocks in CUDA-event ms),
       the host f64 store's gram and its time; the error of the gram
       against it and of the combination against float64 on the card
       (OFFLOAD_GRAM_LIMIT, OFFLOAD_COMBINE_LIMIT), the same bits in every
       pipelined and serial call, pinned buffers;
    b. ``solve_banded``: BandedEigensolver for the 32 lowest roots of the
       bench matrix through the "exact" action (K1-f32), with device
       deflation (bands of 16, m_max 96, tol 5e-5) and streamed (bands of
       8, m_max 64, tol 1e-4, the store's blocks of 8 rows): the f64
       residual of each row, the f64 Rayleigh quotients against
       BANDED_REFERENCE_EIGENVALUES, max|X X^T - I|, every row locked,
       the streamed sweeps within BANDED_MAX_SWEEPS (each sweep's purged
       residuals in the record); then device deflation at m_max 64 and
       tol 1e-5, where a band restarts at its float32 floor: its quality
       reported, not held (ROADMAP Queue 3); launches in every case K1:
       init + iterations + restarts of each fused solve, and one f64 check
       per streamed sweep; K2: iterations;
    c. ``solve_chebyshev``: make_chebyshev_davidson (degree 4, m_max 64,
       rr "full") on the bench matrix (16 roots, tol 1e-3), then on a
       flat-diagonal operator (Q diag(w) Q^T at n = 8192, Q from the QR of
       a default_rng(9) Gaussian on the card in float64, 8 roots in [1, 2]
       and the rest in [3, 50]; tol 1e-4) beside the Jacobi FusedDavidson:
       the matvec identity nroots + iterations x nroots x degree, K1
       launches of the Lanczos bounds (12, at one row), the symmetry probe,
       the init, degree + 1 per iteration and one per restart; iterations
       against the CPU's, the f64 residual and Rayleigh quotients, and the
       wall to solution of each, first (with the bounds and the probe) and
       steady (a second solve of the same solver, its launches held and
       counted as well).
    And after the parity eigen phase (14), ``solve_offload_parity``: the
    same entry point through the default stores, offload=True and
    offload="streamed": the iteration count of the CPU run, the same limits,
    one K6 launch per iteration, the same eigenvalues in all three.
20. last, after the phenol solve (15), the distribution layer (ROADMAP
    Queue 1 item 6b; last because this process's profiler windows dropped
    device events after other processes had shared the card): SHARD_WORLD
    = 4 ranks, processes of this script
    (``--shard-worker``) on the one card, joined by gloo through a file
    store in a temporary directory (NCCL refuses two ranks on one card),
    every collective staged through pinned host memory; a failed rank
    fails the run. Each rank packs the bench matrix's five tiers on the
    host and keeps its round-robin share of the tile pairs
    (``ShardedSymmetric``).
    a. ``sharded_kernels``: each rank's K1-bf16, K1-f32, K3, K4 and K5 on
       its pairs at 16 x 8192, and K1-f32 at 1, 4 and 8 x 8192 (the rows
       the family phases give it), against its plain version (1e-5 of
       max|y|; K4 and K5 bit for bit) and to the same bits on a second
       call; the
       reduce-scattered y against the unsharded kernel's y (rank 0, 1e-5);
       each rank's device ms, one rank at a time, beside the unsharded
       kernel's; one sharded matvec's wall ms and its collectives (calls,
       bytes staged each way, host ms);
    b. ``solve_sharded[fast|exact|precise|int8|int8_precise]``:
       FusedDavidson's generic constructor with the tier's ShardedSymmetric
       matvec and ``sharding=``, the unsharded phase's settings and limits
       (converged, f64 residual, Rayleigh quotients; max|X X^T - I| <=
       SHARD_ORTHO_LIMIT), iterations within SHARD_ITER_SLACK of the
       unsharded card run, every rank the same bits of the eigenvalues,
       per-rank launches init + probe + iterations + restarts, K2 none;
    c. ``solve_sharded_ppcg``: the flagship (this process's, saved for the
       ranks) sharded with ``from_int8``, K4 per rank, the flagship's
       limits;
    d. ``solve_sharded_bsr``: bench.py's sparse operator by block rows
       (``ShardedBSR``, a plain body: no kernel, K6 none), the sparse
       phase's limits;
    the family phases (ROADMAP Queue 1 item 6c), on the same ranks, each
    at its unsharded phase's settings and limits, its seconds and staged
    collectives printed, every rank the same bits, iterations within
    SHARD_ITER_SLACK of the unsharded card run (or of the CPU's where the
    card has no unsharded twin), K2, K6 and K7 none:
       ``solve_sharded_lbfgs`` and ``solve_sharded_diis`` (17a, b: the
       gradient and the residual through the "exact" tier's sharded K1-f32
       action plus 3 I); ``refine_sharded`` (16f's input, the parent's
       precise solve, refined to 1e-8 with K3 on each rank's pairs in the
       deflated CG); ``solve_sharded_nonsym`` (18c's int8_precise device-RR
       solve, the planes' rows sharded by DenseInt8Split.shard, x gathered
       and quantized over its full rows); ``solve_sharded_banded`` (19b's
       device mode: 32 roots in bands of 16, m_max 96, tol 5e-5);
       ``solve_sharded_chebyshev`` (19c's flat operator, rank 0 building it);
       ``solve_sharded_parity[rspt|bfgs|diis]`` (the parity families in
       float32 with K1-f32: RSPT on the bench matrix, BFGS on the quadratic
       of A+3I, DIIS on (A+3I)x + 0.05 x∘x − b; SHARD_PARITY);
       ``offload_sharded[host|streamed]`` (the parity Davidson on the
       bench matrix through sharded offload stores);
    e. ``nccl_world1``: NCCL at world size 1 in this process: the exact
       solve with ``sharding=`` against the same solve unsharded without the
       chain, equal iterations, eigenvalues within 1e-6, nothing staged.
    The kernels line carries each kernel's per-rank launches on the
    sharded solves (``rank_launches``: K1-f32 and K3 with the family
    phases') and per-rank ms (``rank_ms``).
21. after the differentiable solves (17d), ``c_api``: the C ABI
    (bindings/c_api.py) in this process, driven as a C program drives it
    (Initialize, SetDiagonals, AddVector, EndIteration, Finalize) for the
    parity Davidson on the bench matrix, 4 roots, tol 1e-5, the solver in
    float64 on the card, each action K1-f32: the parity phase's limits,
    the CPU run's iterations within 2, one launch per AddVector; then the
    embedded library (bindings/build_embedded.py, cffi) built and
    examples/c/linear_eigensystem_c.c compiled against
    include/iterative_solver_c.h and run with the device unset (the card).

22. after the phenol solve (15) and before the sharded phases (20), the
    examples: every twin in examples_torch/ of an examples/*.py script,
    through its ``main(["--device", "cuda", ...])`` in this process
    (EXAMPLES: the kernel-bearing twins at n = 8192, packed_symmetric_davidson
    with tiles of 512 (K1-f32, K3, K2), refine_to_1e8 on the split action
    (K3 in the solve and the refiner's CG, K2), quantized_screening (K4,
    K5 and K5 in the refiner's CG, K2), hybrid_precision (K2); the batched
    scan at 8 x 1024; the rest at their examples' sizes, the distributed
    twin on its own 2 gloo ranks), each printing one record with its
    seconds: its own assertions, its iteration counts against the CPU run's
    at the same arguments (EXAMPLE_CPU_ITERATIONS, from
    calibrate_examples_cpu.py: equal in float64, within 2 in float32, within
    5% for ppcg_hard_spectrum's Davidson stalls), and its kernel launches
    (init + probe + iterations + restarts per fused solve, one K2 per
    iteration, the CG init and one per CG iteration of each refinement
    pass, none on the other twins, K7 never); then linear_eigensystem again
    as ``python3 examples_torch/linear_eigensystem.py`` in a process of its
    own, and the twin notebook's cells. The kernels line carries each
    kernel's launches over the twins (``example_launches``).

Each Davidson solve reports iterations, convergence, time per iteration,
the f64 residual ||A x - rho x|| of each normalised Ritz vector against the
dense f64 matrix, the 4 lowest Rayleigh quotients against
REFERENCE_EIGENVALUES, and the launches of each kernel wrapper counted
during the solve, which must equal init + symmetry probe + iterations +
restarts (K2: iterations). The PPCG flagship reports the f64 residual
against the implied operator (applied tile by tile on the card), the
orthonormality of X, how far the sorted Rayleigh quotients lie from the 64
lowest diagonal entries (a skipped root would be 0.079 off), and K4's
launches, which must equal init + probe + iterations + re-anchors
(iterations // rr_every), and K8's, one of each of its two kernels an
iteration (on every rank of the sharded flagship too).

Every solve also counts the launches of K7 (the masked Gram), which must be
0: no solver calls it, in either package. Every device time from the
profiler is checked to cover each kernel the wrapper launches in each call.

Then one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path (K7's is the sum of those counts), error, times and bound; the
card's nvidia-smi line; and as the last line ``{"ok": true, "device":
{...}}``. Any failed check raises and the script exits non-zero without
that last line. It also exits non-zero where CUDA is absent, and where the
package beside it is missing. The limits of the sparse phases come from
``calibrate_sparse_cpu.py``, those of the int8 phases from
``calibrate_int8_cpu.py``, those of the P-space and linear phases from
``calibrate_linear_cpu.py``, those of the nonlinear and gradient phases from
``calibrate_nonlinear_cpu.py``, those of the non-hermitian phases from
``calibrate_nonsym_cpu.py``, those of the spill and many-root phases from
``calibrate_spill_cpu.py``; the sharded phases hold the unsharded phases'
limits, and ``calibrate_sharded_cpu.py`` runs them on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

N = 8192
NROOTS = 16
M_MAX = 64
# lowest-4 eigenvalues of the benchmark matrix, np.linalg.eigvalsh in f64
# (the constant of bench.py)
REFERENCE_EIGENVALUES = [
    -2.0000867851589925, -1.8397575604176952, -1.6784299270313459, -1.5176359291753378,
]
KERNEL_TOL = 1e-5

# the PPCG flagship (bench.py:1315-1360)
FLAGSHIP_N = 32768
FLAGSHIP_ROOTS = 64
FLAGSHIP_RR_EVERY = 8
FLAGSHIP_TOL = 5e-3
# limits set from calibrate_int8_cpu.py at n=8192 (PERF.md gives the margins):
# the f64 residual against the implied operator, max|X X^T - I|, and the
# distance of the sorted Rayleigh quotients from the 64 lowest diagonal
# entries (those are 0.079 apart, so a skipped root would be 0.079 off)
FLAGSHIP_RES_LIMIT = 1e-2
# the tighter flagship solve that must reach a full RR, and its residual limit
FLAGSHIP_RR_TOL = 1e-3
FLAGSHIP_RR_RES_LIMIT = 2e-3
FLAGSHIP_ORTHO_LIMIT = 1e-4
FLAGSHIP_SKIP_LIMIT = 0.01
# (f64 residual limit, Rayleigh-quotient limit) of the int8 Davidson solves,
# from the same calibration
INT8_LIMITS = {"int8": (5e-3, 1e-6), "int8_precise": (1e-4, 1e-8)}

# the sparse legs: bench.py's spmv operator (bench.py:996-1041) and the
# phenol-scale composition (benchmarks/phenol_scale.py:45-107)
SPARSE_N = 8192
SPARSE_BLOCK = 128
PARITY_ROOTS = 4
# lowest-4 eigenvalues of synthetic_fci_bsr(8192, 128, density=0.3, seed=1),
# np.linalg.eigvalsh of its dense f64 matrix (calibrate_sparse_cpu.py bsr)
REFERENCE_SPARSE_EIGENVALUES = [
    -1.9991245251208793, -1.8415032061808367, -1.6760024137777816, -1.5115168328099675,
]
PHENOL_N = 1 << 20
PHENOL_ROOTS = 16
# tolerance and limits of the phenol-scale solve, from the CPU calibration
# (PERF.md gives the margins)
PHENOL_TOL = 1e-4
PHENOL_RES_LIMIT = 2e-4
PHENOL_ORTHO_LIMIT = 1e-4
PHENOL_SKIP_LIMIT = 0.01
GRAM_ACTIVE = 40

# the P-space Davidson: the unit vectors of the 32 lowest diagonal entries
# with their exact f64 rows as actions; a basis of 2 x 16 + 32 rows; the
# iteration count of the port's CPU run in float32 (calibrate_linear_cpu.py)
PSPACE_P = 32
PSPACE_M_MAX = 96
PSPACE_ITERATIONS = 3
# examples/batched_scan.py at the size its docstring measured
BATCH_POINTS = 8
BATCH_N = 1024
BATCH_ROOTS = 3
BATCH_M_MAX = 18
BATCH_TOL = 1e-5
# the response-equation operator (bench matrix + 3 I: spectrum >= 1,
# condition number about 53) and its right-hand sides
LINEAR_SHIFT = 3.0
LINEAR_RHS_SEED = 2
# "fast" at 2e-3: the bf16 tier rounds x to bf16 (as the TPU kernel does),
# which floors a dense solution's residual near 8e-4 (calibrate_linear_cpu.py;
# at 2e-4 the port's float32 run did not converge in 60 iterations)
LINEAR_TOLS = {"fast": 2e-3, "precise": 1e-5, "exact": 1e-5, "int8": 5e-3,
               "int8_precise": 1e-5}
# (f64 relative residual, f64 relative solution error) limits of each tier,
# from calibrate_linear_cpu.py (PERF.md gives the margins)
LINEAR_LIMITS = {"fast": (1e-2, 1e-2), "precise": (5e-5, 5e-5), "exact": (1e-5, 2e-5),
                 "int8": (1e-2, 1e-2), "int8_precise": (5e-5, 5e-5)}
# the refinement leg (bench.py:755-789): to 1e-8, eigenvalues within 1e-9
REFINE_TOL = 1e-8
REFINE_RQ_LIMIT = 1e-9
# the parity linear equations on the shifted sparse operator: 4 right-hand
# sides, and the iteration count and stats of the port's CPU run in float32
# (calibrate_sparse_cpu.py parity_linear)
PARITY_LINEAR_RHS_SEED = 3
PARITY_LINEAR_ITERATIONS = 4
PARITY_LINEAR_STATS = ("iterations = 4, R vectors created = 16, Q vectors created = 32, "
                       "gemm_inner_ops = 16, gemm_outer_ops = 8")
PARITY_LINEAR_RES_LIMIT = 1e-5
# the nonlinear families and the gradients, on the bench matrix + 3 I (L-BFGS,
# DIIS, parity) and the bench matrix (the differentiable eigensolves), in the
# "exact" tier (K1-f32). Iteration counts and limits from
# calibrate_nonlinear_cpu.py (the port's plain path in float32 and float64
# on the CPU; PERF.md gives the margins)
NONLINEAR_B = 512
LBFGS_HISTORY = 10
LBFGS_TOL = 3e-2          # gradient norm; |b| = 90.4
LBFGS_MAX_ITER = 200
LBFGS_ITERATIONS = 25     # float32 and float64 alike (32 evaluations)
# the stopping rule's bound: ||x - x*|| <= ||g|| / lambda_min(A+3I) = 0.03 /
# 0.9999, over ||x*|| = 4.795 (the CPU run: 1.37e-3)
LBFGS_ERR_LIMIT = 6.3e-3
DIIS_EPS = 0.05
DIIS_M = 10
DIIS_TOL = 1e-4           # err = ||r||; |b| = 90.4
DIIS_MAX_ITER = 100
DIIS_ITERATIONS = 4       # float32 and float64 alike
# err <= 1e-4 over |b| = 90.4, plus f32 rounding of the residual (the CPU
# run: 6.8e-7)
DIIS_RES_LIMIT = 2e-6
# method -> (options, iterations, stats) of the port's CPU float64 run
PARITY_NONLINEAR = {
    "BFGS": ("max_size_qspace=6", 6, "iterations = 6, R vectors created = 6, Q vectors "
             "created = 12, Q vectors deleted = 1, gemm_inner_ops = 24, gemm_outer_ops = 18"),
    "SD": ("", 5, "iterations = 5, R vectors created = 6, Q vectors created = 12, "
           "gemm_inner_ops = 24, gemm_outer_ops = 18"),
    "DIIS": ("max_size_qspace=8", 26, "iterations = 26, R vectors created = 27, Q vectors "
             "created = 54, Q vectors deleted = 19, gemm_inner_ops = 108, "
             "gemm_outer_ops = 81"),
}
PARITY_NONLINEAR_X_LIMIT = 1e-8   # the CPU run: 3.4e-11 (BFGS), 2.1e-10 (SD)
# the trigonometric residual of the returned (interpolated) solution: the
# CPU run 9.8e-9, the solver's own threshold 1e-8 on its last iterate
PARITY_TRIG_RES_LIMIT = 2e-8
IMPLICIT_ROOTS = 4
IMPLICIT_M_MAX = 24
IMPLICIT_TOL = 1e-5
IMPLICIT_MAX_ITER = 60
IMPLICIT_WEIGHTS = (1.0, -0.5, 2.0, 0.25)
IMPLICIT_ITERATIONS = 3
IMPLICIT_DS_LIMIT = 1e-4      # the CPU run: 1.14e-5
IMPLICIT_VBAR_LIMIT = 1e-6    # the CPU run: 3.7e-8
# the float32 Rayleigh quotients against REFERENCE_EIGENVALUES (the CPU run:
# 2.1e-6, the card 1.54e-6; an f32 dot of 8192 terms near |lambda| = 2)
IMPLICIT_RQ_LIMIT = 1e-5
EIGENPAIR_M_SEED = 7
EIGENPAIR_RESPONSE_TOL = 1e-4   # the float32 floor is about 2e-6
EIGENPAIR_RESPONSE_MAX_ITER = 200
# against the plain float64 run (tol 1e-9, response 1e-8); the CPU run:
# 6.0e-5 (response 5 iterations, 3.8e-5)
EIGENPAIR_LIMIT = 5e-4
# rows of x at which check_symm_adjoint holds the differentiable action to
# plain autograd: the kernel checks' 16, the differentiable eigensolve's 4
# and one (L-BFGS and DIIS; a partial row block in K1's grid), the last
# also the shape it times
ADJOINT_ROWS = (NROOTS, IMPLICIT_ROOTS, 1)

# H100 SXM data-sheet peaks (dense): memory 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; int8 tensor cores 1979 TOP/s; float32 outside the tensor
# cores 67 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase record also carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def bench_matrix(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, 32), np.linspace(6.0, 50.0, n - 32)])
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(dvals)


def guess(diag: np.ndarray, nroots: int) -> np.ndarray:
    v0 = np.zeros((nroots, diag.shape[0]))
    for row, i in enumerate(np.argsort(diag)[:nroots]):
        v0[row, i] = 1.0
    return v0


def time_ms(fn, device, reps: int = 20) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def pad_events(device, kernels: int = 16) -> None:
    """A few short spin kernels, launched at both ends of a profiled
    window: the profiler can miss the first device events of a session
    (on an H100 it once recorded 5 of 10 K6 calls), so these take that place.
    ``device_events`` leaves them out."""
    import torch

    torch.cuda.synchronize(device)
    for _ in range(kernels):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)


def device_events(prof):
    """(name, count, device µs) of each device event in a profiler's key
    averages, the padding spin kernels left out; older torch names the time
    ``self_cuda_time_total``."""
    import torch

    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or "spin_kernel" in ev.key:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        yield ev.key, ev.count, us


# profiled windows taken again because the profiler missed device events
# (it has dropped some or all of a window's events on an H100)
PROFILE_RETRIES = []


def device_ms(fn, device, pattern: str, per_call: int, calls: int = 10,
              attempts: int = 8) -> tuple:
    """Device time per call, from torch.profiler (device activity only) over
    ``calls`` calls: of the kernels whose names contain ``pattern``, and of
    all the device work the call does; and the number of such kernels the
    profiler saw per call. Beside the CUDA-event time of a call, this
    separates the kernel from the host's work around it. A window in which
    the profiler did not see the ``per_call`` kernels the wrapper launches
    in each call (``per_call=None``, for a library call whose kernels are
    not known beforehand: the same number in each call, at least one) is
    profiled again, up to ``attempts`` windows, and recorded in
    PROFILE_RETRIES; then it raises: a missed event would make the device
    time read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_events(device)
            for _ in range(calls):
                fn()
            pad_events(device)
        mine = total = 0.0
        seen = 0
        for name, count, us in device_events(prof):
            total += us
            if pattern in name:
                mine += us
                seen += count
        if seen == (per_call or max(seen // calls, 1)) * calls:
            return mine / calls / 1e3, total / calls / 1e3, seen / calls
        PROFILE_RETRIES.append({"pattern": pattern, "attempt": attempt + 1, "seen": seen,
                                "calls": calls, "per_call": per_call})
    raise AssertionError(f"the profiler saw {seen} '{pattern}' kernels in {calls} calls, "
                         f"not {per_call} per call, in {attempts} windows")


def in_turns(plain, kernel, device):
    """(kernel_ms, plain_ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, device)
    k1 = time_ms(kernel, device)
    k2 = time_ms(kernel, device)
    p2 = time_ms(plain, device)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got, ref) -> tuple:
    got = got.double()
    ref = ref.double()
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-300)


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def symm_flops(sym, m: int, products: int) -> float:
    """2 flop per multiply-add: each tile gives m x b x b products per
    contribution, two contributions off the diagonal, one on it."""
    ii = sym.ii.cpu().numpy()
    jj = sym.jj.cpu().numpy()
    contributions = 2 * int(np.sum(ii != jj)) + int(np.sum(ii == jj))
    return 2.0 * products * m * sym.b * sym.b * contributions


def dense_from_tiles(tiles, ii, jj, b: int, n: int):
    """The dense symmetric matrix that packed lower tiles imply, in the
    tiles' dtype, on their device."""
    import torch

    dense = torch.zeros((n, n), dtype=tiles.dtype, device=tiles.device)
    for t, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = tiles[t]
        if i != j:
            dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = tiles[t].T
    return dense


def packed_on_card(n: int, b: int, kind: str, device, seed: int):
    """A packed operator of the bench matrix's make generated on the card,
    with no host matrix: every lower tile pair present, couplings
    N(0, 1) * 0.05/sqrt(n) from a seeded torch generator, the diagonal
    tiles symmetric with linspace(-2, 50, n) added on their diagonal.
    ``kind``: "bf16" or "f32" (SymmetricBlocked) or "split"."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    nb = n // b
    ii, jj = torch.tril_indices(nb, nb, device=device).to(torch.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((ii.numel(), b, b), generator=gen, device=device) * (0.05 / np.sqrt(n))
    diag = torch.nonzero(ii == jj).squeeze(1)
    vals[diag] = 0.5 * (vals[diag] + vals[diag].transpose(1, 2))
    ar = torch.arange(b, device=device)
    d = torch.linspace(-2.0, 50.0, n, device=device)
    vals[diag[:, None], ar[None, :], ar[None, :]] += d[ii[diag].long()[:, None] * b + ar[None, :]]
    common = dict(ii=ii, jj=jj, shape=(n, n), b=b, diagonal=d)
    if kind == "split":
        hi = vals.to(torch.bfloat16)
        lo = (vals - hi.to(torch.float32)).to(torch.bfloat16)  # exact in f32
        return symm.SymmetricBlockedSplit(hi=hi, lo=lo, **common)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return symm.SymmetricBlocked(values=vals.to(dtype), **common)


def symm_library(sym, x):
    """(fn, note): one PyTorch call computing the same function as K1 or K3
    on the dense planes the tiles imply (TF32 off). A yardstick only."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    n = sym.shape[0]
    if isinstance(sym, symm.SymmetricBlockedSplit):
        hi = dense_from_tiles(sym.hi, sym.ii, sym.jj, sym.b, n)
        lo = dense_from_tiles(sym.lo, sym.ii, sym.jj, sym.b, n)
        stacked = torch.cat([hi, lo, hi], 0)
        del hi, lo
        xh, xl = symm.bf16_split(x)
        xs = torch.cat([xh, xh, xl], 1)
        return (lambda: torch.matmul(xs, stacked),
                f"torch.matmul(cat([xh, xh, xl], 1), cat([A_hi, A_lo, A_hi], 0)): one bf16 "
                f"product ({x.shape[0]} x {3 * n}) @ ({3 * n} x {n}) on the dense planes, "
                f"the three products of K3 in one call; returns bf16, the kernel f32")
    a = dense_from_tiles(sym.values, sym.ii, sym.jj, sym.b, n)
    xl = x.to(a.dtype)
    if a.dtype == torch.bfloat16:
        note = (f"torch.matmul(x.bfloat16(), A) on the dense bf16 matrix ({x.shape[0]} x {n}) "
                f"@ ({n} x {n}); returns bf16, the kernel f32")
    else:
        note = f"torch.matmul(x, A) f32 (TF32 off) on the dense matrix ({n} x {n})"
    return (lambda: torch.matmul(xl, a)), note


def symm_case(name, sym, x, device, replaces) -> dict:
    """K1 or K3 against its plain version on ``x`` and ``sym``: errors, wrapper
    and plain times in turns, the kernel's device time, the bound and the
    library yardstick."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    split = isinstance(sym, symm.SymmetricBlockedSplit)
    kernel = symm.symm_matmat_split_kernel if split else symm.symm_matmat_kernel
    plain = symm.symm_matmat_split if split else symm.symm_matmat
    m, n = x.shape
    y = kernel(x, sym)
    y_ref = plain(x, sym)
    torch.cuda.synchronize(device)
    abs_err, rel = rel_err(y, y_ref)
    del y, y_ref
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name}: max relative error {rel:.3e} > {KERNEL_TOL}")
    same_bits = same_bits_rows(kernel, x, sym, (m, 4, 1))
    if not all(same_bits.values()):
        raise AssertionError(f"{name}: a second call gave other bits {same_bits}")
    kernel_ms, plain_ms = in_turns(lambda: plain(x, sym), lambda: kernel(x, sym), device)
    kernel_device_ms, call_device_ms, _ = device_ms(lambda: kernel(x, sym), device,
                                                    "symm_packed", SYMM_KERNELS)
    library, library_note = symm_library(sym, x)
    library_ms = time_ms(library, device)
    # the yardstick's device time, read as the kernel's is
    library_device_ms = device_ms(library, device, "", None)[0]
    del library
    torch.cuda.empty_cache()
    planes = (sym.hi, sym.lo) if split else (sym.values,)
    tile_bytes = sum(p.numel() * p.element_size() for p in planes)
    nbytes = tile_bytes + 8 * sym.n_pairs + 2 * 4 * m * n  # tiles, ii/jj, x read, y written
    kind = "f32" if not split and sym.values.dtype == torch.float32 else "bf16"
    bound_ms, bound_by = bound(nbytes, symm_flops(sym, m, 3 if split else 1), kind)
    return {
        "name": name, "route": "cuda",
        "source": "iterative_solver_torch/ops/kernels/csrc/symm_packed.cu",
        "replaces": replaces, "max_abs_err": abs_err, "max_rel_err": rel,
        "tolerance": KERNEL_TOL, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "library_ms": library_ms, "library_note": library_note,
        "kernel_device_ms": kernel_device_ms, "call_device_ms": call_device_ms,
        "library_device_ms": library_device_ms,
        "share_of_bound": bound_ms / kernel_device_ms,
        "same_bits_by_rows": same_bits,
        "shapes": {"m": m, "n": n, "b": sym.b, "n_pairs": sym.n_pairs,
                   "work_items": int(symm.square_work(sym).shape[0])},
    }


# kernels one K1 or K3 call launches: the square walk into the slots, then
# the fixed-order sums
SYMM_KERNELS = 2


def same_bits_rows(kernel, x, sym, rows) -> dict:
    """Whether two calls of K1 or K3 on the first ``r`` rows of x give the
    same bits, for each r of ``rows``."""
    import torch

    out = {}
    for r in rows:
        xr = x[:r].contiguous()
        out[str(r)] = bool(torch.equal(kernel(xr, sym), kernel(xr, sym)))
    return out


K1_REPLACES = "iterative_solver_tpu/ops/kernels/symm_pallas.py:148"
K3_REPLACES = "iterative_solver_tpu/ops/kernels/symm_pallas.py:325"
# (name, storage kind, tile edge, replaces) of the K1/K3 checks, at the
# shapes of the fast (b = 1024), exact and precise (b = 512) solves
SYMM_CASES = (("K1-bf16", "bf16", 1024, K1_REPLACES), ("K1-f32", "f32", 512, K1_REPLACES),
              ("K3", "split", 512, K3_REPLACES))


def symm_operands(matrix, device):
    """(name, kind, sym, replaces) of each K1/K3 check at n = 8192 (the bench
    matrix, host-packed) and n = FLAGSHIP_N (generated on the card)."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    for name, kind, b, replaces in SYMM_CASES:
        if kind == "split":
            sym = symm.SymmetricBlockedSplit.from_dense(matrix, b=b, device=device)
        else:
            dtype = torch.bfloat16 if kind == "bf16" else torch.float32
            sym = symm.SymmetricBlocked.from_dense(matrix, b=b, dtype=dtype, device=device)
        yield name, kind, sym, replaces
        del sym
    for seed, (name, kind, b, replaces) in enumerate(SYMM_CASES):
        yield (f"{name}@n{FLAGSHIP_N}", kind, packed_on_card(FLAGSHIP_N, b, kind, device, seed),
               replaces)
        torch.cuda.empty_cache()


def check_kernels(matrix: np.ndarray, device) -> list:
    """Each kernel against its plain version at the main path's shapes; K1
    and K3 also at n = FLAGSHIP_N."""
    import torch

    n = matrix.shape[0]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((NROOTS, n)), dtype=torch.float32, device=device)
    x_big = torch.as_tensor(np.random.default_rng(4).standard_normal((NROOTS, FLAGSHIP_N)),
                            dtype=torch.float32, device=device)
    results = []
    for name, _, sym, replaces in symm_operands(matrix, device):
        results.append(symm_case(name, sym, x if sym.shape[0] == n else x_big, device,
                                 replaces))
        del sym
    del x_big

    q, _ = torch.linalg.qr(torch.as_tensor(rng.standard_normal((n, M_MAX)),
                                           dtype=torch.float32, device=device))
    results.append(chain_case("K2", x, q, np.diagonal(matrix),
                              np.linspace(-2.0001, -1.5, NROOTS), device))
    return results


def check_chain_raw(n: int, device) -> dict:
    """K2 in the raw mode FusedLinearEquations launches (no Jacobi inside),
    at the linear solve's shapes: 16 rows, a 64-row basis, n = 8192; the
    inputs of check_kernels' K2."""
    import torch

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((NROOTS, n)), dtype=torch.float32, device=device)
    q, _ = torch.linalg.qr(torch.as_tensor(rng.standard_normal((n, M_MAX)),
                                           dtype=torch.float32, device=device))
    rec = chain_case("K2-raw", x, q, None, None, device)
    emit({"phase": "kernel_check_k2_raw", **rec})
    return rec


def chain_case(name, r, q, diag_np, evals_np, device) -> dict:
    """K2 against its plain version at a step's shapes: the residuals ``r``,
    a basis stack of the orthonormal columns of ``q`` filled to 48 of 64
    rows (dead rows hold zeros, as in the solver), the operator diagonal,
    and Ritz values ``evals_np`` near its lowest entries. With ``diag_np``
    None it is K2's raw mode, as FusedLinearEquations calls it: ``r`` is
    the new-direction block, and no Jacobi step runs inside.

    Checks: t, n0, n2 and g within KERNEL_TOL of the plain version and of
    the plain version in float64 on the same inputs (the plain version's
    own errors against float64 are recorded beside them), and a second call
    gives the same bits (K2 adds every partial in a fixed order).
    ``three_pass_floor_ms``: the bytes the chain's data dependence forces,
    v read once per Gram-Schmidt pass and once more, at the card's memory
    rate; ``bound_ms`` stays the single-read bound of earlier runs."""
    import torch

    from iterative_solver_torch.ops.kernels import chain

    nroots, n = r.shape
    mask = torch.zeros(M_MAX, dtype=torch.float32, device=device)
    mask[:48] = 1.0
    v = (q.T * mask[:, None]).contiguous()
    f64 = torch.float64
    if diag_np is None:
        args = ()
    else:
        args = (torch.as_tensor(diag_np, dtype=torch.float32, device=device),
                torch.as_tensor(evals_np, dtype=torch.float32, device=device))
    got = chain.fused_expand_chain(r, v, mask, *args)
    again = chain.fused_expand_chain(r, v, mask, *args)
    ref = chain.expand_chain(r, v, mask, *args)
    ref64 = chain.expand_chain(r.to(f64), v.to(f64), mask.to(f64), *(a.to(f64) for a in args))
    torch.cuda.synchronize(device)
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    kernel_f64 = [rel_err(a, b)[1] for a, b in zip(got, ref64)]
    plain_f64 = [rel_err(a, b)[1] for a, b in zip(ref, ref64)]
    del ref64
    rel = max(e[1] for e in errs)
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name}: max relative error {rel:.3e} > {KERNEL_TOL} "
                             f"(t, n0, n2, g: {[e[1] for e in errs]})")
    if not max(kernel_f64) <= KERNEL_TOL:
        raise AssertionError(f"{name}: relative error against float64 {max(kernel_f64):.3e} "
                             f"> {KERNEL_TOL} (t, n0, n2, g: {kernel_f64})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: a second call gave other bits")
    del again
    kernel_ms, plain_ms = in_turns(lambda: chain.expand_chain(r, v, mask, *args),
                                   lambda: chain.fused_expand_chain(r, v, mask, *args),
                                   device)
    # one cooperative launch per call
    kernel_device_ms, call_device_ms, _ = device_ms(
        lambda: chain.fused_expand_chain(r, v, mask, *args), device, "chain_", 1)
    rn = nroots * n
    jacobi = diag_np is not None
    # r in, t out, v, mask, (diag, evals), n0, n2, g
    nbytes = 4 * (2 * rn + M_MAX * n + M_MAX + (n + nroots if jacobi else 0) + 2 * nroots
                  + nroots * nroots)
    # Jacobi (3, Jacobi mode only), n0 (2), two GS passes (2 x 2 x 2 x M),
    # n2 (2), g (2 R)
    flops = rn * ((3 if jacobi else 0) + 2 + 8 * M_MAX + 2 + 2 * nroots)
    bound_ms, bound_by = bound(nbytes, flops, "f32")
    # two GS passes: v is read three times
    floor_bytes = nbytes + 2 * 4 * M_MAX * n
    return {
        "name": name, "route": "cuda",
        "source": "iterative_solver_torch/ops/kernels/csrc/chain.cu",
        "replaces": "iterative_solver_tpu/ops/kernels/chain_pallas.py:94",
        "max_abs_err": max(e[0] for e in errs), "max_rel_err": rel,
        "tolerance": KERNEL_TOL, "same_bits": True, "kernel_errors_against_f64": kernel_f64,
        "plain_errors_against_f64": plain_f64, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "three_pass_floor_bytes": floor_bytes,
        "three_pass_floor_ms": floor_bytes / PEAK_BYTES * 1e3,
        "library_ms": None, "kernel_device_ms": kernel_device_ms,
        "call_device_ms": call_device_ms, "share_of_bound": bound_ms / kernel_device_ms,
        "shapes": {"r": nroots, "m_max": M_MAX, "n": n, "active": 48},
        "mode": "jacobi" if jacobi else "raw",
    }


def int_mm_library(xs_planes, q_planes, products, sym, n, device) -> dict:
    """One ``torch._int_mm`` per int8 product of the action, qx against the
    dense int8 matrix the tiles imply, in CUDA-event and profiler device ms,
    with that matrix in two layouts: column-major (``d.t().contiguous().t()``,
    the same symmetric values in the layout cuBLASLt's int8 path takes for
    its second operand; the yardstick, ``library_ms``) and row-major (as
    built, ``library_row_major_ms``). ``_int_mm`` takes more than 16 rows,
    so x is padded to 32. Each layout's first product must equal the plain
    version's int32 accumulator bit for bit
    (``library_equals_plain_accumulator``)."""
    import torch

    from iterative_solver_torch.ops.kernels import symm_int8

    m = xs_planes[0].shape[0]
    rows = max(32, m)
    row_major = [dense_from_tiles(q, sym.ii, sym.jj, sym.b, n) for q in q_planes]
    layouts = {"column_major": [d.t().contiguous().t() for d in row_major],
               "row_major": row_major}
    padded = []
    for xp in xs_planes:
        pad = torch.zeros((rows, n), dtype=torch.int8, device=device)
        pad[:m] = xp
        padded.append(pad)
    note = (f"torch._int_mm x{len(products)} ({rows} x {n}) @ ({n} x {n}) int8, the plane "
            "column-major (row-major beside it)"
            + (f", x padded from {m} to {rows} rows" if rows != m else ""))
    ref = symm_int8._symm_matmat_int8_plain(xs_planes[0], q_planes[0], sym.ii, sym.jj,
                                            sym.b, n // sym.b)
    rec = {"library_note": note, "library_equals_plain_accumulator": {}}
    for layout, dense in layouts.items():
        pairs = [(padded[a], dense[k]) for a, k in products]
        key = "library" if layout == "column_major" else "library_row_major"
        try:
            got = torch._int_mm(*pairs[0])[:m]
            rec["library_equals_plain_accumulator"][layout] = bool(torch.equal(got, ref))
            lib = lambda: [torch._int_mm(a, d) for a, d in pairs]  # noqa: E731
            rec[f"{key}_ms"] = time_ms(lib, device)
            rec[f"{key}_device_ms"] = device_ms(lib, device, "", None)[0]
        except RuntimeError as err:  # a yardstick only: record the refusal
            rec[f"{key}_ms"] = rec[f"{key}_device_ms"] = None
            rec["library_note"] += f"; {layout} refused ({str(err).splitlines()[0]})"
    if not all(rec["library_equals_plain_accumulator"].values()):
        raise AssertionError(f"torch._int_mm differs from the plain accumulator: {rec}")
    return rec


# K4's and K5's device ms in an earlier run of this script, the square
# walk's (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700 W), printed
# beside each row's own; at the PPCG cell's 64 x 131072, the benchmark's
# traced square walk (20 calls in 0.2911 s)
INT8_EARLIER_DEVICE_MS = {"K4@n8192": 0.0262, "K4": 0.8703, "K5": 0.0712, "K4@b256": 0.0254,
                       "K5@b256": 0.0520, "K4@n131072r64": 14.56}
# the benchmark cell's operator: n = 131072 in tiles of 1024 (8256 pairs,
# 8.06 GiB), 16 rows of x; its plain version takes this many pairs a pass
INT8_CELL_N = 131072
INT8_CELL_PAIRS_PER_PASS = 128


def check_int8_kernels(matrix: np.ndarray, flagship, device) -> list:
    """K4 and K5 against their plain versions, bit for bit, at the main
    path's shapes: K4 at 16 x 8192 (the bench matrix) and at 64 x 32768
    (the flagship operator), K5 at 16 x 8192, all at b = 1024; and both at
    the quantized_screening example's shape, 6 x 8192 at b = 256
    (EXAMPLE_INT8_ROWS, EXAMPLE_INT8_TILE: the bench matrix packed there),
    where 528 tile pairs of one 256-square each take another walk and flush
    than the b = 1024 cases' 36 pairs of 16; and K4 at the benchmark
    cells' shapes, 16 and 64 x 131072 at b = 1024 (one
    ``synthetic_packed_int8`` operator), where it takes the band and the
    strip walk (as it does at 64 x 32768). Each K4 row names the walk it
    took (``symm_int8.K4_WALKS``) and counts that walk's reds."""
    import torch

    from iterative_solver_torch.ops.kernels import symm_int8

    rng = np.random.default_rng(2)
    results = []

    def int8_case(name, sym, m, planes, replaces, pairs_per_pass=None):
        # pairs_per_pass: an operator too large for the plain version in one
        # contraction and for a dense yardstick: no plain or library timing
        n = sym.shape[0]
        x = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=device)
        if planes == 1:
            kernel = symm_int8.symm_matmat_int8_kernel
            plain = functools.partial(symm_int8.symm_matmat_int8, pairs_per_pass=pairs_per_pass)
            q_planes = (sym.q,)
            xs_planes = symm_int8.quantize_rows(x * sym.gq[None, :])[:1]
            pairs = ((0, 0),)
        else:
            kernel = symm_int8.symm_matmat_int8_split_kernel
            plain = symm_int8.symm_matmat_int8_split
            q_planes = (sym.q1, sym.q2)
            xs_planes = symm_int8.quantize_rows_split(x * sym.gq[None, :])[:2]
            pairs = ((0, 0), (0, 1), (1, 0))   # p1 Q1, p1 Q2, p2 Q1
        walks = dict(symm_int8.K4_WALKS)
        y = kernel(x, sym)
        walk = ("square" if planes == 2 else
                next(k for k, v in symm_int8.K4_WALKS.items() if v != walks[k]))
        y_ref = plain(x, sym)
        again = kernel(x, sym)
        torch.cuda.synchronize(device)
        abs_err = float((y - y_ref).abs().max())
        if not torch.equal(y, y_ref):
            raise AssertionError(f"{name}: not bit-identical to the plain version "
                                 f"(max abs err {abs_err:.3e})")
        if not torch.equal(again, y):
            raise AssertionError(f"{name}: a second call gave other bits")
        del again, y_ref
        if pairs_per_pass is None:
            kernel_ms, plain_ms = in_turns(lambda: plain(x, sym), lambda: kernel(x, sym),
                                           device)
        else:
            kernel_ms, plain_ms = time_ms(lambda: kernel(x, sym), device), None
        # the main kernel and its epilogue, and all the call's device work
        # (the quantization of x in torch ops included)
        kernel_device_ms, call_device_ms, _ = device_ms(lambda: kernel(x, sym), device,
                                                        "symm_int8", 2)
        library = ({"library_ms": None, "library_note": "none: the dense plane would take "
                    f"{n * n / 2 ** 30:.0f} GiB"} if pairs_per_pass is not None else
                   int_mm_library(xs_planes, q_planes, pairs, sym, n, device))
        # the bytes the replaced function moves; its int32 accumulators live
        # in on-chip scratch, so their traffic here (atomics into device
        # memory, then the epilogue's read) is reported apart, not bounded
        nbytes = (planes * sym.n_pairs * sym.b * sym.b     # tiles
                  + planes * m * n                         # quantized x planes
                  + 2 * 4 * m * n                          # xf read, y written
                  + 4 * m + 8 * n + 8 * sym.n_pairs)       # sx, gq, d, ii, jj
        bound_ms, bound_by = bound(nbytes, symm_flops(sym, m, len(pairs)), "int8")
        scratch_bytes = planes * 2 * 4 * m * n             # accumulators written, read
        # K4 and K5 flush each square, band or strip once: one int32 sum
        # per accumulator (K5: hi and lo), row of x and contributed row or
        # column, two to a 64-bit red where the square walk's b is even
        # (symm_int8.int8_flush_atomics)
        flush_sums, flush_atomics = symm_int8.int8_flush_atomics(
            sym.ii.cpu(), sym.jj.cpu(), sym.b, m, planes=planes, walk=walk)
        results.append({
            "name": name, "route": "cuda",
            "source": "iterative_solver_torch/ops/kernels/csrc/symm_int8.cu",
            "replaces": replaces, "max_abs_err": abs_err, "bit_identical": True,
            "same_bits": True, "tolerance": 0.0, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "scratch_bytes": scratch_bytes, "walk": walk,
            "flush_atomics": flush_atomics, "flush_sums": flush_sums,
            **library,
            "kernel_device_ms": kernel_device_ms, "call_device_ms": call_device_ms,
            "share_of_bound": bound_ms / kernel_device_ms,
            "earlier_kernel_device_ms": INT8_EARLIER_DEVICE_MS.get(name),
            "shapes": {"m": m, "n": n, "b": sym.b, "n_pairs": sym.n_pairs},
        })

    k4 = "iterative_solver_tpu/ops/kernels/symm_int8.py:344"
    sym = symm_int8.SymmetricBlockedInt8.from_dense(matrix, b=1024, device=device)
    int8_case("K4@n8192", sym, NROOTS, 1, k4)
    del sym
    int8_case("K4", flagship, FLAGSHIP_ROOTS, 1, k4)
    k5 = "iterative_solver_tpu/ops/kernels/symm_int8.py:430"
    sym = symm_int8.SymmetricBlockedInt8Split.from_dense(matrix, b=1024, device=device)
    int8_case("K5", sym, NROOTS, 2, k5)
    del sym
    tile, rows = EXAMPLE_INT8_TILE, EXAMPLE_INT8_ROWS
    sym = symm_int8.SymmetricBlockedInt8.from_dense(matrix, b=tile, device=device)
    int8_case(f"K4@b{tile}", sym, rows, 1, k4)
    sym = symm_int8.SymmetricBlockedInt8Split.from_dense(matrix, b=tile, device=device)
    int8_case(f"K5@b{tile}", sym, rows, 2, k5)
    del sym
    from iterative_solver_torch.models.synthetic_fci import synthetic_packed_int8

    sym, _ = synthetic_packed_int8(INT8_CELL_N, b=1024, seed=0, device=device)
    int8_case(f"K4@n{INT8_CELL_N}", sym, NROOTS, 1, k4, INT8_CELL_PAIRS_PER_PASS)
    int8_case(f"K4@n{INT8_CELL_N}r{FLAGSHIP_ROOTS}", sym, FLAGSHIP_ROOTS, 1, k4,
              INT8_CELL_PAIRS_PER_PASS)
    del sym
    torch.cuda.empty_cache()
    return results


def check_rr3_kernels(device) -> list:
    """K8 (PPCG's per-root 3x3 RR, ops/kernels/rr3.py) at the PPCG cell's
    64 x 131072, on six float32 blocks x, ax, w, aw, p, ap of unit rows
    (the actions a diagonal), once with every direction live and once with
    every p dead (a solve's first step). Checks: given the dots kernel's
    own dots, the update kernel's coefficients and four blocks carry the
    bits of the eager chain (``_rr3_coeffs``, ``rr3_update_plain``); the
    dots lie within float32 rounding of float64 dots (2^-24 of each value
    plus 1e-13 of the sum of |products|: K8 adds in float64 and rounds
    once) and repeat to the bit. The plain version timed in turns is the
    eager chain from the einsum row dots on, in CUDA-event ms only: of its
    ~2,000 kernels a call the profiler drops a few. The bound is the
    bytes of both kernels: 6 blocks read by the dots, 6 read and 4 written
    by the update."""
    import torch

    from iterative_solver_torch.ops.kernels import rr3
    from iterative_solver_torch.solvers import fused_ppcg as fp

    r, n = FLAGSHIP_ROOTS, INT8_CELL_N
    rng = np.random.default_rng(3)
    f32 = {"dtype": torch.float32, "device": device}
    d = torch.linspace(-2.0, 50.0, n, **f32)
    x, w, p = (v / torch.linalg.norm(v, dim=1, keepdim=True) for v in (
        torch.as_tensor(rng.standard_normal((r, n)), **f32) for _ in range(3)))
    live = torch.ones(r, dtype=torch.bool, device=device)
    zero = torch.zeros_like(p)
    cases = {"live": ((x, x * d, w, w * d, p, p * d), live, live),
             "p_dead": ((x, x * d, w, w * d, zero, zero), live, ~live)}
    worst_abs = worst_rel = 0.0
    for case, (blocks, live_w, live_p) in cases.items():
        dots = rr3.rr3_dots(*blocks)
        *new, c = rr3.rr3_update(dots, live_w, live_p, *blocks)
        again = rr3.rr3_dots(*blocks)
        ref_c = fp._rr3_coeffs(dots, live_w, live_p, r)
        ref = rr3.rr3_update_plain(ref_c, *blocks)
        b64 = [b.double() for b in blocks]
        dots64 = torch.stack([(b64[i] * b64[j]).sum(1) for i, j in rr3.RR3_PAIRS])
        scale = torch.stack([(b64[i] * b64[j]).abs().sum(1) for i, j in rr3.RR3_PAIRS])
        err = (dots.double() - dots64).abs()
        torch.cuda.synchronize(device)
        if not (torch.equal(c, ref_c) and all(torch.equal(a, b) for a, b in zip(new, ref))):
            raise AssertionError(f"K8 ({case}): the update differs from the eager chain's bits")
        if not torch.equal(again, dots):
            raise AssertionError(f"K8 ({case}): a second call of the dots gave other bits")
        if not bool(torch.all(err <= 2.0 ** -24 * dots64.abs() + 1e-13 * scale)):
            raise AssertionError(f"K8 ({case}): dots off float64 by {float(err.max()):.3e}")
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float((err / dots64.abs().clamp_min(1e-300)).max()))
        del new, ref, again, b64, dots64, scale, err
    blocks, live_w, live_p = cases["live"]

    def kernel():
        return rr3.rr3_update(rr3.rr3_dots(*blocks), live_w, live_p, *blocks)

    def plain():
        return rr3.rr3_update_plain(
            fp._rr3_coeffs(rr3.rr3_dots_plain(*blocks), live_w, live_p, r), *blocks)

    kernel_ms, plain_ms = in_turns(plain, kernel, device)
    kernel_device_ms, call_device_ms, _ = device_ms(kernel, device, "rr3_", 2)
    dots_device_ms = device_ms(kernel, device, "rr3_dots", 1)[0]
    nbytes = 16 * 4 * r * n
    bound_ms, bound_by = bound(nbytes, 0.0, "f32")
    rec = {
        "name": "K8", "route": "cuda",
        "source": "iterative_solver_torch/ops/kernels/csrc/rr3.cu",
        "replaces": "iterative_solver_tpu/solvers/fused_ppcg.py:130",
        "max_abs_err": 0.0, "bit_identical_given_dots": True, "same_bits": True,
        "dots_max_abs_err_f64": worst_abs, "dots_max_rel_err_f64": worst_rel,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "library_ms": None,
        "library_note": "none: the JAX package leaves the step to XLA",
        "kernel_device_ms": kernel_device_ms, "dots_device_ms": dots_device_ms,
        "update_device_ms": kernel_device_ms - dots_device_ms,
        "call_device_ms": call_device_ms, "share_of_bound": bound_ms / kernel_device_ms,
        "shapes": {"r": r, "n": n, "chunks": rr3.rr3_chunks(r, n)}, "cases": list(cases),
    }
    emit({"phase": "kernel_check_k8", **rec})
    del cases, blocks, x, w, p, zero, d
    torch.cuda.empty_cache()
    return [rec]


def expected_restarts(iters: int, nroots: int, m_max: int, n_p: int = 0) -> int:
    """Restarts of a solve that steps ``iters`` times, restarting whenever
    the next append would overflow (the frozen P slots stay)."""
    k, restarts = n_p + nroots, 0
    for _ in range(iters):
        if k + nroots > m_max:
            k, restarts = n_p + nroots, restarts + 1
        k += nroots
    return restarts


def launch_counters() -> tuple:
    """Every kernel wrapper's launch counts (the keys are distinct)."""
    from iterative_solver_torch.ops.kernels import chain, gram, rr3, spmv, symm, symm_int8

    return (symm.LAUNCHES, symm_int8.LAUNCHES, chain.LAUNCHES, spmv.LAUNCHES, gram.LAUNCHES,
            rr3.LAUNCHES)


def reset_launches() -> None:
    for d in launch_counters():
        for key in d:
            d[key] = 0


def read_launches(key: str) -> int:
    return next(d[key] for d in launch_counters() if key in d)


# K8's two kernels' launch counters (ops/kernels/rr3.py)
RR3_KEYS = ("rr3_dots", "rr3_update")


def solve_launches(action_key: str) -> dict:
    """The launches a solve made: its action's kernel, the fused chain (K2),
    and the masked Gram (K7), which no solver calls, so that a solve that
    did would show; and PPCG's 3x3 RR kernels (K8, ``rr3_dots`` and
    ``rr3_update``) where either ran, so that a PPCG phase expects them
    (``ppcg_expected_launches``) and any other solve that took one differs
    from its expected launches."""
    launches = {"action": read_launches(action_key), "chain": read_launches("chain"),
                "gram": read_launches("gram")}
    rr3 = {key: read_launches(key) for key in RR3_KEYS}
    return {**launches, **rr3} if any(rr3.values()) else launches


def ppcg_expected_launches(iters: int, device) -> dict:
    """A flagship PPCG solve's launches: K4 for the init (1), the symmetry
    probe (2), each step and each full RR's re-anchoring; no K2 and no K7;
    on the card each step's two K8 kernels."""
    expected = {"action": 1 + 2 + iters + iters // FLAGSHIP_RR_EVERY, "chain": 0, "gram": 0}
    if device.type == "cuda":
        expected.update({key: iters for key in RR3_KEYS})
    return expected


def solve_phase(matrix, ref_evals, device, tier, rr, tol, res_limit, rq_limit,
                action_key, built=None, phase=None, v0=None, **solver_kw) -> dict:
    """One solve through the public entry points; raises on a failed check.
    Returns the phase record with the launches counted during the solve.
    ``built`` is ``(solver, setup seconds)`` of a solver made elsewhere;
    without it the solver is ``from_dense_symmetric(matrix, tier=tier)``.
    ``v0`` defaults to the one-hot guess on the lowest diagonal entries."""
    import torch

    from iterative_solver_torch import FusedDavidson

    diag = np.diagonal(matrix)
    if built is None:
        t0 = time.perf_counter()
        solver = FusedDavidson.from_dense_symmetric(
            matrix, NROOTS, tier=tier, m_max=M_MAX, rr=rr,
            convergence_threshold=tol, max_iter=60, **solver_kw)
        setup_s = time.perf_counter() - t0
    else:
        solver, setup_s = built
    phase = phase or f"solve_{tier}"
    v0 = guess(diag, NROOTS) if v0 is None else v0

    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches(action_key)

    # a second solve from the same guess (no symmetry probe): steady time
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _, _, _, iters2 = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall2 = time.perf_counter() - t0

    restarts = expected_restarts(iters, NROOTS, solver.m_max, solver.n_p)
    expected = {"action": 1 + 2 + iters + restarts, "chain": iters, "gram": 0}
    converged = bool(np.max(errors) <= tol)

    checks = dense_quality(x, matrix, ref_evals)
    res, rq_low, rq_err = (checks["f64_max_residual"], checks["rayleigh_quotients"],
                           checks["rq_max_abs_err"])

    rec = {
        "phase": phase, "tier": tier, "rr": rr, "n": matrix.shape[0],
        "nroots": NROOTS, "m_max": solver.m_max, "n_p": solver.n_p, "tol": tol,
        "fuse_chain": solver.fuse_chain,
        "iterations": iters, "restarts": restarts, "converged": converged,
        "max_error": float(np.max(errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1),
        "steady_seconds": wall2, "steady_seconds_per_iteration": wall2 / max(iters2, 1),
        "setup_seconds": setup_s,
        "f64_max_residual": res, "f64_residual_limit": res_limit,
        "rayleigh_quotients": rq_low, "rq_max_abs_err": rq_err,
        "rq_limit": rq_limit, "launches": launches, "expected_launches": expected,
        "action_kernel": action_key, **solver_kw,
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    if not res <= res_limit:
        failures.append(f"f64 residual {res:.3e} > {res_limit}")
    if not rq_err <= rq_limit:
        failures.append(f"Rayleigh quotients off by {rq_err:.3e} > {rq_limit}")
    if launches != expected or min(launches["action"], launches["chain"]) == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return rec


def make_flagship(device):
    """The flagship operator, generated directly on the host and moved to
    the card (bench.py:1332-1334). Returns (sym, diag, seconds)."""
    from iterative_solver_torch.models.synthetic_fci import synthetic_packed_int8

    t0 = time.perf_counter()
    sym, diag = synthetic_packed_int8(FLAGSHIP_N, b=1024, seed=0, device=device)
    return sym, diag, time.perf_counter() - t0


def quality(x, apply_f64, diag, nroots: int) -> dict:
    """The checks on returned Ritz rows ``x`` of an operator held without a
    dense matrix: the f64 residual ||A x - rho x|| of each normalised row,
    with ``apply_f64`` the operator's f64 action on x's device, max|X X^T -
    I|, and the largest distance of the sorted Rayleigh quotients from the
    sorted ``nroots`` lowest diagonal entries."""
    import torch

    x64 = x.to(torch.float64)
    xs = x64 / torch.linalg.norm(x64, dim=1, keepdim=True)
    ax = apply_f64(xs)
    rq = torch.sum(xs * ax, dim=1)
    res = float(torch.max(torch.linalg.norm(ax - rq[:, None] * xs, dim=1)))
    eye = torch.eye(nroots, dtype=torch.float64, device=x.device)
    ortho = float(torch.max(torch.abs(x64 @ x64.T - eye)))
    rq_sorted = np.sort(rq.cpu().numpy())
    low = np.sort(np.asarray(diag))[:nroots]
    return {"f64_max_residual": res, "orthonormality": ortho,
            "rq_minus_diag_max": float(np.max(np.abs(rq_sorted - low))),
            "rayleigh_quotients_head": rq_sorted[:4].tolist()}


def solve_ppcg_flagship(sym, diag, gen_s, device, tol=FLAGSHIP_TOL,
                        res_limit=FLAGSHIP_RES_LIMIT, min_iters=0,
                        phase="solve_ppcg_flagship") -> dict:
    """bench.py:1315-1360 through the public entry point: FusedPPCG on the
    K4 matvec; raises on a failed check. ``min_iters`` is the least
    iteration count the solve must take (rr_every: a full RR ran)."""
    import torch

    from iterative_solver_torch import FusedPPCG
    from iterative_solver_torch.models.synthetic_fci import implied_matmat_int8
    from iterative_solver_torch.ops.kernels.symm_int8 import int8_matvec

    t0 = time.perf_counter()
    matvec, operand = int8_matvec(sym)
    solver = FusedPPCG(matvec, diag, FLAGSHIP_N, FLAGSHIP_ROOTS,
                       rr_every=FLAGSHIP_RR_EVERY, convergence_threshold=tol,
                       max_iter=400, operand=operand)
    v0 = guess(diag, FLAGSHIP_ROOTS)
    setup_s = gen_s + time.perf_counter() - t0

    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_int8")

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _, _, _, iters2 = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall2 = time.perf_counter() - t0

    expected = ppcg_expected_launches(iters, device)
    converged = bool(np.max(errors) <= tol)
    # the implied operator diag(d) + gq gq^T * unpack(q), tile by tile
    checks = quality(x, lambda xs: implied_matmat_int8(xs, sym, diag), diag, FLAGSHIP_ROOTS)
    rec = {
        "phase": phase, "n": FLAGSHIP_N, "nroots": FLAGSHIP_ROOTS,
        "b": sym.b, "n_pairs": sym.n_pairs, "rr_every": FLAGSHIP_RR_EVERY,
        "tol": tol, "iterations": iters, "min_iterations": min_iters,
        "full_rr_steps": iters // FLAGSHIP_RR_EVERY, "converged": converged,
        "max_error": float(np.max(errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": wall2,
        "steady_iterations": iters2, "steady_seconds_per_iteration": wall2 / max(iters2, 1),
        "setup_seconds": setup_s, "generation_seconds": gen_s, **checks,
        "f64_residual_limit": res_limit, "orthonormality_limit": FLAGSHIP_ORTHO_LIMIT,
        "rq_minus_diag_limit": FLAGSHIP_SKIP_LIMIT,
        "launches": launches, "expected_launches": expected, "action_kernel": "symm_int8",
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    if iters < min_iters:
        failures.append(f"{iters} iterations < {min_iters}: no full RR ran")
    if not checks["f64_max_residual"] <= res_limit:
        failures.append(f"f64 residual {checks['f64_max_residual']:.3e} > {res_limit}")
    if not checks["orthonormality"] <= FLAGSHIP_ORTHO_LIMIT:
        failures.append(f"max|X X^T - I| {checks['orthonormality']:.3e} > "
                        f"{FLAGSHIP_ORTHO_LIMIT}")
    if not checks["rq_minus_diag_max"] <= FLAGSHIP_SKIP_LIMIT:
        failures.append(f"a root is skipped: Rayleigh quotients off the lowest diagonal "
                        f"entries by {checks['rq_minus_diag_max']:.3e} > {FLAGSHIP_SKIP_LIMIT}")
    if launches != expected or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    if min_iters == 0:
        emit(profile_solve(solver, v0, device, "profile_ppcg_flagship"))
    return rec


def profile_solve(solver, v0, device, phase: str, run=None) -> dict:
    """Device time by kernel family, the device's idle share, and the host's
    waits on the device, over one more solve of a warm solver: ``run()``,
    which returns the iteration count (default: ``run_on_device(v0)``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if run is None:
        def run():
            return solver.run_on_device(v0)[3]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_events(device)
        t0 = time.perf_counter()
        iters = run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        pad_events(device)
    families = {"K1 symm_packed": ("symm_packed",), "K2 chain": ("chain_",),
                "K4/K5 symm_int8": ("symm_int8",), "K6 bsr": ("bsr_kernel",),
                "eigh, cholesky, trsm (cuSOLVER)": (
                    "syev", "sytrd", "ormtr", "stedc", "steqr", "orgtr", "lansy",
                    "potrf", "getrf", "trsm", "trsv", "row_rotate", "cusolver", "magma"),
                "gemm, gemv (cuBLAS)": ("gemm", "gemv", "xmma", "cutlass", "sm90",
                                        "splitkreduce"),
                "memcpy": ("memcpy",),
                "elementwise, reductions (PyTorch)": ("at::native",),
                }
    by_family = {k: 0.0 for k in families}
    by_family["other"] = 0.0
    top = []
    # host-side waits on the device: scalar reads (the convergence test,
    # cuSOLVER's info checks) and the copies behind them
    sync_names = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                  "cudaDeviceSynchronize", "cudaMemcpyAsync")
    syncs = {ev.key: {"count": ev.count, "cpu_ms": ev.self_cpu_time_total / 1e3}
             for ev in prof.key_averages() if ev.key in sync_names}
    launches = 0
    for name, count, dev_us in device_events(prof):
        if not dev_us:
            continue
        fam = next((k for k, pats in families.items()
                    if any(p in name.lower() for p in pats)), "other")
        by_family[fam] += dev_us / 1e3
        launches += count
        top.append((dev_us / 1e3, count, name[:80]))
    top.sort(reverse=True)
    busy = sum(by_family.values())
    if not busy > 0:
        raise AssertionError("the profiler recorded no device time")
    return {
        "phase": phase, "iterations": iters, "wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (wall * 1e3),
        "device_ops": launches, "ms_by_family": by_family, "host_syncs": syncs,
        "top_kernels": [{"ms": t, "count": c, "name": nm} for t, c, nm in top[:12]],
    }


def profile_headline(matrix, device) -> dict:
    """``profile_solve`` over one headline solve."""
    from iterative_solver_torch import FusedDavidson

    solver = FusedDavidson.from_dense_symmetric(
        matrix, NROOTS, tier="fast", m_max=M_MAX, rr="window",
        convergence_threshold=2e-4, max_iter=60)
    v0 = guess(np.diagonal(matrix), NROOTS)
    solver.run_on_device(v0)  # warm: probe, library handles
    return profile_solve(solver, v0, device, "profile_fast")


# ---------------------------------------------------------------------------
# the sparse legs (K6, K7)


def phenol_int8_bsr(n: int = PHENOL_N, block: int = 128, pairs_per_row: int = 4,
                    n_low: int = 64, coupling: float = 0.05, seed: int = 0):
    """benchmarks/phenol_scale.py::synthetic_int8_bsr_direct, copied here
    because that module imports the JAX package: a dominant gapped f64
    diagonal and symmetric int8 coupling blocks whose density decays with
    block distance, the same draws from the same seed. Returns numpy
    ``(q, rows, cols, row_ptr, diag, s)``; the operator is
    A = diag + (s/127) Q on the stored topology (q's diagonal blocks have a
    zero diagonal)."""
    rng = np.random.default_rng(seed)
    nb = n // block
    diag = np.concatenate(
        [np.linspace(-2.0, 3.0, n_low), np.linspace(6.0, 50.0, n - n_low)]).astype(np.float64)
    # per block row, a few lower neighbours at geometric offsets
    rb = np.repeat(np.arange(nb), pairs_per_row)
    d = rng.geometric(0.25, size=rb.size)
    cb = rb - d
    keep = cb >= 0
    pairs = np.unique(rb[keep] * nb + cb[keep])
    prb = (pairs // nb).astype(np.int32)
    pcb = (pairs % nb).astype(np.int32)
    q_off = rng.integers(-127, 128, size=(prb.size, block, block), dtype=np.int8)
    q_diag = rng.integers(-127, 128, size=(nb, block, block), dtype=np.int8)
    q_diag = np.triu(q_diag, 1)
    q_diag = q_diag + q_diag.transpose(0, 2, 1)
    rows = np.concatenate([np.arange(nb, dtype=np.int32), prb, pcb])
    cols = np.concatenate([np.arange(nb, dtype=np.int32), pcb, prb])
    q_all = np.concatenate([q_diag, q_off, q_off.transpose(0, 2, 1)])
    order = np.argsort(rows, kind="stable")
    rows, cols, q_all = rows[order], cols[order], q_all[order]
    row_ptr = np.zeros(nb + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=nb), out=row_ptr[1:])
    return q_all, rows, cols, row_ptr, diag, coupling / np.sqrt(block)


def phenol_operator(device, n: int = PHENOL_N):
    """The phenol-scale operator as a float32 BSRMatrix on ``device``: the
    int8 blocks moved over and widened there, values = q (s/127), plus the
    diagonal on the diagonal blocks' own diagonals. Returns (bsr, diag f64,
    host generation seconds)."""
    import torch

    from iterative_solver_torch.ops.kernels.spmv import BSRMatrix

    t0 = time.perf_counter()
    q, rows, cols, row_ptr, diag, s = phenol_int8_bsr(n)
    gen_s = time.perf_counter() - t0
    block = q.shape[1]
    values = torch.from_numpy(q).to(device).to(torch.float32)
    del q
    values.mul_(s / 127.0)
    rows_t = torch.from_numpy(rows).to(device)
    cols_t = torch.from_numpy(cols).to(device)
    d32 = torch.as_tensor(diag, dtype=torch.float32, device=device)
    didx = torch.nonzero(rows_t == cols_t).squeeze(1)
    ar = torch.arange(block, device=device)
    values[didx[:, None], ar[None, :], ar[None, :]] += \
        d32[rows_t[didx].long()[:, None] * block + ar[None, :]]
    bsr = BSRMatrix(values=values, col_idx=cols_t, row_idx=rows_t,
                    row_ptr=torch.from_numpy(row_ptr).to(device), shape=(n, n),
                    bm=block, bn=block, diagonal=d32)
    return bsr, diag, gen_s


def bsr_matmat_f64(x, bsr, chunk: int = 2048):
    """y = x Aᵀ in float64 on x's device, the blocks widened to f64
    ``chunk`` at a time in block-row order: the yardstick for residuals."""
    import torch

    f64 = torch.float64
    x = x.to(f64)
    m = x.shape[0]
    n_rb = bsr.shape[0] // bsr.bm
    xt = x.reshape(m, -1, bsr.bn).transpose(0, 1)
    y = torch.zeros((n_rb, m, bsr.bm), dtype=f64, device=x.device)
    for start in range(0, bsr.n_blocks, chunk):
        sl = slice(start, start + chunk)
        contrib = torch.einsum("kmn,kin->kmi", xt[bsr.col_idx[sl].long()],
                               bsr.values[sl].to(f64))
        y.index_add_(0, bsr.row_idx[sl].long(), contrib)
    return y.transpose(0, 1).reshape(m, n_rb * bsr.bm)


def sparse_mm_library(x, bsr, y_ref, device) -> tuple:
    """(ms, device ms, note, max relative error): ``torch.sparse.mm`` of a
    ``sparse_bsr_tensor`` of the same operator with xᵀ, a yardstick only."""
    import torch

    note = (f"torch.sparse.mm(sparse_bsr_tensor {bsr.shape}, blocks "
            f"{bsr.bm}x{bsr.bn}, {bsr.n_blocks} blocks) @ x.T ({x.shape[1]} x {x.shape[0]})")
    try:
        a = torch.sparse_bsr_tensor(bsr.row_ptr, bsr.col_idx, bsr.values, size=bsr.shape)
        xt = x.T.contiguous()
        got = torch.sparse.mm(a, xt).T
        torch.cuda.synchronize(device)
        _, rel = rel_err(got, y_ref)
        ms = time_ms(lambda: torch.sparse.mm(a, xt), device)
        dev_ms = device_ms(lambda: torch.sparse.mm(a, xt), device, "", None)[0]
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return (None, None, f"{note}: not supported by this torch build "
                f"({str(err).splitlines()[0]})", None)
    return ms, dev_ms, note, rel


def check_sparse_kernels(bench_bsr, phenol_bsr, phenol_diag, device) -> list:
    """K6 against its plain version on the bench operator at 16 and 4 rows
    and on the phenol-scale operator at 16 rows; K7 at (64, 8192) and
    (64, 2^20) with GRAM_ACTIVE active rows; each also twice for the same
    bits. K2 at the phenol solve's shape (16 rows, a 64-row basis, n =
    2^20, the phenol diagonal)."""
    import torch

    from iterative_solver_torch.ops.kernels import gram, spmv

    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=device)
    results = []

    def bsr_case(name, bsr, m):
        x = torch.as_tensor(rng.standard_normal((m, bsr.shape[1])), **f32)
        y = spmv.bsr_matmat_kernel(x, bsr)
        y_ref = spmv.bsr_matmat(x, bsr)
        torch.cuda.synchronize(device)
        abs_err, rel = rel_err(y, y_ref)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: max relative error {rel:.3e} > {KERNEL_TOL}")
        if not torch.equal(spmv.bsr_matmat_kernel(x, bsr), y):
            raise AssertionError(f"{name}: a second call gave other bits")
        kernel_ms, plain_ms = in_turns(lambda: spmv.bsr_matmat(x, bsr),
                                       lambda: spmv.bsr_matmat_kernel(x, bsr), device)
        kernel_device_ms, call_device_ms, kernels_seen = device_ms(
            lambda: spmv.bsr_matmat_kernel(x, bsr), device, "bsr_kernel", 1)
        library_ms, library_device_ms, library_note, library_rel = sparse_mm_library(
            x, bsr, y_ref, device)
        n = bsr.shape[1]
        # the JAX kernel's CostEstimate: values, x read, y written
        nbytes = bsr.values.numel() * bsr.values.element_size() + 4 * m * n + 4 * m * bsr.shape[0]
        bound_ms, bound_by = bound(nbytes, 2.0 * m * bsr.nnz, "f32")
        del y, y_ref
        results.append({
            "name": name, "route": "cuda",
            "source": "iterative_solver_torch/ops/kernels/csrc/spmv.cu",
            "replaces": "iterative_solver_tpu/ops/kernels/spmv_pallas.py:151",
            "max_abs_err": abs_err, "max_rel_err": rel, "tolerance": KERNEL_TOL,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "index_bytes": 4 * (bsr.row_ptr.numel() + bsr.col_idx.numel()),
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library_note": library_note, "library_max_rel_err": library_rel,
            "kernel_device_ms": kernel_device_ms, "call_device_ms": call_device_ms,
            "kernels_per_call_seen": kernels_seen,
            "share_of_bound": bound_ms / kernel_device_ms,
            "work_split_columns": spmv.bsr_columns_per_cta(bsr.shape[0] // bsr.bm, bsr.bm, m),
            # what a call costs beyond its kernel's own device time
            "launch_overhead_ms": kernel_ms - kernel_device_ms,
            "shapes": {"m": m, "n": n, "bm": bsr.bm, "bn": bsr.bn,
                       "n_blocks": bsr.n_blocks, "nnz": bsr.nnz},
        })

    def gram_case(name, n):
        # the shape of a Davidson Rayleigh matrix: unit basis rows V and
        # their images W = V D under a diagonal-dominant spectrum
        v = torch.as_tensor(rng.standard_normal((M_MAX, n)) / np.sqrt(n), **f32)
        d = torch.as_tensor(np.linspace(-2.0, 50.0, n), **f32)
        w = v * d[None, :]
        mask = (torch.arange(M_MAX, device=device) < GRAM_ACTIVE).to(torch.float32)
        h = gram.masked_gram_kernel(v, w, mask)
        h_ref = gram.masked_gram(v, w, mask)
        torch.cuda.synchronize(device)
        abs_err, rel = rel_err(h, h_ref)
        if not rel <= KERNEL_TOL:
            raise AssertionError(f"{name}: max relative error {rel:.3e} > {KERNEL_TOL}")
        if not torch.equal(gram.masked_gram_kernel(v, w, mask), h):
            raise AssertionError(f"{name}: a second call gave other bits")
        kernel_ms, plain_ms = in_turns(lambda: gram.masked_gram(v, w, mask),
                                       lambda: gram.masked_gram_kernel(v, w, mask), device)
        kernel_device_ms, call_device_ms, kernels_seen = device_ms(
            lambda: gram.masked_gram_kernel(v, w, mask), device, "gram_", 1)
        library = lambda: torch.matmul(v, w.T)  # noqa: E731
        library_ms = time_ms(library, device)
        library_device_ms = device_ms(library, device, "", None)[0]
        nbytes = 4 * (2 * M_MAX * n + M_MAX + M_MAX * M_MAX)
        bound_ms, bound_by = bound(nbytes, 2.0 * M_MAX * M_MAX * n, "f32")
        results.append({
            "name": name, "route": "cuda",
            "source": "iterative_solver_torch/ops/kernels/csrc/gram.cu",
            "replaces": "iterative_solver_tpu/ops/kernels/gram_pallas.py:25",
            "max_abs_err": abs_err, "max_rel_err": rel, "tolerance": KERNEL_TOL,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "library_note": "the bare v @ w.T (f32, TF32 off), without mask or symmetrisation",
            "kernel_device_ms": kernel_device_ms, "call_device_ms": call_device_ms,
            "kernels_per_call_seen": kernels_seen, "share_of_bound": bound_ms / kernel_device_ms,
            "shapes": {"m": M_MAX, "n": n, "active": GRAM_ACTIVE, "tile": 512,
                       "chunks": gram.chunk_plan(n, M_MAX, gram._ctas(v.device))},
        })

    bsr_case("K6", bench_bsr, NROOTS)
    bsr_case("K6@m4", bench_bsr, 4)
    bsr_case("K6@phenol", phenol_bsr, NROOTS)
    gram_case("K7", SPARSE_N)
    gram_case("K7@2^20", PHENOL_N)
    # K2 at the phenol solve's shape
    r = torch.as_tensor(rng.standard_normal((PHENOL_ROOTS, PHENOL_N)), **f32)
    q, _ = torch.linalg.qr(torch.randn((PHENOL_N, M_MAX), generator=torch.Generator(
        device=device).manual_seed(5), device=device))
    results.append(chain_case("K2@phenol", r, q, phenol_diag,
                              np.sort(phenol_diag)[:PHENOL_ROOTS] - 1e-4, device))
    return results


def make_bench_bsr(device):
    """bench.py's sparse operator: (BSRMatrix on device, dense f64, seconds)."""
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr

    t0 = time.perf_counter()
    bsr, dense = synthetic_fci_bsr(SPARSE_N, block=SPARSE_BLOCK, density=0.3, seed=1,
                                   device=device)
    return bsr, dense, time.perf_counter() - t0


def solve_sparse_fused(bsr, dense, setup_s, device) -> dict:
    """tests/test_spmv.py:84-105 at n = 8192: FusedDavidson's generic
    constructor with a K6 matvec, 16 roots, m_max 64, rr "full", tol 1e-5."""
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.ops.kernels.spmv import bsr_matvec

    matvec, op = bsr_matvec(bsr)
    solver = FusedDavidson(matvec, np.diagonal(dense), SPARSE_N, NROOTS, m_max=M_MAX,
                           rr="full", convergence_threshold=1e-5, max_iter=60, operand=op)
    return solve_phase(dense, REFERENCE_SPARSE_EIGENVALUES, device, "bsr", "full", 1e-5,
                       1e-4, 1e-8, "bsr", built=(solver, setup_s),
                       phase="solve_bsr_fused_davidson")


def bsr_problem(bsr):
    """A ``Problem`` whose action is K6's wrapper on ``bsr`` (the plain
    version on CPU tensors) and whose diagonal is the operator's."""
    import iterative_solver_torch as its
    from iterative_solver_torch.ops.kernels import spmv

    class BSRProblem(its.Problem):
        def action(self, parameters):
            return spmv.bsr_matmat_kernel(parameters, bsr)

        def diagonals(self):
            return bsr.diagonal

    return BSRProblem()


def parity_solver(device, tol: float = 1e-5, offload=False, dtype=None):
    """create_linear_eigensystem(8192, 4, "Davidson") at ``tol``, hermitian,
    quiet, with the basis history in the given store form (``offload=``)."""
    import iterative_solver_torch as its

    solver = its.create_linear_eigensystem(SPARSE_N, PARITY_ROOTS, "Davidson",
                                           f"convergence_threshold={tol}", offload=offload,
                                           device=device, dtype=dtype)
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    return solver


def solve_parity(bsr, dense, device, tol: float = 1e-5, offload=False,
                 phase: str = "solve_parity_create_linear_eigensystem") -> dict:
    """The package's own entry point on the sparse operator:
    create_linear_eigensystem(8192, 4, "Davidson") with a K6 Problem."""
    import torch

    solver = parity_solver(device, tol, offload)
    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    converged, _, _ = solver.solve(np.zeros((PARITY_ROOTS, SPARSE_N)), problem=bsr_problem(bsr),
                                   generate_initial_guess=True)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("bsr")
    iters = solver.stats.iterations
    # one action per iteration; the parity Davidson takes no fused chain
    expected = {"action": iters, "chain": 0, "gram": 0}
    params, _ = solver.solution(list(range(PARITY_ROOTS)))
    xs = params.to("cpu", torch.float64).numpy()
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ dense
    rq = np.sum(xs * ax, axis=1)
    res = float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1)))
    rq_err = float(np.max(np.abs(np.sort(rq) - np.asarray(REFERENCE_SPARSE_EIGENVALUES))))
    rec = {
        "phase": phase, "n": SPARSE_N, "store": type(solver.xspace.store_v).__name__,
        "nroots": PARITY_ROOTS, "options": f"convergence_threshold={tol}",
        "converged": bool(converged), "iterations": iters,
        "max_error": float(max(solver.errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "stats": str(solver.stats),
        "eigenvalues": [float(e) for e in solver.eigenvalues()],
        "f64_max_residual": res, "f64_residual_limit": 1e-4,
        "rayleigh_quotients": np.sort(rq).tolist(), "rq_max_abs_err": rq_err,
        "rq_limit": 1e-8, "launches": launches, "expected_launches": expected,
        "action_kernel": "bsr",
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: errors {solver.errors}")
    if not res <= 1e-4:
        failures.append(f"f64 residual {res:.3e} > 1e-4")
    if not rq_err <= 1e-8:
        failures.append(f"Rayleigh quotients off by {rq_err:.3e} > 1e-8")
    if launches != expected or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError(f"{phase}[{rec['store']}]: " + "; ".join(failures))
    return rec


def phenol_solver(bsr, diag, tol=PHENOL_TOL, **kw):
    """The phenol-scale sparse FusedDavidson: 16 roots, m_max 64, rr "full",
    the fused chain (on the card); and its one-hot guess on the lowest
    diagonal entries."""
    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.ops.kernels.spmv import bsr_matvec

    matvec, op = bsr_matvec(bsr)
    solver = FusedDavidson(matvec, diag, bsr.shape[0], PHENOL_ROOTS, m_max=M_MAX, rr="full",
                           convergence_threshold=tol, max_iter=60, operand=op, **kw)
    return solver, guess(diag, PHENOL_ROOTS)


def solve_phenol(bsr, diag, gen_s, device, tol=PHENOL_TOL) -> dict:
    """``phenol_solver`` on the card; raises on a failed check."""
    import torch

    n = bsr.shape[0]
    solver, v0 = phenol_solver(bsr, diag, tol)
    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("bsr")
    t0 = time.perf_counter()
    _, _, _, iters2 = solver.run_on_device(v0)
    torch.cuda.synchronize(device)
    wall2 = time.perf_counter() - t0
    restarts = expected_restarts(iters, PHENOL_ROOTS, M_MAX)
    expected = {"action": 1 + 2 + iters + restarts, "chain": iters, "gram": 0}
    converged = bool(np.max(errors) <= tol)
    checks = quality(x, lambda xs: bsr_matmat_f64(xs, bsr), diag, PHENOL_ROOTS)
    op_bytes = sum(t.numel() * t.element_size()
                   for t in (bsr.values, bsr.row_ptr, bsr.col_idx, bsr.row_idx, bsr.diagonal))
    rec = {
        "phase": "solve_phenol_fused_davidson", "n": n, "nroots": PHENOL_ROOTS,
        "m_max": M_MAX, "rr": "full", "tol": tol, "fuse_chain": solver.fuse_chain,
        "n_blocks": bsr.n_blocks, "nnz": bsr.nnz, "operator_bytes_on_card": op_bytes,
        "generation_seconds": gen_s, "iterations": iters, "restarts": restarts,
        "converged": converged, "max_error": float(np.max(errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": wall2,
        "steady_iterations": iters2, "steady_seconds_per_iteration": wall2 / max(iters2, 1),
        **checks, "f64_residual_limit": PHENOL_RES_LIMIT,
        "orthonormality_limit": PHENOL_ORTHO_LIMIT, "rq_minus_diag_limit": PHENOL_SKIP_LIMIT,
        "launches": launches, "expected_launches": expected, "action_kernel": "bsr",
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device),
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    if not checks["f64_max_residual"] <= PHENOL_RES_LIMIT:
        failures.append(f"f64 residual {checks['f64_max_residual']:.3e} > {PHENOL_RES_LIMIT}")
    if not checks["orthonormality"] <= PHENOL_ORTHO_LIMIT:
        failures.append(f"max|X X^T - I| {checks['orthonormality']:.3e} > {PHENOL_ORTHO_LIMIT}")
    if not checks["rq_minus_diag_max"] <= PHENOL_SKIP_LIMIT:
        failures.append(f"a root is skipped: Rayleigh quotients off the lowest diagonal "
                        f"entries by {checks['rq_minus_diag_max']:.3e} > {PHENOL_SKIP_LIMIT}")
    if launches != expected or min(launches["action"], launches["chain"]) == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("solve_phenol_fused_davidson: " + "; ".join(failures))
    emit(profile_solve(solver, v0, device, "profile_phenol"))
    return rec


# ---------------------------------------------------------------------------
# the P-space Davidson, checkpoint/resume, the batched solve, the linear
# systems and the refinement


def pspace_inputs(matrix):
    """(p_space, p_actions, v0): the unit vectors of the PSPACE_P lowest
    diagonal entries as ``{index: 1.0}`` dicts, their exact f64 rows, and
    the one-hot guess on the NROOTS lowest entries outside P."""
    order = np.argsort(np.diagonal(matrix))
    p_idx = order[:PSPACE_P]
    v0 = np.zeros((NROOTS, matrix.shape[0]))
    v0[np.arange(NROOTS), order[PSPACE_P:PSPACE_P + NROOTS]] = 1.0
    return [{int(i): 1.0} for i in p_idx], matrix[p_idx].copy(), v0


def pspace_solver(matrix, **kw):
    from iterative_solver_torch import FusedDavidson

    p_space, p_actions, v0 = pspace_inputs(matrix)
    solver = FusedDavidson.from_dense_symmetric(
        matrix, NROOTS, tier="precise", rr="full", m_max=PSPACE_M_MAX,
        convergence_threshold=1e-5, max_iter=60, p_space=p_space, p_actions=p_actions, **kw)
    return solver, v0


def solve_pspace(matrix, device) -> dict:
    """The precise solve with a 32-vector P space whose actions are given:
    K3 launches for init, probe, iterations and restarts, none for P."""
    t0 = time.perf_counter()
    solver, v0 = pspace_solver(matrix)
    setup_s = time.perf_counter() - t0
    rec = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "precise", "full", 1e-5, 1e-4,
                      1e-8, "symm_split", built=(solver, setup_s), phase="solve_pspace_precise",
                      v0=v0)
    if PSPACE_ITERATIONS is not None and rec["iterations"] != PSPACE_ITERATIONS:
        raise AssertionError(f"solve_pspace_precise: {rec['iterations']} iterations, the "
                             f"port's CPU run takes {PSPACE_ITERATIONS}")
    return rec


def solve_checkpointed(matrix, device) -> dict:
    """The headline solve ("fast", rr "window", tol 2e-4) through run_fast:
    uninterrupted; then one sweep checkpointed to an .npz in a temporary
    directory; then resume_fast on a fresh solver. The resumed run must
    report the uninterrupted run's iteration count and Ritz values within
    1e-6, and a solver with another nroots must refuse the file."""
    import os
    import tempfile

    import torch

    from iterative_solver_torch import FusedDavidson

    def solver(max_iter=60, nroots=NROOTS):
        return FusedDavidson.from_dense_symmetric(
            matrix, nroots, tier="fast", m_max=M_MAX, rr="window",
            convergence_threshold=2e-4, max_iter=max_iter)

    v0 = guess(np.diagonal(matrix), NROOTS)
    steps = (M_MAX - NROOTS) // NROOTS
    launches = {}
    reset_launches()
    full_evals, _, full_errors, full_iters = solver().run_fast(v0)
    torch.cuda.synchronize(device)
    launches["uninterrupted"] = solve_launches("symm_bf16")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "davidson.npz")
        reset_launches()
        _, _, _, first_iters = solver(max_iter=steps).run_fast(v0, checkpoint_path=path)
        torch.cuda.synchronize(device)
        launches["interrupted"] = solve_launches("symm_bf16")
        size = os.path.getsize(path)
        reset_launches()
        t0 = time.perf_counter()
        evals, _, errors, iters = solver().resume_fast(path)
        torch.cuda.synchronize(device)
        resume_s = time.perf_counter() - t0
        launches["resumed"] = solve_launches("symm_bf16")
        try:
            solver(nroots=8).resume_fast(path)
            refused = None
        except ValueError as err:
            refused = str(err)
    sweeps = -(-full_iters // steps)
    expected = {
        "uninterrupted": {"action": 1 + 2 + full_iters + sweeps - 1, "chain": full_iters,
                          "gram": 0},
        "interrupted": {"action": 1 + 2 + first_iters, "chain": first_iters, "gram": 0},
        # no init and no probe: a restart before each remaining sweep (none
        # where the interrupted sweep already converged)
        "resumed": {"action": sweeps - 1 + iters - first_iters,
                    "chain": iters - first_iters, "gram": 0},
    }
    evals_err = float(np.max(np.abs(np.sort(evals) - np.sort(full_evals))))
    rec = {
        "phase": "solve_checkpoint_resume", "tier": "fast", "rr": "window",
        "m_max": M_MAX, "sweep_steps": steps, "tol": 2e-4,
        "checkpoint_converged": first_iters == full_iters,
        "uninterrupted_iterations": full_iters, "interrupted_iterations": first_iters,
        "resumed_iterations": iters, "max_error": float(np.max(errors)),
        "uninterrupted_max_error": float(np.max(full_errors)),
        "ritz_values_max_abs_diff": evals_err, "ritz_limit": 1e-6,
        "checkpoint_bytes": size, "resume_seconds": resume_s,
        "refused_other_nroots": refused, "launches": launches,
        "expected_launches": expected, "action_kernel": "symm_bf16",
    }
    emit(rec)
    failures = []
    if iters != full_iters:
        failures.append(f"resumed after {iters} iterations, uninterrupted {full_iters}")
    if not np.max(errors) <= 2e-4:
        failures.append(f"resumed run not converged: {np.max(errors):.3e}")
    if not evals_err <= 1e-6:
        failures.append(f"Ritz values differ by {evals_err:.3e} > 1e-6")
    if refused is None:
        failures.append("a solver with nroots=8 accepted the checkpoint")
    if launches != expected:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("solve_checkpoint_resume: " + "; ".join(failures))
    return rec


def batched_scan_inputs():
    """examples/batched_scan.py's scan at BATCH_POINTS x n = BATCH_N:
    couplings 0.1/sqrt(n) from default_rng(0), diagonal linspace(0, 12, n),
    coupling strength linspace(0.2, 1.2); the one-hot guesses."""
    rng = np.random.default_rng(0)
    n = BATCH_N
    base = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    base = base + base.T
    mats = np.stack([lam * base + np.diag(np.linspace(0.0, 12.0, n))
                     for lam in np.linspace(0.2, 1.2, BATCH_POINTS)])
    diags = np.stack([np.diag(m) for m in mats])
    v0 = np.stack([guess(d, BATCH_ROOTS) for d in diags])
    return mats, diags, v0


def solve_batched(device) -> dict:
    """make_batched_davidson_solve on the scan in float32 at tol 1e-5, and
    the same 8 systems solved one after another by the chunked solve; both
    timed on a second call (steady)."""
    import torch

    from iterative_solver_torch.solvers import fused_davidson as fd

    mats, diags, v0 = batched_scan_inputs()
    f32 = dict(dtype=torch.float32, device=device)
    tm, td, tv = (torch.as_tensor(a, **f32) for a in (mats, diags, v0))

    def matvec(x, op):
        return torch.matmul(x, op.T)

    binit, bsolve = fd.make_batched_davidson_solve(matvec, BATCH_ROOTS, BATCH_M_MAX)
    init = fd.make_davidson_init(matvec, BATCH_ROOTS, BATCH_M_MAX)
    chunked = fd.make_davidson_solve_chunked(matvec, BATCH_ROOTS, BATCH_M_MAX)

    def batched():
        return bsolve(binit(tv, tm), tm, td, BATCH_TOL, 800)

    def sequential():
        return [chunked(init(tv[p], tm[p]), tm[p], td[p], BATCH_TOL, 800)
                for p in range(BATCH_POINTS)]

    walls = {}
    for name, fn in (("batched", batched), ("sequential", sequential)):
        for _ in range(2):  # the second call is steady
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(device)
            walls[name] = time.perf_counter() - t0
        if name == "batched":
            final, iters = out
        else:
            seq = out
    errs, eig_errs = [], []
    for p in range(BATCH_POINTS):
        ref = np.linalg.eigvalsh(mats[p])[:BATCH_ROOTS]
        ev = np.sort(final.evals[p].double().cpu().numpy())
        errs.append(float(final.errors[p].max()))
        eig_errs.append(float(np.max(np.abs(ev - ref))))
    seq_iters = [int(it) for _, it in seq]
    rec = {
        "phase": "solve_batched_scan", "points": BATCH_POINTS, "n": BATCH_N,
        "nroots": BATCH_ROOTS, "m_max": BATCH_M_MAX, "tol": BATCH_TOL, "dtype": "float32",
        "iterations": iters.tolist(), "sequential_iterations": seq_iters,
        "max_errors": errs, "eigenvalue_errors": eig_errs, "eigenvalue_limit": 1e-5,
        "batched_steady_seconds": walls["batched"],
        "sequential_steady_seconds": walls["sequential"],
        "speedup": walls["sequential"] / walls["batched"],
    }
    emit(rec)
    failures = []
    if not max(errs) <= BATCH_TOL:
        failures.append(f"an element is not converged: {errs}")
    if not max(eig_errs) <= 1e-5:
        failures.append(f"eigenvalues off eigvalsh by {max(eig_errs):.3e} > 1e-5")
    if failures:
        raise AssertionError("solve_batched_scan: " + "; ".join(failures))
    return rec


LINEAR_KEYS = {"fast": "symm_bf16", "precise": "symm_split", "exact": "symm_f32",
               "int8": "symm_int8", "int8_precise": "symm_int8_split"}


def linear_rhs(n: int) -> np.ndarray:
    return np.random.default_rng(LINEAR_RHS_SEED).standard_normal((NROOTS, n))


def linear_quality(x, matrix, b, x_ref) -> dict:
    """The f64 relative residual ||A x - b|| / ||b|| against the f64 matrix
    and the relative error ||x - A^-1 b|| / ||A^-1 b||, each the max over
    the right-hand sides."""
    x = np.asarray(x, dtype=np.float64)
    res = np.linalg.norm(x @ matrix - b, axis=1) / np.linalg.norm(b, axis=1)
    err = np.linalg.norm(x - x_ref, axis=1) / np.linalg.norm(x_ref, axis=1)
    return {"f64_relative_residual": float(res.max()), "f64_solution_error": float(err.max())}


def linear_solver(shifted, tier, **kw):
    from iterative_solver_torch import FusedLinearEquations

    return FusedLinearEquations.from_dense_symmetric(
        shifted, NROOTS, tier=tier, convergence_threshold=LINEAR_TOLS[tier], max_iter=60,
        **kw)


def profile_linear(shifted, b, device) -> dict:
    """``profile_solve`` over one "precise" linear solve of a warm solver."""
    solver = linear_solver(shifted, "precise")
    solver.solve(b)  # warm: probe, library handles
    return profile_solve(solver, None, device, "profile_linear_precise",
                         run=lambda: solver.solve(b)[2])


def solve_linear(shifted, b, x_ref, device, tier) -> dict:
    """FusedLinearEquations.from_dense_symmetric(bench + 3 I, 16, tier) on
    the 16 right-hand sides, fused chain (K2 in raw mode) on."""
    import torch

    t0 = time.perf_counter()
    solver = linear_solver(shifted, tier)
    setup_s = time.perf_counter() - t0
    key = LINEAR_KEYS[tier]
    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x, errors, iters = solver.solve(b)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches(key)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _, _, iters2 = solver.solve(b)
    torch.cuda.synchronize(device)
    wall2 = time.perf_counter() - t0
    restarts = expected_restarts(iters, NROOTS, solver.m_max)
    expected = {"action": 1 + 2 + iters + restarts, "chain": iters, "gram": 0}
    tol = LINEAR_TOLS[tier]
    checks = linear_quality(x.cpu().numpy(), shifted, b, x_ref)
    res_limit, err_limit = LINEAR_LIMITS[tier]
    rec = {
        "phase": f"solve_linear_{tier}", "tier": tier, "n": shifted.shape[0],
        "nrhs": NROOTS, "m_max": solver.m_max, "tol": tol, "fuse_chain": solver.fuse_chain,
        "iterations": iters, "restarts": restarts, "converged": bool(np.max(errors) <= tol),
        "max_error": float(np.max(errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": wall2,
        "steady_seconds_per_iteration": wall2 / max(iters2, 1), "setup_seconds": setup_s,
        **checks, "f64_residual_limit": res_limit, "f64_solution_error_limit": err_limit,
        "launches": launches, "expected_launches": expected, "action_kernel": key,
    }
    emit(rec)
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    if not checks["f64_relative_residual"] <= res_limit:
        failures.append(f"f64 relative residual {checks['f64_relative_residual']:.3e} > "
                        f"{res_limit}")
    if not checks["f64_solution_error"] <= err_limit:
        failures.append(f"f64 solution error {checks['f64_solution_error']:.3e} > {err_limit}")
    if launches != expected or min(launches["action"], launches["chain"]) == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError(f"solve_linear_{tier}: " + "; ".join(failures))
    return rec


def precise_solver(matrix, device=None, dtype=None):
    """bench.py's precise leg: tier "precise", 16 roots, rr "full", tol
    1e-5."""
    from iterative_solver_torch import FusedDavidson

    return FusedDavidson.from_dense_symmetric(
        matrix, NROOTS, tier="precise", m_max=M_MAX, rr="full", convergence_threshold=1e-5,
        max_iter=60, device=device, dtype=dtype)


def precise_start(matrix, device) -> np.ndarray:
    """The refinement's input: the precise solve's Ritz rows in float64 on
    the host (float32 working precision)."""
    import torch

    solver = precise_solver(matrix, device, torch.float32)
    x = solver.run_on_device(guess(np.diagonal(matrix), NROOTS))[1]
    return x.detach().to("cpu", torch.float64).numpy()


def refine_precise(matrix, device) -> dict:
    """bench.py's precise_1e8 leg: the precise solve (16 roots, rr "full",
    tol 1e-5), then EigenpairRefiner with the f64 action (on the card) and
    the K3 matvec for the deflated CG corrections, to 1e-8; and
    refine_on_host from the same vectors. The record's "x0" (popped by the
    caller) is the refinement's input, for the sharded refinement."""
    import torch

    from iterative_solver_torch.ops.precise import refine_on_host
    from iterative_solver_torch.solvers.refine import EigenpairRefiner

    solver = precise_solver(matrix)
    diag = np.diagonal(matrix)
    _, x, _, solve_iters = solver.run_on_device(guess(diag, NROOTS))
    x = x.detach().to("cpu", torch.float64).numpy()
    a64 = torch.as_tensor(matrix, dtype=torch.float64, device=device)

    def action_f64(xs):
        return (torch.as_tensor(xs, dtype=torch.float64, device=device) @ a64).cpu().numpy()

    refiner = EigenpairRefiner(action_f64, solver.matvec, solver.operand, diag,
                               matrix.shape[0], NROOTS)
    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = refiner.refine(x, tol=REFINE_TOL)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_split")
    del a64
    # each pass: the CG init's action, then one per CG iteration
    expected = {"action": sum(1 + it for it in refiner.cg_iterations), "chain": 0, "gram": 0}
    rq_err = float(np.max(np.abs(np.sort(out.eigenvalues)[:4] - REFERENCE_EIGENVALUES)))
    t0 = time.perf_counter()
    _, hx, hinfo = refine_on_host(matrix, x, NROOTS)
    host_s = time.perf_counter() - t0
    hx = hx / np.linalg.norm(hx, axis=1, keepdims=True)
    hax = hx @ matrix
    host_res = float(np.max(np.linalg.norm(hax - np.sum(hx * hax, axis=1)[:, None] * hx,
                                           axis=1)))
    rec = {
        "phase": "refine_precise_1e8", "solve_iterations": solve_iters,
        "floor_before": out.history[0], "history": out.history, "passes": out.passes,
        "cg_iterations": refiner.cg_iterations, "converged": out.converged,
        "f64_max_residual": float(out.residual_norms.max()), "f64_residual_limit": REFINE_TOL,
        "rq_max_abs_err": rq_err, "rq_limit": REFINE_RQ_LIMIT, "seconds": wall,
        "refine_on_host_iterations": hinfo.iterations,
        "refine_on_host_f64_residual": host_res, "refine_on_host_seconds": host_s,
        "launches": launches, "expected_launches": expected, "action_kernel": "symm_split",
    }
    emit(rec)
    failures = []
    if not out.converged or not out.residual_norms.max() <= REFINE_TOL:
        failures.append(f"not refined to {REFINE_TOL}: history {out.history}")
    if not rq_err <= REFINE_RQ_LIMIT:
        failures.append(f"eigenvalues off by {rq_err:.3e} > {REFINE_RQ_LIMIT}")
    if launches != expected or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("refine_precise_1e8: " + "; ".join(failures))
    rec["x0"] = x
    return rec


def shifted_bsr_problem(bsr, shift: float = LINEAR_SHIFT):
    """A ``Problem`` whose action is K6's wrapper on ``bsr`` plus ``shift``
    times the identity, and whose diagonal is shifted the same way."""
    import iterative_solver_torch as its
    from iterative_solver_torch.ops.kernels import spmv

    class ShiftedBSRProblem(its.Problem):
        def action(self, parameters):
            return spmv.bsr_matmat_kernel(parameters, bsr) + shift * parameters

        def diagonals(self):
            return bsr.diagonal + shift

    return ShiftedBSRProblem()


def parity_linear_solve(bsr, device, problem=None, **kw):
    """create_linear_equations(8192, 4, "Davidson", "convergence_threshold=
    1e-5") on the shifted sparse operator (``problem``, by default
    ``shifted_bsr_problem(bsr)``) with 4 right-hand sides from
    default_rng(3). Returns (solver, converged, rhs, seconds)."""
    import torch

    import iterative_solver_torch as its

    rhs = np.random.default_rng(PARITY_LINEAR_RHS_SEED).standard_normal(
        (PARITY_ROOTS, SPARSE_N))
    solver = its.create_linear_equations(SPARSE_N, PARITY_ROOTS, "Davidson",
                                         "convergence_threshold=1e-5", device=device, **kw)
    solver.verbosity = its.Verbosity.NONE
    solver.add_equations(rhs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    converged, _, _ = solver.solve(np.zeros((PARITY_ROOTS, SPARSE_N)),
                                   problem=problem or shifted_bsr_problem(bsr),
                                   generate_initial_guess=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return solver, converged, rhs, time.perf_counter() - t0


def parity_linear_residual(solver, dense, rhs) -> float:
    import torch

    x = solver.solution_params(list(range(PARITY_ROOTS))).to("cpu", torch.float64).numpy()
    ax = x @ dense + LINEAR_SHIFT * x
    return float(np.max(np.linalg.norm(ax - rhs, axis=1) / np.linalg.norm(rhs, axis=1)))


def solve_parity_linear(bsr, dense, device) -> dict:
    """The package's linear-equations entry point with a K6 Problem; one K6
    launch per iteration; the iteration count and stats of the port's CPU
    run."""
    reset_launches()
    solver, converged, rhs, wall = parity_linear_solve(bsr, device)
    launches = solve_launches("bsr")
    iters = solver.stats.iterations
    stats = str(solver.stats)  # before solution_params adds its own gemm counts
    expected = {"action": iters, "chain": 0, "gram": 0}
    res = parity_linear_residual(solver, dense, rhs)
    rec = {
        "phase": "solve_parity_create_linear_equations", "n": SPARSE_N,
        "nrhs": PARITY_ROOTS, "shift": LINEAR_SHIFT, "options": "convergence_threshold=1e-5",
        "converged": bool(converged), "iterations": iters, "cpu_iterations":
        PARITY_LINEAR_ITERATIONS, "stats": stats, "cpu_stats": PARITY_LINEAR_STATS,
        "max_error": float(max(solver.errors)), "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "f64_relative_residual": res,
        "f64_residual_limit": PARITY_LINEAR_RES_LIMIT, "launches": launches,
        "expected_launches": expected, "action_kernel": "bsr",
    }
    emit(rec)
    failures = []
    if not converged:
        failures.append(f"not converged: errors {solver.errors}")
    if not res <= PARITY_LINEAR_RES_LIMIT:
        failures.append(f"f64 relative residual {res:.3e} > {PARITY_LINEAR_RES_LIMIT}")
    if iters != PARITY_LINEAR_ITERATIONS or stats != PARITY_LINEAR_STATS:
        failures.append(f"{iters} iterations, stats {stats}: the CPU run has "
                        f"{PARITY_LINEAR_ITERATIONS}, {PARITY_LINEAR_STATS}")
    if launches != expected or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("solve_parity_create_linear_equations: " + "; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# the nonlinear families and the gradients: K1-f32 forward in every matvec,
# value and gradient, and again as its own adjoint in the backward of
# make_differentiable_symm_action


def packed_exact(matrix, device, dtype=None):
    """The "exact" tier's packed operator (K1-f32 on the card) of ``matrix``."""
    from iterative_solver_torch.ops.kernels import symm

    return symm.SymmetricBlocked.from_dense(matrix, b=NONLINEAR_B, dtype=dtype, device=device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lbfgs_solver(shifted, b, device, dtype=None):
    """FusedLBFGS minimising f(x) = 1/2 xᵀ(A+3I)x − bᵀx, with g from
    torch.autograd.grad through make_differentiable_symm_action: each
    evaluation launches K1 once forward and once as its own adjoint.
    Returns (solver, evaluations), ``evaluations[0]`` counting the calls."""
    import torch

    from iterative_solver_torch import FusedLBFGS
    from iterative_solver_torch.ops.kernels import symm

    sym = packed_exact(shifted, device, dtype)
    action = symm.make_differentiable_symm_action(sym)
    bt = torch.as_tensor(b, dtype=sym.values.dtype, device=sym.values.device)
    evaluations = [0]

    def value_and_grad(x, values):
        evaluations[0] += 1
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = 0.5 * torch.dot(x, action(x[None, :], values)[0]) - torch.dot(bt, x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    solver = FusedLBFGS(value_and_grad, shifted.shape[0], history=LBFGS_HISTORY,
                        dtype=sym.values.dtype, convergence_threshold=LBFGS_TOL,
                        max_iter=LBFGS_MAX_ITER, operand=sym.values, device=device)
    return solver, evaluations


def relative_error(x, x_ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))


def solve_lbfgs(shifted, b, x_ref, device) -> dict:
    """FusedLBFGS on the bench matrix + 3 I (``lbfgs_solver``), history 10,
    from x = 0: gnorm <= LBFGS_TOL, the f64 relative error against
    np.linalg.solve, the iteration count of the port's CPU float32 run
    within 2, and K1-f32 launches two per evaluation (forward and adjoint);
    then a profile of one more solve."""
    n = shifted.shape[0]
    t0 = time.perf_counter()
    solver, evaluations = lbfgs_solver(shifted, b, device)
    setup_s = time.perf_counter() - t0
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    x, f, gnorm, iters = solver.run(np.zeros(n))
    sync(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_f32")
    evals = evaluations[0]
    err = relative_error(x.cpu().numpy(), x_ref)
    sync(device)
    t0 = time.perf_counter()
    iters2 = solver.run(np.zeros(n))[3]
    sync(device)
    wall2 = time.perf_counter() - t0
    # K1 adds in a fixed order, so the same input gives the same f and g
    # bits, and the Armijo tests near the stop the same branches: equal
    # evaluation counts over three calls (this, the steady and the profiled)
    call_evaluations = [evals, evaluations[0] - evals]
    expected = {"action": 2 * evals, "chain": 0, "gram": 0}
    rec = {
        "phase": "solve_lbfgs", "n": n, "history": LBFGS_HISTORY, "tol": LBFGS_TOL,
        "iterations": iters, "cpu_iterations": LBFGS_ITERATIONS, "evaluations": evals,
        "adjoint_launches": evals, "gnorm": gnorm, "f": f, "f64_solution_error": err,
        "f64_solution_error_limit": LBFGS_ERR_LIMIT, "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": wall2,
        "steady_seconds_per_iteration": wall2 / max(iters2, 1), "setup_seconds": setup_s,
        "launches": launches, "expected_launches": expected, "action_kernel": "symm_f32",
    }
    emit(rec)
    failures = []
    if not gnorm <= LBFGS_TOL:
        failures.append(f"gradient norm {gnorm:.3e} > {LBFGS_TOL}")
    if not err <= LBFGS_ERR_LIMIT:
        failures.append(f"f64 solution error {err:.3e} > {LBFGS_ERR_LIMIT}")
    if abs(iters - LBFGS_ITERATIONS) > 2:
        failures.append(f"{iters} iterations, the port's CPU float32 run takes "
                        f"{LBFGS_ITERATIONS}")
    if launches != expected or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("solve_lbfgs: " + "; ".join(failures))
    before = evaluations[0]
    emit(profile_solve(solver, None, device, "profile_lbfgs",
                       run=lambda: solver.run(np.zeros(n))[3]))
    call_evaluations.append(evaluations[0] - before)
    rec["evaluations_by_call"] = call_evaluations
    emit({"phase": "lbfgs_repeat", "evaluations_by_call": call_evaluations})
    if len(set(call_evaluations)) != 1:
        raise AssertionError(f"solve_lbfgs: evaluations differ over three calls on the same "
                             f"input: {call_evaluations}")
    return rec


def diis_solver(shifted, b, device, dtype=None):
    """FusedDIIS on r(x) = (A+3I)x + DIIS_EPS x∘x − b (the form of
    tests/test_fused_diis.py's quadratic), the action K1-f32's wrapper,
    Jacobi on diag(A+3I), a history of DIIS_M."""
    import dataclasses

    import torch

    from iterative_solver_torch import FusedDIIS
    from iterative_solver_torch.ops.kernels import symm

    sym = packed_exact(shifted, device, dtype)
    bt = torch.as_tensor(b, dtype=sym.values.dtype, device=sym.values.device)

    def residual(x, values):
        s = dataclasses.replace(sym, values=values)
        return symm.symm_matmat_kernel(x[None, :], s)[0] + DIIS_EPS * x * x - bt

    return FusedDIIS(residual, shifted.shape[0], max_size_qspace=DIIS_M,
                     dtype=sym.values.dtype, convergence_threshold=DIIS_TOL,
                     max_iter=DIIS_MAX_ITER, operand=sym.values,
                     diagonals=np.diagonal(shifted), device=device)


def diis_residual_f64(x, shifted, b) -> float:
    """||(A+3I)x + eps x∘x − b|| / ||b|| in float64 on the host."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(shifted @ x + DIIS_EPS * x * x - b) / np.linalg.norm(b))


def solve_fused_diis(shifted, b, device) -> dict:
    """FusedDIIS (``diis_solver``) from x = 0: err <= DIIS_TOL, the f64
    relative residual recomputed on the host, the iteration count of the
    port's CPU float32 run within 2, one K1-f32 launch per residual."""
    n = shifted.shape[0]
    solver = diis_solver(shifted, b, device)
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    x, err, iters = solver.run(np.zeros(n))
    sync(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_f32")
    res = diis_residual_f64(x.cpu().numpy(), shifted, b)
    sync(device)
    t0 = time.perf_counter()
    iters2 = solver.run(np.zeros(n))[2]
    sync(device)
    wall2 = time.perf_counter() - t0
    expected = {"action": 1 + iters, "chain": 0, "gram": 0}
    rec = {
        "phase": "solve_fused_diis", "n": n, "m": DIIS_M, "eps": DIIS_EPS, "tol": DIIS_TOL,
        "iterations": iters, "cpu_iterations": DIIS_ITERATIONS, "err": err,
        "f64_relative_residual": res, "f64_residual_limit": DIIS_RES_LIMIT, "seconds": wall,
        "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": wall2,
        "steady_seconds_per_iteration": wall2 / max(iters2, 1), "launches": launches,
        "expected_launches": expected, "action_kernel": "symm_f32",
    }
    emit(rec)
    failures = []
    if not err <= DIIS_TOL:
        failures.append(f"err {err:.3e} > {DIIS_TOL}")
    if not res <= DIIS_RES_LIMIT:
        failures.append(f"f64 relative residual {res:.3e} > {DIIS_RES_LIMIT}")
    if abs(iters - DIIS_ITERATIONS) > 2:
        failures.append(f"{iters} iterations, the port's CPU float32 run takes "
                        f"{DIIS_ITERATIONS}")
    if launches != expected:
        failures.append(f"launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("solve_fused_diis: " + "; ".join(failures))
    return rec


def parity_nonlinear_solves(shifted, x_ref, device):
    """The parity entry points in float64 with dense torch.matmul (as JAX's
    jnp.matmul): create_optimize(n, "BFGS", "max_size_qspace=6") and
    create_optimize(n, "SD") on QuadraticOptimizeProblem(A+3I, x_ref), whose
    minimiser is x_ref = np.linalg.solve(A+3I, b) (its value differs from
    the L-BFGS objective by a constant), and create_nonlinear_equations(n,
    "DIIS", "max_size_qspace=8") on TrigNonlinearProblem(n). Yields (method,
    solver, converged, x as f64 numpy, seconds)."""
    import torch

    import iterative_solver_torch as its

    n = shifted.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    quadratic = its.models.QuadraticOptimizeProblem(shifted, x_ref, **f64)
    cases = (("BFGS", its.create_optimize, quadratic),
             ("SD", its.create_optimize, quadratic),
             ("DIIS", its.create_nonlinear_equations, its.models.TrigNonlinearProblem(n, **f64)))
    for method, factory, problem in cases:
        solver = factory(n, method, PARITY_NONLINEAR[method][0], **f64)
        solver.verbosity = its.Verbosity.NONE
        sync(device)
        t0 = time.perf_counter()
        converged, x, _ = solver.solve(np.zeros((1, n)), problem=problem)
        sync(device)
        yield (method, solver, converged, x[0].to("cpu", torch.float64).numpy(),
               time.perf_counter() - t0)


def trig_residual_f64(x) -> float:
    """||x + a sin x − b|| of TrigNonlinearProblem's a, b (default_rng(42))."""
    rng = np.random.default_rng(42)
    a = 0.3 + 0.2 * rng.random(x.shape[0])
    b = rng.standard_normal(x.shape[0])
    return float(np.linalg.norm(x + a * np.sin(x) - b))


def solve_parity_nonlinear(shifted, x_ref, device) -> dict:
    """``parity_nonlinear_solves`` on the card: each converged, with the
    iteration count and stats (line searches included) of the port's CPU
    run; the quadratic solutions within PARITY_NONLINEAR_X_LIMIT of
    np.linalg.solve, the trigonometric residual within PARITY_TRIG_RES_LIMIT
    in f64."""
    reset_launches()
    runs, failures = {}, []
    for method, solver, converged, x, wall in parity_nonlinear_solves(shifted, x_ref, device):
        _, cpu_iters, cpu_stats = PARITY_NONLINEAR[method]
        stats = str(solver.stats)
        check = (float(np.max(np.abs(x - x_ref))) if method != "DIIS"
                 else trig_residual_f64(x))
        limit = PARITY_NONLINEAR_X_LIMIT if method != "DIIS" else PARITY_TRIG_RES_LIMIT
        runs[method] = {
            "options": PARITY_NONLINEAR[method][0], "converged": bool(converged),
            "iterations": solver.stats.iterations, "cpu_iterations": cpu_iters,
            "line_searches": solver.stats.line_searches, "stats": stats,
            "cpu_stats": cpu_stats, "seconds": wall,
            "seconds_per_iteration": wall / max(solver.stats.iterations, 1),
            ("max_abs_error" if method != "DIIS" else "f64_residual"): check, "limit": limit,
        }
        if not converged:
            failures.append(f"{method} not converged: errors {solver.errors}")
        if not check <= limit:
            failures.append(f"{method}: {check:.3e} > {limit}")
        if solver.stats.iterations != cpu_iters or stats != cpu_stats:
            failures.append(f"{method}: {solver.stats.iterations} iterations, stats {stats}: "
                            f"the CPU run has {cpu_iters}, {cpu_stats}")
    launches = {k: read_launches(k) for k in ("symm_f32", "symm_bf16", "symm_split", "bsr")}
    rec = {"phase": "solve_parity_nonlinear", "n": shifted.shape[0], "dtype": "float64",
           "runs": runs, "launches": launches}
    emit(rec)
    if any(launches.values()):
        failures.append(f"a packed or sparse kernel ran on the dense path: {launches}")
    if failures:
        raise AssertionError("solve_parity_nonlinear: " + "; ".join(failures))
    return rec


def implicit_inputs(matrix, device, dtype=None, plain=False):
    """(sym, matvec, v0, diag) of the differentiable solves: the bench
    matrix packed in the exact tier; the matvec the differentiable action
    (K1-f32 on the card), or with ``plain`` the plain symm_matmat (autograd
    through its einsums); the one-hot guess on the IMPLICIT_ROOTS lowest
    diagonal entries."""
    import dataclasses

    import torch

    from iterative_solver_torch.ops.kernels import symm

    sym = packed_exact(matrix, device, dtype)
    like = dict(dtype=sym.values.dtype, device=sym.values.device)
    if plain:
        def matvec(x, values):
            return symm.symm_matmat(x, dataclasses.replace(sym, values=values))
    else:
        matvec = symm.make_differentiable_symm_action(sym)
    diag = np.diagonal(matrix)
    return (sym, matvec, torch.as_tensor(guess(diag, IMPLICIT_ROOTS), **like),
            torch.as_tensor(diag, **like))


def implicit_eigenvalues(matrix, device, dtype=None) -> dict:
    """make_differentiable_eigenvalues (IMPLICIT_ROOTS roots, m_max
    IMPLICIT_M_MAX, tol IMPLICIT_TOL) on operand values * s, diagonal * s,
    at s = 1; the gradient of sum_i w_i lambda_i with respect to s and to
    the tiles. Returns the numbers the checks read."""
    import torch

    from iterative_solver_torch import make_differentiable_eigenvalues

    sym, matvec, v0, diag = implicit_inputs(matrix, device, dtype)
    fn = make_differentiable_eigenvalues(matvec, IMPLICIT_ROOTS, IMPLICIT_M_MAX,
                                         tol=IMPLICIT_TOL, max_iter=IMPLICIT_MAX_ITER)
    values = sym.values.detach().clone().requires_grad_(True)
    s = torch.ones((), dtype=values.dtype, device=values.device, requires_grad=True)
    w = torch.as_tensor(IMPLICIT_WEIGHTS, dtype=values.dtype, device=values.device)
    lam = fn(v0, values * s, diag * s)
    x = lam.grad_fn.saved_tensors[0].to("cpu", torch.float64).numpy()  # the solver's own x
    (w * lam).sum().backward()
    lam = lam.detach().to("cpu", torch.float64).numpy()
    total = float(np.dot(IMPLICIT_WEIGHTS, lam))
    # vbar against sum_i w_i x_i x_iᵀ on the tiles (twice off the diagonal:
    # an off-diagonal tile feeds both A_ij and A_ji), formed in f64
    b = sym.b
    vbar = values.grad.to("cpu", torch.float64).numpy()
    wx = np.asarray(IMPLICIT_WEIGHTS)[:, None] * x
    worst = scale = 0.0
    for t, (i, j) in enumerate(zip(sym.ii.tolist(), sym.jj.tolist())):
        blk = wx[:, i * b:(i + 1) * b].T @ x[:, j * b:(j + 1) * b]
        blk = blk if i == j else 2.0 * blk
        worst = max(worst, float(np.max(np.abs(vbar[t] - blk))))
        scale = max(scale, float(np.max(np.abs(blk))))
    return {"iterations": fn.last_iterations, "eigenvalues": lam.tolist(),
            "ds": float(s.grad), "weighted_sum": total,
            "ds_relative_error": abs(float(s.grad) - total) / abs(total),
            "vbar_relative_error": worst / scale}


def implicit_eigenpairs(matrix, device, dtype=None, plain=False, tol=None,
                        response_tol=None) -> tuple:
    """make_differentiable_eigenpairs (IMPLICIT_ROOTS roots, m_max
    IMPLICIT_M_MAX) and the tile gradient of <x_0|M|x_0>, M diagonal from
    default_rng(EIGENPAIR_M_SEED): the lowest root's, as
    tests/test_implicit_diff.py differentiates x[0]. (A cotangent on more
    than one root does not converge: the block response solve shares one
    basis across rows whose operators differ, in both packages; ROADMAP.md
    Queue 3.) Returns (gradient as f64 numpy, info)."""
    import torch

    from iterative_solver_torch import make_differentiable_eigenpairs

    sym, matvec, v0, diag = implicit_inputs(matrix, device, dtype, plain=plain)
    fn = make_differentiable_eigenpairs(
        matvec, IMPLICIT_ROOTS, IMPLICIT_M_MAX, tol=tol or IMPLICIT_TOL,
        max_iter=IMPLICIT_MAX_ITER, response_tol=response_tol or EIGENPAIR_RESPONSE_TOL,
        response_max_iter=EIGENPAIR_RESPONSE_MAX_ITER)
    values = sym.values.detach().clone().requires_grad_(True)
    m_diag = torch.as_tensor(np.random.default_rng(EIGENPAIR_M_SEED).standard_normal(
        matrix.shape[0]), dtype=values.dtype, device=values.device)
    _, x = fn(v0, values, diag)
    (x[0] * x[0] * m_diag).sum().backward()
    r_iters, r_errors = fn.last_response
    grad = values.grad.to("cpu", torch.float64).numpy()
    return grad, {"iterations": fn.last_iterations, "response_iterations": r_iters,
                  "response_max_error": float(r_errors.max())}


def solve_implicit_diff(matrix, device) -> dict:
    """The differentiable eigenvalues through K1-f32 (forward in the solve,
    the tile cotangent in the backward): d(sum w lambda)/ds at s = 1 equals
    sum w lambda, and vbar equals the f64 outer-product tiles of the
    solver's own x, within their calibrated limits; the eigenvalues within
    IMPLICIT_RQ_LIMIT of REFERENCE_EIGENVALUES. Then make_differentiable_eigenpairs for
    <x_0|M|x_0>: its response solve converges, and its tile gradient matches the same
    function with the plain action in float64 on the card within
    EIGENPAIR_LIMIT. K1-f32 launches: the solve's (init, iterations,
    restarts), one for the Rayleigh quotients and one for the backward's
    forward call; for the eigenpairs also the response solve's."""
    import torch

    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    eig = implicit_eigenvalues(matrix, device)
    sync(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_f32")
    iters = eig["iterations"]
    restarts = expected_restarts(iters, IMPLICIT_ROOTS, IMPLICIT_M_MAX)
    expected = {"action": 1 + iters + restarts + 2, "chain": 0, "gram": 0}
    rq_err = float(np.max(np.abs(np.sort(eig["eigenvalues"]) - REFERENCE_EIGENVALUES)))

    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    grad, pair = implicit_eigenpairs(matrix, device)
    sync(device)
    pair_wall = time.perf_counter() - t0
    pair_launches = solve_launches("symm_f32")
    grad64, pair64 = implicit_eigenpairs(matrix, device, torch.float64, plain=True,
                                         tol=1e-9, response_tol=1e-8)
    pair_err = float(np.max(np.abs(grad - grad64)) / np.max(np.abs(grad64)))
    del grad, grad64
    rec = {
        "phase": "implicit_diff", "n": matrix.shape[0], "nroots": IMPLICIT_ROOTS,
        "m_max": IMPLICIT_M_MAX, "tol": IMPLICIT_TOL, **eig, "restarts": restarts,
        "rq_max_abs_err": rq_err, "rq_limit": IMPLICIT_RQ_LIMIT, "ds_limit": IMPLICIT_DS_LIMIT,
        "vbar_limit": IMPLICIT_VBAR_LIMIT, "seconds": wall, "launches": launches,
        "expected_launches": expected, "action_kernel": "symm_f32",
        "eigenpairs": {**pair, "response_tol": EIGENPAIR_RESPONSE_TOL, "seconds": pair_wall,
                       "float64_plain": pair64, "gradient_relative_error": pair_err,
                       "limit": EIGENPAIR_LIMIT, "launches": pair_launches},
        "cpu_iterations": IMPLICIT_ITERATIONS,
    }
    emit(rec)
    failures = []
    if not eig["ds_relative_error"] <= IMPLICIT_DS_LIMIT:
        failures.append(f"d lambda/ds off lambda by {eig['ds_relative_error']:.3e} > "
                        f"{IMPLICIT_DS_LIMIT}")
    if not eig["vbar_relative_error"] <= IMPLICIT_VBAR_LIMIT:
        failures.append(f"vbar off the outer-product tiles by "
                        f"{eig['vbar_relative_error']:.3e} > {IMPLICIT_VBAR_LIMIT}")
    if not rq_err <= IMPLICIT_RQ_LIMIT:
        failures.append(f"eigenvalues off by {rq_err:.3e} > {IMPLICIT_RQ_LIMIT}")
    if abs(iters - IMPLICIT_ITERATIONS) > 2:
        failures.append(f"{iters} iterations, the port's CPU float32 run takes "
                        f"{IMPLICIT_ITERATIONS}")
    if launches != expected:
        failures.append(f"launches {launches} != expected {expected}")
    if not pair["response_max_error"] <= EIGENPAIR_RESPONSE_TOL:
        failures.append(f"the response solve did not converge: {pair}")
    if not pair_err <= EIGENPAIR_LIMIT:
        failures.append(f"eigenpair gradient off the float64 plain run by {pair_err:.3e} > "
                        f"{EIGENPAIR_LIMIT}")
    if pair_launches["action"] == 0 or pair_launches["gram"] or pair_launches["chain"]:
        failures.append(f"eigenpair launches {pair_launches}")
    if failures:
        raise AssertionError("implicit_diff: " + "; ".join(failures))
    return rec


def check_symm_adjoint(matrix, device) -> dict:
    """K1-f32 as its own adjoint on the bench operator: y, xbar and vbar
    from make_differentiable_symm_action against plain autograd through
    symm_matmat (1e-5 of the plain result's max magnitude) at each of
    ADJOINT_ROWS rows of x; at one row, the main path's shape, the adjoint
    launch (K1 on the cotangent) timed against its plain version and the
    dense f32 matmul, and the whole backward against the plain version's
    backward."""
    import dataclasses

    import torch

    from iterative_solver_torch.ops.kernels import symm

    sym = packed_exact(matrix, device, torch.float32)
    action = symm.make_differentiable_symm_action(sym)
    rng = np.random.default_rng(11)
    n = matrix.shape[0]

    def plain(x, values):
        return symm.symm_matmat(x, dataclasses.replace(sym, values=values))

    def graph(fn, x0):
        x = x0.clone().requires_grad_(True)
        values = sym.values.clone().requires_grad_(True)
        return fn(x, values), x, values

    errors = {}
    for m in ADJOINT_ROWS:
        x0 = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=device)
        ybar = torch.as_tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=device)
        out = {}
        for name, fn in (("kernel", action), ("kernel again", action), ("plain", plain)):
            y, x, values = graph(fn, x0)
            out[name] = (y.detach(), *torch.autograd.grad(y, (x, values), ybar))
        sync(device)
        if not all(torch.equal(a, b) for a, b in zip(out["kernel"], out["kernel again"])):
            raise AssertionError(f"K1 adjoint at {m} x {n}: a second call gave other bits")
        errors[m] = {part: rel_err(k, p) for part, k, p in
                     zip(("y", "xbar", "vbar"), out["kernel"], out["plain"])}
        del out
        worst = max(rel for _, rel in errors[m].values())
        if not worst <= KERNEL_TOL:
            raise AssertionError(f"K1 adjoint at {m} x {n}: relative errors {errors[m]} > "
                                 f"{KERNEL_TOL}")
    # x0 and ybar are the last rows': one, the shape L-BFGS and DIIS launch.
    # The adjoint launch is K1 on the cotangent; its plain version symm_matmat
    kernel_ms, plain_ms = in_turns(lambda: symm.symm_matmat(ybar, sym),
                                   lambda: symm.symm_matmat_kernel(ybar, sym), device)
    kernel_device_ms = device_ms(lambda: symm.symm_matmat_kernel(ybar, sym), device,
                                 "symm_packed", SYMM_KERNELS)[0]
    library, library_note = symm_library(sym, ybar)
    library_ms = time_ms(library, device)
    del library
    y_k, xk, vk = graph(action, x0)
    y_p, xp, vp = graph(plain, x0)
    backward_ms, plain_backward_ms = in_turns(
        lambda: torch.autograd.grad(y_p, (xp, vp), ybar, retain_graph=True),
        lambda: torch.autograd.grad(y_k, (xk, vk), ybar, retain_graph=True), device)
    del y_k, y_p
    torch.cuda.empty_cache()
    m = ADJOINT_ROWS[-1]
    nbytes = sym.values.numel() * 4 + 8 * sym.n_pairs + 2 * 4 * m * n
    bound_ms, bound_by = bound(nbytes, symm_flops(sym, m, 1), "f32")
    return {
        "name": "K1-f32-adjoint", "route": "cuda",
        "source": "iterative_solver_torch/ops/kernels/csrc/symm_packed.cu",
        "replaces": K1_REPLACES + " (as its own adjoint, symm_pallas.py:396-444)",
        "max_abs_err": max(a for e in errors.values() for a, _ in e.values()),
        "rel_err_by_rows": {str(k): {part: rel for part, (_, rel) in e.items()}
                            for k, e in errors.items()},
        "tolerance": KERNEL_TOL, "ms": kernel_ms, "plain_ms": plain_ms,
        "kernel_device_ms": kernel_device_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_note": library_note,
        "backward_ms": backward_ms, "plain_backward_ms": plain_backward_ms,
        "share_of_bound": bound_ms / kernel_device_ms, "same_bits": True,
        "shapes": {"m": m, "n": n, "b": sym.b, "n_pairs": sym.n_pairs,
                   "checked_rows": list(ADJOINT_ROWS)},
    }


# ---------------------------------------------------------------------------
# The C ABI (bindings/, ROADMAP.md Queue 1 item 7b): the instance-stack API
# in this process, then the embedded shared library built with cffi and the
# repository's C example run against it.

C_API_TOL = 1e-5
C_API_EXAMPLE = os.path.join("examples", "c", "linear_eigensystem_c.c")
# the port's CPU run of c_api_loop (float64 solver, float32 plain action;
# calibrate_sharded_cpu.py c_api)
C_API_ITERATIONS = 3


def c_api_loop(matrix, device, action):
    """The parity Davidson through bindings/c_api.py as a C program drives
    it: Initialize (4 roots, tol C_API_TOL, hermitian; the device the
    option store's, else the card), SetDiagonals, then AddVector with
    ``action(rows)`` and, while EndIterationNeeded, the Jacobi update at
    the working set's eigenvalues (as examples/c/linear_eigensystem_c.c)
    and EndIteration; Eigenvalues, Errors, Solution, Finalize. Returns
    (eigenvalues, errors, solution rows, iterations, stats, action calls,
    the stack depth after Finalize)."""
    from iterative_solver_torch.bindings import c_api

    n, nroot = matrix.shape[0], PARITY_ROOTS
    diag = np.diagonal(matrix)
    c_api.IterativeSolverLinearEigensystemInitialize(n, nroot, thresh=C_API_TOL,
                                                     hermitian=True)
    c_api.IterativeSolverSetDiagonals(diag)
    solver = c_api._top().solver
    params, actions = np.zeros((nroot, n)), np.zeros((nroot, n))
    for r, i in enumerate(np.argsort(diag)[:nroot]):
        params[r, i] = 1.0
    nwork, calls = nroot, 0
    for _ in range(c_api.IterativeSolverMaxIter()):
        actions[:nwork] = action(params[:nwork])
        calls += 1
        nwork = c_api.IterativeSolverAddVector(nwork, params, actions)
        while c_api.IterativeSolverEndIterationNeeded():
            if nwork > 0:
                ev = np.zeros(nroot)
                c_api.IterativeSolverWorkingSetEigenvalues(ev)
                actions[:nwork] /= diag[None, :] - ev[:nwork, None] + 1e-15
            nwork = c_api.IterativeSolverEndIteration(nwork, params, actions)
        if nwork < 1:
            break
    evals, errors = np.zeros(nroot), np.zeros(nroot)
    c_api.IterativeSolverEigenvalues(evals)
    c_api.IterativeSolverErrors(errors)
    p, r = np.zeros((nroot, n)), np.zeros((nroot, n))
    c_api.IterativeSolverSolution(nroot, np.arange(nroot, dtype=np.int32), p, r)
    iters, stats = solver.stats.iterations, str(solver.stats)
    c_api.IterativeSolverFinalize()
    return evals, errors, p, iters, stats, calls, len(c_api._stack)


def k1_host_action(sym, device):
    """``action(rows)``: host float64 rows through K1-f32 on ``device``,
    back as host float64."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    def action(rows):
        x = torch.as_tensor(rows, dtype=torch.float32, device=device)
        return symm.symm_matmat_kernel(x, sym).to("cpu", torch.float64).numpy()

    return action


def run_embedded_example(tmp: str) -> dict:
    """Build libiterative_solver_torch_c.so with cffi into ``tmp``, compile
    C_API_EXAMPLE against the repository's include/iterative_solver_c.h
    with gcc and run it with the device unset (the card): its exit code,
    its "C ABI OK" line and no exception inside the library."""
    import sysconfig

    from iterative_solver_torch.bindings import build_embedded

    root = os.path.dirname(os.path.abspath(__file__))
    lib = os.path.join(tmp, "lib")
    t0 = time.perf_counter()
    build_embedded.build(lib)
    build_s = time.perf_counter() - t0
    exe = os.path.join(tmp, "linear_eigensystem_c")
    subprocess.run(["gcc", "-O2", os.path.join(root, C_API_EXAMPLE), "-I",
                    os.path.join(root, "include"), "-L", lib, "-literative_solver_torch_c",
                    "-lm", "-o", exe], check=True, capture_output=True, text=True)
    env = dict(os.environ)
    env.pop("ITERATIVE_SOLVER_DEVICE", None)
    # the embedded interpreter finds the port and this interpreter's packages
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in sys.path if p and os.path.isdir(p)])
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        [lib, sysconfig.get_config_var("LIBDIR") or "", env.get("LD_LIBRARY_PATH", "")])
    t0 = time.perf_counter()
    run = subprocess.run([exe], env=env, capture_output=True, text=True, timeout=300)
    return {"example": C_API_EXAMPLE, "build_seconds": build_s,
            "run_seconds": time.perf_counter() - t0, "returncode": run.returncode,
            "stdout_tail": run.stdout[-400:], "stderr_tail": run.stderr[-2000:],
            "ok": run.returncode == 0 and "C ABI OK" in run.stdout
            and "Traceback" not in run.stderr}


def solve_c_api(matrix, device) -> dict:
    """The ``c_api`` phase: ``c_api_loop`` on the bench matrix with K1-f32
    actions (one launch per AddVector): converged to C_API_TOL, the parity
    phase's limits on the returned solutions (f64 residual 1e-4, Rayleigh
    quotients 1e-8), the CPU run's iterations within 2, the stack empty
    after Finalize; then ``run_embedded_example``."""
    import tempfile

    import torch

    sym = packed_exact(matrix, device)
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    evals, errors, p, iters, stats, calls, depth = c_api_loop(matrix, device,
                                                              k1_host_action(sym, device))
    sync(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_f32")
    q = dense_quality(torch.as_tensor(p), matrix, REFERENCE_EIGENVALUES[:PARITY_ROOTS])
    rec = {"phase": "c_api", "n": matrix.shape[0], "nroots": PARITY_ROOTS, "tol": C_API_TOL,
           "solver_dtype": "float64", "iterations": iters, "cpu_iterations": C_API_ITERATIONS,
           "stats": stats, "eigenvalues": evals.tolist(), "max_error": float(errors.max()),
           "seconds": wall, "seconds_per_iteration": wall / max(iters, 1),
           "stack_after_finalize": depth, "launches": launches,
           "expected_launches": {"action": calls, "chain": 0, "gram": 0},
           "f64_max_residual": q["f64_max_residual"], "rq_max_abs_err": q["rq_max_abs_err"]}
    failures = []
    if not errors.max() <= C_API_TOL:
        failures.append(f"errors {errors} > {C_API_TOL}")
    if not q["f64_max_residual"] <= 1e-4:
        failures.append(f"f64 residual {q['f64_max_residual']:.3e} > 1e-4")
    if not q["rq_max_abs_err"] <= 1e-8:
        failures.append(f"Rayleigh quotients off by {q['rq_max_abs_err']:.3e} > 1e-8")
    if abs(iters - C_API_ITERATIONS) > 2:
        failures.append(f"{iters} iterations, the CPU run {C_API_ITERATIONS}")
    if depth != 0:
        failures.append(f"{depth} instances left on the stack")
    if launches != rec["expected_launches"] or launches["action"] == 0:
        failures.append(f"launches {launches} != expected {rec['expected_launches']}")
    with tempfile.TemporaryDirectory() as tmp:
        rec["embedded"] = run_embedded_example(tmp)
    if not rec["embedded"]["ok"]:
        failures.append(f"the C example through the embedded library: {rec['embedded']}")
    emit(rec)
    if failures:
        raise AssertionError("c_api: " + "; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# the non-hermitian family on dense operators (FusedNonSymDavidson,
# FusedNonSymLinearEquations, the batched makers): no kernel of the port's
# own; the int8 tiers' product is torch._int_mm

NONSYM_N = 8192
NONSYM_ROOTS = 16
NONSYM_M_MAX = 64
NONSYM_MAX_ITER = 60
# the 16 lowest eigenvalues of nonsym_matrix() (all real), from the JAX
# package in float64 on the CPU at tol 1e-10 (iterative_solver_tpu is not
# imported here; this is the command that made them):
#   JAX_PLATFORMS=cpu python3 -c "import jax; jax.config.update('jax_enable_x64',
#   True); import numpy as np, chip_smoke as cs; from iterative_solver_tpu.solvers.
#   fused_nonsym import FusedNonSymDavidson as F; m = cs.nonsym_matrix(); print(np.sort(
#   F.from_dense(m, 16, m_max=64, convergence_threshold=1e-10, max_iter=200,
#   rr='device').solve(cs.guess(np.diag(m), 16))[0].real).tolist())"
NONSYM_REFERENCE_EIGENVALUES = [
    -2.0004406610982146,
    -1.9348673393689209,
    -1.8706305249293471,
    -1.806997349289577,
    -1.7435177966899316,
    -1.6774764447739834,
    -1.6140605893701148,
    -1.5495517960820235,
    -1.4824988726174586,
    -1.4194170020419967,
    -1.3562063135425835,
    -1.2903577930314512,
    -1.2270795687902576,
    -1.1616343362227177,
    -1.0942895488987368,
    -1.0309247670758168,
]
# tier: (tol, f64 residual limit, eigenvalue limit, the port's CPU float32
# iterations with rr "device") -- calibrate_nonsym_cpu.py eigen
NONSYM_TIERS = {"precise": (2e-4, 2e-4, 2e-4, 3), "int8_precise": (5e-4, 5e-4, 2e-4, 3),
                "fast": (1e-3, 1e-2, 1e-2, 3), "int8": (1e-3, 3e-3, 2e-4, 3)}
# the port's CPU float32 iterations of the precise tier with rr "host"
NONSYM_HOST_ITERATIONS = 3
# complex pairs at full width: tests/test_fused_nonsym.py's pair_heavy(n, 0,
# 0.8, 0.1, 0.10): 6 pairs below the spectrum, 6 roots (3 pairs), m_max 24
PAIR_ROOTS = 6
PAIR_M_MAX = 24
PAIR_MAX_ITER = 600
PAIR_TOL, PAIR_RES_LIMIT, PAIR_EV_LIMIT = 2e-4, 1e-3, 2e-4
# chunks of 8 iterations: the solve escalates at a chunk's end while the
# errors exceed 30 tol (with 64-iteration chunks the CPU float32 run never
# escalates and takes 492 iterations; with 8, 90)
PAIR_CHUNK = 8
# its 6 lowest eigenvalues (3 conjugate pairs), from the JAX package in
# float64 on the CPU at tol 1e-10:
#   JAX_PLATFORMS=cpu python3 -c "import jax; jax.config.update('jax_enable_x64',
#   True); import numpy as np, chip_smoke as cs; from iterative_solver_tpu.solvers.
#   fused_nonsym import FusedNonSymDavidson as F; m = cs.pair_matrix(); print(np.sort_complex(
#   F.from_dense(m, 6, m_max=24, convergence_threshold=1e-10, max_iter=2000,
#   rr='device').solve(cs.guess(np.diag(m), 6))[0]).tolist())"
PAIR_REFERENCE_EIGENVALUES = [
    complex(-1.9522977452508645, -0.7357865383365246),
    complex(-1.9522977452508645, 0.7357865383365246),
    complex(-1.7536964664917867, -0.7357390982278067),
    complex(-1.7536964664917867, 0.7357390982278067),
    complex(-1.5488736379338952, -0.73559176013413),
    complex(-1.5488736379338952, 0.73559176013413),
]
# the linear twin on nonsym_matrix() + 3 I, 16 right-hand sides from
# default_rng(2), m_max 64: tier: (tol, f64 relative residual limit, error
# limit against np.linalg.solve, CPU float32 iterations with rr "device",
# with rr "host") -- calibrate_nonsym_cpu.py linear
NONSYM_LINEAR_TIERS = {"precise": (1e-5, 5e-6, 5e-6, 3, 3), "int8_precise": (1e-5, 2e-5, 2e-5, 3, 3)}
# batched: TestBatchedNonSym._batch's generator at 8 x n = 1024, 3 roots,
# m_max 12, float32 -- calibrate_nonsym_cpu.py batched
NONSYM_BATCH = (8, 1024, 3, 12)
# tol 2e-4: the device-RR iteration floors near 5e-5 in float32 in both
# packages (at 1e-5 the port and JAX both run to max_iter: 201 iterations,
# best 7.8e-5 and 5.5e-5)
NONSYM_BATCH_TOL, NONSYM_BATCH_EV_LIMIT = 2e-4, 2e-4
# four shifts of nonsym_matrix() + 3 I with 2 right-hand sides, one shared
# operator (operand_axes=(None, 0)), m_max 12 -- calibrate_nonsym_cpu.py
# shifted. The error limit is 5 tol (the shifted operators' condition is
# at most 23): the CPU float32 run stops deeper (errors 4.9e-7, solution
# errors up to 5.9e-7) than an H100 run (4.6e-6, 6.3e-6)
NONSYM_SHIFTS = (0.0, 0.4, 0.9, 1.5)
NONSYM_SHIFT_TOL, NONSYM_SHIFT_ERR_LIMIT = 1e-5, 5e-5
# checkpoint and resume: chunks of one iteration (phase a takes 3), the
# first solve stopped after 2
NONSYM_CHUNK = 1
NONSYM_STOP = 2


def nonsym_matrix(n: int = NONSYM_N) -> np.ndarray:
    """bench.py's leg_nonsym operator: couplings 0.05/sqrt(n) from
    default_rng(7), diagonal linspace(-2, 0, 32) and linspace(2, 20, n - 32),
    the strict lower triangle scaled by 0.9."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.concatenate([np.linspace(-2.0, 0.0, 32),
                                          np.linspace(2.0, 20.0, n - 32)]))
    return np.where(np.tri(n, k=-1, dtype=bool), m * 0.9, m)


def pair_matrix(n: int = NONSYM_N, npairs: int = 6) -> np.ndarray:
    """tests/test_fused_nonsym.py::TestAutoEscalatingRR.pair_heavy(n, 0, 0.8,
    0.1, 0.10): 6 rotation blocks (conjugate pairs) below a real spectrum."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    lows = np.arange(2 * npairs) * 0.10 - 2.0
    m = a + a.T + np.diag(np.concatenate([lows, np.linspace(2.0, 20.0, n - 2 * npairs)]))
    for k in range(0, 2 * npairs, 2):
        m[k, k + 1] += 0.8
        m[k + 1, k] -= 0.8
    return np.where(np.tri(n, k=-1, dtype=bool), m * 0.85, m)


def nonsym_solver(matrix, tier, rr, tol, device, dtype=None, nroots=NONSYM_ROOTS,
                  m_max=NONSYM_M_MAX, max_iter=NONSYM_MAX_ITER, **kw):
    from iterative_solver_torch import FusedNonSymDavidson

    return FusedNonSymDavidson.from_dense(matrix, nroots, tier=tier, rr=rr, m_max=m_max,
                                          convergence_threshold=tol, max_iter=max_iter,
                                          device=device, dtype=dtype, **kw)


def nonsym_quality(x, evals, a64) -> dict:
    """f64 residuals of the returned rows against the operator ``a64`` (f64,
    on its device): a real root's ||x Aᵀ − λ x|| / ||x||; a conjugate
    pair's 2 x 2 block Λ on (x_p, x_q), from least squares, with
    ||X Aᵀ − Λ X|| / ||X|| and how far eig(Λ) lies from the pair."""
    import torch

    X = x.to(a64.device, torch.float64)
    AX = X @ a64.T
    real, pairs, pair_ev = [], [], []
    i = 0
    while i < len(evals):
        if evals[i].imag == 0:
            real.append(float((AX[i] - evals[i].real * X[i]).norm() / X[i].norm()))
            i += 1
            continue
        X2, AX2 = X[i:i + 2], AX[i:i + 2]
        lam2 = torch.linalg.lstsq(X2.T, AX2.T).solution.T
        pairs.append(float((AX2 - lam2 @ X2).norm() / X2.norm()))
        w2 = np.sort_complex(np.linalg.eigvals(lam2.cpu().numpy()))
        pair_ev.append(float(np.max(np.abs(w2 - np.sort_complex(np.asarray(evals[i:i + 2]))))))
        i += 2
    worst = max(real + pairs) if real + pairs else float("nan")
    return {"f64_max_residual": worst, "f64_real_residuals_max": max(real, default=0.0),
            "f64_pair_residuals": pairs, "pair_block_eigenvalue_errors": pair_ev}


def eigenvalue_error(evals, ref) -> float:
    """Max |λ − ref| with both sorted (complex: by real part, then
    imaginary)."""
    got = np.sort_complex(np.asarray(evals, dtype=np.complex128))
    want = np.sort_complex(np.asarray(ref, dtype=np.complex128))[:len(got)]
    return float(np.max(np.abs(got - want)))


def kernel_launches() -> dict:
    """Every kernel wrapper's counts: the dense non-hermitian path launches
    none of the port's kernels."""
    return {k: v for d in launch_counters() for k, v in d.items()}


def timed_solves(solve, device) -> tuple:
    """(result, seconds, steady seconds, steady iterations): ``solve()``
    twice, the second the steady one."""
    sync(device)
    t0 = time.perf_counter()
    out = solve()
    sync(device)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2 = solve()
    sync(device)
    return out, wall, time.perf_counter() - t0, out2


def solve_nonsym(matrix, a64, device, tier, rr, phase=None) -> dict:
    """One FusedNonSymDavidson solve at bench.py's leg_nonsym settings: 16
    roots, m_max 64, max_iter 60, the one-hot guess on the 16 lowest
    diagonal entries; converged, the f64 residuals of the rows, the
    eigenvalues against NONSYM_REFERENCE_EIGENVALUES, the iteration count
    of the port's CPU float32 run within 2, no kernel of the port
    launched."""
    tol, res_limit, ev_limit, cpu_iters = NONSYM_TIERS[tier]
    if rr == "host":
        cpu_iters = NONSYM_HOST_ITERATIONS
    phase = phase or f"solve_nonsym_{tier}_{rr}"
    t0 = time.perf_counter()
    solver = nonsym_solver(matrix, tier, rr, tol, device)
    setup_s = time.perf_counter() - t0
    v0 = guess(np.diag(matrix), NONSYM_ROOTS)
    reset_launches()

    def run():
        solver.iterations = 0
        return solver.solve(v0)

    (evals, x, errors, iters), wall, steady, again = timed_solves(run, device)
    launches = kernel_launches()
    rec = {"phase": phase, "tier": tier, "rr": rr, "n": matrix.shape[0],
           "nroots": NONSYM_ROOTS, "m_max": NONSYM_M_MAX, "tol": tol, "iterations": iters,
           "cpu_float32_iterations": cpu_iters, "roots_returned": len(evals),
           "max_error": float(np.max(errors)), "converged": bool(np.max(errors) <= tol),
           "seconds": wall, "seconds_per_iteration": wall / max(iters, 1),
           "steady_seconds": steady, "steady_seconds_per_iteration": steady / max(again[3], 1),
           "setup_seconds": setup_s, "rr_steps_active": solver.rr_steps_active,
           **nonsym_quality(x, evals, a64), "f64_residual_limit": res_limit,
           "eigenvalue_max_abs_err": eigenvalue_error(evals, NONSYM_REFERENCE_EIGENVALUES),
           "eigenvalue_limit": ev_limit, "imaginary_max": float(np.max(np.abs(evals.imag))),
           "kernel_launches": launches}
    emit(rec)
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: {rec['max_error']:.3e} > {tol}")
    if len(evals) != NONSYM_ROOTS or rec["imaginary_max"] != 0.0:
        failures.append(f"{len(evals)} roots, imaginary parts up to {rec['imaginary_max']}")
    if not rec["f64_max_residual"] <= res_limit:
        failures.append(f"f64 residual {rec['f64_max_residual']:.3e} > {res_limit}")
    if not rec["eigenvalue_max_abs_err"] <= ev_limit:
        failures.append(f"eigenvalues {rec['eigenvalue_max_abs_err']:.3e} > {ev_limit}")
    if abs(iters - cpu_iters) > 2 or again[3] != iters:
        failures.append(f"{iters} (then {again[3]}) iterations, the CPU float32 run "
                        f"takes {cpu_iters}")
    if any(launches.values()):
        failures.append(f"the dense path launched a kernel: {launches}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return rec


def solve_nonsym_pairs(device) -> dict:
    """Complex pairs at full width: pair_matrix(), 6 roots, m_max 24, rr
    "device", chunks of PAIR_CHUNK iterations: the solve must escalate to two refinement passes, converge,
    and give the pairs of PAIR_REFERENCE_EIGENVALUES."""
    import torch

    t0 = time.perf_counter()
    matrix = pair_matrix()
    a64 = torch.as_tensor(matrix, dtype=torch.float64, device=device)
    solver = nonsym_solver(matrix, "precise", "device", PAIR_TOL, device, nroots=PAIR_ROOTS,
                           m_max=PAIR_M_MAX, max_iter=PAIR_MAX_ITER, chunk_iters=PAIR_CHUNK)
    setup_s = time.perf_counter() - t0
    v0 = guess(np.diag(matrix), PAIR_ROOTS)

    def run():
        solver.iterations = 0
        return solver.solve(v0)

    (evals, x, errors, iters), wall, steady, again = timed_solves(run, device)
    rec = {"phase": "solve_nonsym_pairs", "n": matrix.shape[0], "nroots": PAIR_ROOTS,
           "m_max": PAIR_M_MAX, "tol": PAIR_TOL, "iterations": iters,
           "max_error": float(np.max(errors)), "converged": bool(np.max(errors) <= PAIR_TOL),
           "rr_steps_active": solver.rr_steps_active,
           "eigenvalues": [[float(e.real), float(e.imag)] for e in evals],
           "eigenvalue_max_abs_err": eigenvalue_error(evals, PAIR_REFERENCE_EIGENVALUES),
           "eigenvalue_limit": PAIR_EV_LIMIT, **nonsym_quality(x, evals, a64),
           "f64_residual_limit": PAIR_RES_LIMIT, "seconds": wall,
           "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": steady,
           "steady_seconds_per_iteration": steady / max(again[3], 1),
           "setup_seconds": setup_s}
    emit(rec)
    del a64
    failures = []
    if solver.rr_steps_active != 2:
        failures.append("did not escalate to two refinement passes")
    if not rec["converged"]:
        failures.append(f"not converged: {rec['max_error']:.3e} > {PAIR_TOL}")
    if not np.all(np.abs(np.asarray(evals).imag) > 0.1):
        failures.append(f"eigenvalues {evals} are not three conjugate pairs")
    if not rec["eigenvalue_max_abs_err"] <= PAIR_EV_LIMIT:
        failures.append(f"eigenvalues {rec['eigenvalue_max_abs_err']:.3e} > {PAIR_EV_LIMIT}")
    if not rec["f64_max_residual"] <= PAIR_RES_LIMIT:
        failures.append(f"f64 residual {rec['f64_max_residual']:.3e} > {PAIR_RES_LIMIT}")
    if failures:
        raise AssertionError("solve_nonsym_pairs: " + "; ".join(failures))
    return rec


def nonsym_linear_solver(shifted, tier, rr, device, dtype=None):
    from iterative_solver_torch import FusedNonSymLinearEquations

    return FusedNonSymLinearEquations.from_dense(
        shifted, NONSYM_ROOTS, tier=tier, rr=rr, m_max=NONSYM_M_MAX,
        convergence_threshold=NONSYM_LINEAR_TIERS[tier][0], max_iter=NONSYM_MAX_ITER,
        device=device, dtype=dtype)


def nonsym_linear_quality(x, a64, b, x_ref) -> dict:
    import torch

    X = x.to(a64.device, torch.float64)
    bt = torch.as_tensor(b, dtype=torch.float64, device=a64.device)
    res = (X @ a64.T - bt).norm(dim=1) / bt.norm(dim=1)
    err = relative_error(X.cpu().numpy(), x_ref)
    return {"f64_relative_residual": float(res.max()), "f64_solution_error": err}


def solve_nonsym_linear(shifted, a64, b, x_ref, device, tier, rr) -> dict:
    """FusedNonSymLinearEquations on nonsym_matrix() + 3 I with 16
    right-hand sides: converged, the f64 relative residual and the error
    against np.linalg.solve within their limits, the CPU float32
    iterations within 2."""
    tol, res_limit, err_limit, it_device, it_host = NONSYM_LINEAR_TIERS[tier]
    cpu_iters = it_device if rr == "device" else it_host
    t0 = time.perf_counter()
    solver = nonsym_linear_solver(shifted, tier, rr, device)
    setup_s = time.perf_counter() - t0
    reset_launches()

    def run():
        solver.iterations = 0
        return solver.solve(b)

    (x, errors, iters), wall, steady, again = timed_solves(run, device)
    launches = kernel_launches()
    rec = {"phase": f"solve_nonsym_linear_{tier}_{rr}", "tier": tier, "rr": rr,
           "n": shifted.shape[0], "nrhs": b.shape[0], "m_max": NONSYM_M_MAX, "tol": tol,
           "iterations": iters, "cpu_float32_iterations": cpu_iters,
           "max_error": float(np.max(errors)), "converged": bool(np.max(errors) <= tol),
           **nonsym_linear_quality(x, a64, b, x_ref), "f64_residual_limit": res_limit,
           "solution_error_limit": err_limit, "seconds": wall,
           "seconds_per_iteration": wall / max(iters, 1), "steady_seconds": steady,
           "steady_seconds_per_iteration": steady / max(again[2], 1),
           "setup_seconds": setup_s, "kernel_launches": launches}
    emit(rec)
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: {rec['max_error']:.3e} > {tol}")
    if not rec["f64_relative_residual"] <= res_limit:
        failures.append(f"f64 residual {rec['f64_relative_residual']:.3e} > {res_limit}")
    if not rec["f64_solution_error"] <= err_limit:
        failures.append(f"solution error {rec['f64_solution_error']:.3e} > {err_limit}")
    if abs(iters - cpu_iters) > 2:
        failures.append(f"{iters} iterations, the CPU float32 run takes {cpu_iters}")
    if any(launches.values()):
        failures.append(f"the dense path launched a kernel: {launches}")
    if failures:
        raise AssertionError(f"{rec['phase']}: " + "; ".join(failures))
    return rec


def nonsym_batch_inputs():
    """tests/test_fused_nonsym.py::TestBatchedNonSym._batch at NONSYM_BATCH:
    couplings 0.04/sqrt(n) from default_rng(0), diagonal linspace(1 + 0.2 b,
    20, n), the strict lower triangle scaled by 0.9."""
    nb, n, r, _ = NONSYM_BATCH
    rng = np.random.default_rng(0)
    ops = []
    for b in range(nb):
        a = rng.standard_normal((n, n)) * (0.04 / np.sqrt(n))
        m = a + a.T + np.diag(np.linspace(1.0 + 0.2 * b, 20.0, n))
        m[np.tril_indices(n, -1)] *= 0.9
        ops.append(m)
    ops = np.stack(ops)
    diags = np.stack([np.diag(m) for m in ops])
    return ops, diags, np.stack([guess(d, r) for d in diags])


def dense_matvec(x, op):
    import torch

    return torch.matmul(x, op.T)


def solve_nonsym_batched(device, dtype=None) -> dict:
    """make_batched_nonsym_solve over NONSYM_BATCH, then
    finalize_nonsym_batch: every element's rotated errors and the f64
    residuals of its rotated rows within 2 tol, its eigenvalues within
    NONSYM_BATCH_EV_LIMIT of scipy's dense eig."""
    import scipy.linalg
    import torch

    from iterative_solver_torch import finalize_nonsym_batch, make_batched_nonsym_solve

    dtype = dtype or torch.float32
    nb, n, r, m_max = NONSYM_BATCH
    ops, diags, v0 = nonsym_batch_inputs()
    f = dict(dtype=dtype, device=device)
    ops_t, diags_t, v0_t = (torch.as_tensor(a, **f) for a in (ops, diags, v0))
    binit, bsolve = make_batched_nonsym_solve(dense_matvec, r, m_max)

    def run():
        out = bsolve(*binit(v0_t, ops_t), ops_t, diags_t, NONSYM_BATCH_TOL, 200)
        return out, finalize_nonsym_batch(out[3], out[4], out[5])

    ((out, (evals, x_rot, errors)), wall, steady, _) = timed_solves(run, device)
    iters = out[6].tolist()
    ev_err, res = [], []
    for b in range(nb):
        ref = scipy.linalg.eigvals(ops[b])
        ref = ref[np.argsort(ref.real)][:r]
        ev_err.append(eigenvalue_error(evals[b], ref))
        a64 = torch.as_tensor(ops[b], dtype=torch.float64, device=device)
        res.append(nonsym_quality(x_rot[b], evals[b], a64)["f64_max_residual"])
    rec = {"phase": "solve_nonsym_batched", "batch": nb, "n": n, "nroots": r, "m_max": m_max,
           "tol": NONSYM_BATCH_TOL, "iterations": iters,
           "max_error": float(max(np.max(e) for e in errors)),
           "eigenvalue_max_abs_err": max(ev_err), "eigenvalue_limit": NONSYM_BATCH_EV_LIMIT,
           "f64_max_residual": max(res), "seconds": wall, "steady_seconds": steady,
           "steady_seconds_per_iteration": steady / max(max(iters), 1)}
    emit(rec)
    failures = []
    if not rec["max_error"] <= 2 * NONSYM_BATCH_TOL:
        failures.append(f"rotated errors {rec['max_error']:.3e} > 2 x {NONSYM_BATCH_TOL}")
    if not max(ev_err) <= NONSYM_BATCH_EV_LIMIT:
        failures.append(f"eigenvalues {max(ev_err):.3e} > {NONSYM_BATCH_EV_LIMIT}")
    if not max(res) <= 2 * NONSYM_BATCH_TOL:
        failures.append(f"f64 residual {max(res):.3e} > 2 x {NONSYM_BATCH_TOL}")
    if failures:
        raise AssertionError("solve_nonsym_batched: " + "; ".join(failures))
    return rec


def shifted_matvec(x, op):
    import torch

    return torch.matmul(x, op[0].T) + op[1] * x


def solve_nonsym_shifted(shifted, b, device, dtype=None) -> dict:
    """make_batched_nonsym_lineq_solve with operand_axes=(None, 0): the
    systems (A + 3 I + sigma I) x = b for NONSYM_SHIFTS and the first two
    right-hand sides, one operator on the card; each converged and within
    NONSYM_SHIFT_ERR_LIMIT of np.linalg.solve."""
    import torch

    from iterative_solver_torch import make_batched_nonsym_lineq_solve

    dtype = dtype or torch.float32
    f = dict(dtype=dtype, device=device)
    nrhs, nb, n = 2, len(NONSYM_SHIFTS), shifted.shape[0]
    rhs = b[:nrhs]
    sig = np.asarray(NONSYM_SHIFTS)
    d = np.diag(shifted)
    diag_b = np.stack([d + s for s in sig])
    b_b = np.broadcast_to(rhs, (nb, nrhs, n))
    b_norm = np.broadcast_to(np.linalg.norm(rhs, axis=1), (nb, nrhs))
    x0 = np.stack([rhs / (d[None, :] + s) for s in sig])
    op = (torch.as_tensor(shifted, **f), torch.as_tensor(sig, **f))
    args = [torch.as_tensor(np.ascontiguousarray(a), **f) for a in (x0, diag_b, b_b, b_norm)]
    binit, bsolve = make_batched_nonsym_lineq_solve(shifted_matvec, nrhs, 12,
                                                    operand_axes=(None, 0))

    def run():
        return bsolve(*binit(args[0], op, args[2]), op, args[1], args[2], args[3],
                      NONSYM_SHIFT_TOL, 200)

    out, wall, steady, _ = timed_solves(run, device)
    errs = []
    for k, s in enumerate(sig):
        ref = np.linalg.solve(shifted + s * np.eye(n), rhs.T).T
        errs.append(relative_error(out[3][k].cpu().numpy(), ref))
    rec = {"phase": "solve_nonsym_shifted", "shifts": list(NONSYM_SHIFTS), "n": n,
           "nrhs": nrhs, "m_max": 12, "tol": NONSYM_SHIFT_TOL,
           "iterations": out[5].tolist(), "max_error": float(out[4].max()),
           "f64_solution_errors": errs, "solution_error_limit": NONSYM_SHIFT_ERR_LIMIT,
           "seconds": wall, "steady_seconds": steady,
           "steady_seconds_per_iteration": steady / max(int(out[5].max()), 1)}
    emit(rec)
    if not (rec["max_error"] <= NONSYM_SHIFT_TOL and max(errs) <= NONSYM_SHIFT_ERR_LIMIT):
        raise AssertionError(f"solve_nonsym_shifted: errors {rec['max_error']:.3e} "
                             f"(tol {NONSYM_SHIFT_TOL}), solution errors {errs}")
    return rec


def solve_nonsym_checkpointed(matrix, device, dtype=None) -> dict:
    """Phase a's solve in chunks of NONSYM_CHUNK iteration(s), uninterrupted;
    the same stopped after NONSYM_STOP iterations with a checkpoint in a
    temporary directory and resumed on a fresh solver: the same iteration
    count, Ritz values within 1e-6. A solver with other m_max refuses the
    file."""
    import tempfile

    tol = NONSYM_TIERS["precise"][0]
    v0 = guess(np.diag(matrix), NONSYM_ROOTS)
    kw = dict(chunk_iters=NONSYM_CHUNK)
    ev0, _, _, it0 = nonsym_solver(matrix, "precise", "device", tol, device, dtype,
                                   **kw).solve(v0)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/nonsym.npz"
        _, _, err1, it1 = nonsym_solver(matrix, "precise", "device", tol, device, dtype,
                                        max_iter=NONSYM_STOP, **kw).solve(
                                            v0, checkpoint_path=path)
        t0 = time.perf_counter()
        ev2, _, err2, it2 = nonsym_solver(matrix, "precise", "device", tol, device, dtype,
                                          **kw).resume(path, keep_checkpointing=False)
        resume_s = time.perf_counter() - t0
        try:
            nonsym_solver(matrix, "precise", "device", tol, device, dtype,
                          m_max=NONSYM_M_MAX - 2, **kw).resume(path)
            refused = False
        except ValueError:
            refused = True
    diff = eigenvalue_error(ev2, ev0)
    rec = {"phase": "solve_nonsym_checkpoint", "chunk_iters": NONSYM_CHUNK,
           "stopped_at": it1, "stopped_max_error": float(np.max(err1)),
           "uninterrupted_iterations": it0, "resumed_iterations": it2,
           "resumed_max_error": float(np.max(err2)), "ritz_max_abs_diff": diff,
           "resume_seconds": resume_s, "other_m_max_refused": refused}
    emit(rec)
    if not (it1 == NONSYM_STOP and np.max(err1) > tol and it2 == it0 and diff <= 1e-6
            and np.max(err2) <= tol and refused):
        raise AssertionError(f"solve_nonsym_checkpoint: {rec}")
    return rec


def dense_int8_actions(matrix, device) -> list:
    """The dense int8 tiers' action at 16 x 8192 (16 rows padded to 32 for
    ``torch._int_mm``): one and two planes, in CUDA-event ms and profiler
    device ms (the whole action, and its int8 products alone), against the
    plain f64 product and the byte bound of the planes."""
    import torch

    from iterative_solver_torch.ops.kernels import dense_int8

    x = torch.as_tensor(np.random.default_rng(1).standard_normal((NONSYM_ROOTS, N)),
                        dtype=torch.float32, device=device)
    a64 = torch.as_tensor(matrix, dtype=torch.float64, device=device)
    ref = (x.double() @ a64.T)
    del a64
    out = []
    for name, cls, fn, planes in (
            ("dense_int8", dense_int8.DenseInt8, dense_int8.dense_int8_matvec, 1),
            ("dense_int8_split", dense_int8.DenseInt8Split,
             dense_int8.dense_int8_matvec_split, 2)):
        tree = cls.from_dense(matrix, device=device).tree()
        y = fn(x, tree)
        qx = dense_int8.quantize_rows(x * tree[-2][None, :])[0]   # tree[-2]: gc
        products = [(qx, p) for p in tree[:planes]] + ([(qx, tree[0])] if planes == 2 else [])
        prod = lambda: [dense_int8._int8_dot(a, q) for a, q in products]  # noqa: E731
        # the planes, x read and y written, gr, gc and d
        nbytes = planes * matrix.size + 4 * 2 * NONSYM_ROOTS * N + 4 * 3 * N
        flops = 2.0 * len(products) * NONSYM_ROOTS * matrix.size
        bound_ms, bound_by = bound(nbytes, flops, "int8")
        out.append({"name": name, "route": "torch._int_mm (library)",
                    "replaces": "iterative_solver_tpu/ops/kernels/dense_int8.py:167",
                    "rel_err_vs_f64": rel_err(y, ref)[1], "ms": time_ms(lambda: fn(x, tree), device),
                    "call_device_ms": device_ms(lambda: fn(x, tree), device, "", None)[1],
                    "int_mm_ms": time_ms(prod, device),
                    "int_mm_device_ms": device_ms(prod, device, "", None)[1],
                    "int_mm_calls": len(products), "rows_padded_to": dense_int8.INT_MM_ROWS,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes})
        del tree, y
    emit({"phase": "dense_int8_actions", "actions": out})
    return out


def solve_nonsym_family(device) -> dict:
    """The non-hermitian slice: phases a-h (chip_smoke's head note)."""
    import torch

    t0 = time.perf_counter()
    matrix = nonsym_matrix()
    a64 = torch.as_tensor(matrix, dtype=torch.float64, device=device)
    emit({"phase": "nonsym_operator", "n": NONSYM_N, "seconds": time.perf_counter() - t0})
    recs = {}
    # a, b: precise with device and host RR; c: the other tiers
    for tier, rr in (("precise", "device"), ("precise", "host"), ("int8_precise", "device"),
                     ("fast", "device"), ("int8", "device")):
        recs[f"{tier}_{rr}"] = solve_nonsym(matrix, a64, device, tier, rr)
    dense_int8_actions(matrix, device)
    solve_nonsym_checkpointed(matrix, device)          # g
    # h: a profile of one more phase-a solve on a warm solver
    headline = nonsym_solver(matrix, "precise", "device", NONSYM_TIERS["precise"][0], device)
    v0 = guess(np.diag(matrix), NONSYM_ROOTS)
    headline.solve(v0)
    emit(profile_solve(headline, v0, device, "profile_nonsym",
                       run=lambda: headline.solve(v0)[3]))
    del headline
    # e: the linear twin on the same operator + 3 I
    shifted = matrix + LINEAR_SHIFT * np.eye(NONSYM_N)
    del matrix
    a64 += LINEAR_SHIFT * torch.eye(NONSYM_N, dtype=torch.float64, device=device)
    b = linear_rhs(NONSYM_N)
    t0 = time.perf_counter()
    x_ref = np.linalg.solve(shifted, b.T).T
    emit({"phase": "nonsym_linear_reference", "seconds": time.perf_counter() - t0})
    for tier in NONSYM_LINEAR_TIERS:
        for rr in ("device", "host"):
            recs[f"linear_{tier}_{rr}"] = solve_nonsym_linear(shifted, a64, b, x_ref, device,
                                                              tier, rr)
    del a64, x_ref
    torch.cuda.empty_cache()
    recs["shifted"] = solve_nonsym_shifted(shifted, b, device)      # f
    del shifted
    recs["batched"] = solve_nonsym_batched(device)                  # f
    recs["pairs"] = solve_nonsym_pairs(device)                      # d
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# The spill and many-root slice: the offload stores, BandedEigensolver and
# the Chebyshev-filtered Davidson. Limits and iteration counts from
# calibrate_spill_cpu.py (the port's plain path on the CPU in float32, as
# the card runs it; PERF.md gives the margins).

# offload_stream: benchmarks/offload_benchmark.py's measurement at the
# port's largest operator (n = 2^20): 256 rows of history (2.15 GB of f64 in
# the store's file, 1.07 GB streamed in f32), blocks of 64 rows, 16 rows of x
OFFLOAD_N = 1 << 20
OFFLOAD_ROWS = 256
OFFLOAD_ROWS_SHORT = 128   # where the store's directory cannot hold 256 rows
OFFLOAD_BLOCK_ROWS = 64
OFFLOAD_M = 16
OFFLOAD_TURNS = 3          # pipelined and serial calls, interleaved
OFFLOAD_SEED = 5
# max |g - g64| / max |g64| against the host f64 store, and the same for the
# combination against float64 on the card (the CPU's float32: 5.5e-7 and
# 2.5e-7)
OFFLOAD_GRAM_LIMIT = 1e-5
OFFLOAD_COMBINE_LIMIT = 1e-5
# the parity Davidson of solve_parity through each store (create_linear_
# eigensystem on the bench BSR operator, float32): the CPU run's iterations
# (and the same stats in all three)
OFFLOAD_PARITY_ITERATIONS = {"default": 4, "host": 4, "streamed": 4}
# the many-root solves on the bench matrix through the "exact" tier (K1-f32,
# b = 512): 32 roots in bands of 16 (device deflation) or 8 (streamed, the
# store's blocks of 8 rows); the 32 lowest eigenvalues by eigvalsh in f64
SPILL_B = 512
BANDED_ROOTS = 32
# (deflate, band, m_max, tol) of each case. In float32 a band solve that
# restarts and iterates on at its floor breaks down where the small eigh is
# promoted to float64, as the port's is (ROADMAP Queue 3; the TPU's float32
# eigh stalls instead), so the held device case's m_max holds a band's
# solve without a restart (bands of 16 took 3 and 4 iterations), at 5e-5,
# above the deflated band's float32 floor (1.01e-5); the streamed mode
# locks at 10 tol on the f64 residual of rows purged in float32
# (calibrate_spill_cpu.py). "device_m64" is the device mode at m_max 64
# and 1e-5, where band 2 restarts at its floor: it runs, and its quality
# is reported and not held, until the eigh is fixed (its launches are held)
BANDED_MODES = {"device": ("device", 16, 96, 5e-5), "streamed": ("streamed", 8, 64, 1e-4),
                "device_m64": ("device", 16, 64, 1e-5)}
BANDED_HELD = ("device", "streamed")
BANDED_STORE_BLOCK_ROWS = 8
BANDED_MAX_ITER = 200
# np.linalg.eigvalsh of the bench matrix in f64 (calibrate_spill_cpu.py banded)
BANDED_REFERENCE_EIGENVALUES = [
    -2.0000867851589925, -1.8397575604176897, -1.6784299270313447,
    -1.5176359291753259, -1.354380384384803, -1.1916396668237093,
    -1.030912881378253, -0.8718567686726696, -0.7098094415476004,
    -0.5487012619414396, -0.3875584757858333, -0.22497437244668156,
    -0.06426207936110097, 0.09760508861511995, 0.259397351803119,
    0.41979515725184685, 0.5809417619781632, 0.7411574749123583,
    0.9043552152624925, 1.0643107389233986, 1.2248567850699026,
    1.386760571569295, 1.5482167938051958, 1.7115320354762371,
    1.8699015925756228, 2.0323488372238816, 2.1928801725929556,
    2.3542985980212885, 2.5143718982842898, 2.6778208524884777,
    2.838336774382932, 2.9989600873342024,
]
# (f64 residual, f64 Rayleigh quotients against the reference) limits
# (the CPU's float32: 1.84e-5 and 3.4e-11 with device deflation; 9.76e-4,
# the lock bar's 1e-3 holding it, and 5.3e-8 streamed)
BANDED_LIMITS = {"device": (1e-4, 1e-8), "streamed": (2e-3, 1e-6)}
# the streamed mode's sweeps: 7 for the bands' first passes, then the last
# row's tail, whose purged residual falls by 0.90-0.93 a 2-iteration sweep
# to the 1e-3 bar (the CPU's float32 enters the tail at 1.6e-3: 8 sweeps;
# the card's at 3.0e-3: 21; calibrate_spill_cpu.py sweeps, PERF.md §6). One
# sweep a root holds a tail entered at up to 1e-2 (29 sweeps)
BANDED_MAX_SWEEPS = 32
BANDED_ORTHO_LIMIT = 1e-4
# the Chebyshev-filtered Davidson (degree 4, rr "full") on the bench matrix,
# and beside the Jacobi FusedDavidson on a flat-diagonal operator
# A = Q diag(w) Q^T (Q from the QR of a seeded Gaussian, on the card)
CHEB_ROOTS = 16
CHEB_DEGREE = 4
CHEB_M_MAX = 64
# the filtered Ritz block's float32 floor on the bench matrix is 2e-4 to
# 7e-4, and iterating on at the floor breaks down (iteration 30 on the
# CPU): 1e-3, met at iteration 9 before the third restart
CHEB_TOL = 1e-3
CHEB_MAX_ITER = 200
FLAT_SEED = 9
FLAT_ROOTS = 8
FLAT_TOL = 1e-4
FLAT_MAX_ITER = 400
# the port's CPU float32 iterations of the bench and flat solves, and the
# (f64 residual, f64 Rayleigh quotient) limits of each operator
CHEB_ITERATIONS = {"bench": 9, "flat_chebyshev": 25, "flat_jacobi": 82}
# (the CPU's float32: bench 6.8e-4 and 2.4e-7 at tol 1e-3; flat 9.9e-5 and
# 1.8e-9 at tol 1e-4)
CHEB_LIMITS = {"bench": (2e-3, 1e-5), "flat": (2e-4, 1e-7)}
LANCZOS_ITERS = 12   # estimate_spectral_bounds' default


def flat_spectrum(n: int) -> np.ndarray:
    """The flat operator's eigenvalues, ascending: FLAT_ROOTS of them in
    [1, 2], a gap, then the rest in [3, 50]."""
    return np.concatenate([np.linspace(1.0, 2.0, FLAT_ROOTS),
                           np.linspace(3.0, 50.0, n - FLAT_ROOTS)])


def spill_action(matrix, device, dtype=None):
    """(matvec, sym) of the "exact" tier's packed action (K1-f32 on the
    card) at b = SPILL_B."""
    from iterative_solver_torch.ops.kernels import symm

    sym = symm.SymmetricBlocked.from_dense(matrix, b=SPILL_B, dtype=dtype, device=device)
    return symm.symm_matmat_kernel, sym


def k1_launches_of_solve(runs, m_max: int, probe: bool, per_iteration: int = 1) -> int:
    """K1 launches of fused solves given as (rows, iterations) pairs: the
    init's action, the symmetry probe's two, ``per_iteration`` actions per
    step (the appended block's, and a Chebyshev filter's degree), and one
    per restart."""
    return sum(1 + (2 if probe else 0) + per_iteration * it + expected_restarts(it, rows, m_max)
               for rows, it in runs)


def offload_fill(store, rows: int, device) -> list:
    """``rows`` unit rows of N(0, 1) entries, made on the card in float64
    from a seeded generator, appended to ``store``; their slots."""
    import torch

    gen = torch.Generator(device=device).manual_seed(OFFLOAD_SEED)
    slots = []
    for start in range(0, rows, 32):
        blk = torch.randn((min(32, rows - start), store.n), generator=gen, dtype=torch.float64,
                          device=device)
        blk /= torch.linalg.vector_norm(blk, dim=1, keepdim=True)
        slots += [store.append(r) for r in blk.cpu().numpy()]
    return slots


def offload_inputs(store, device, dtype=None):
    """x (OFFLOAD_M, N) on ``device`` and the (OFFLOAD_M, rows) coefficients,
    from default_rng(OFFLOAD_SEED)."""
    import torch

    rng = np.random.default_rng(OFFLOAD_SEED)
    x = torch.as_tensor(rng.standard_normal((OFFLOAD_M, store.n)), dtype=dtype or torch.float32,
                        device=device)
    coeff = rng.standard_normal((OFFLOAD_M, store.capacity))
    return x, coeff


def offload_references(store, slots, x, coeff, device):
    """The host-f64 store's gram (OffloadBasisStore.gram on the same file)
    with its seconds, and the combination in float64 on the card against
    the rows read back from the store."""
    import torch

    from iterative_solver_torch.array.offload_store import OffloadBasisStore

    t0 = time.perf_counter()
    g64 = OffloadBasisStore.gram(store, x, slots)
    host_gram_s = time.perf_counter() - t0
    r64 = torch.empty((len(slots), store.n), dtype=torch.float64, device=device)
    for i, s in enumerate(slots):
        r64[i] = torch.as_tensor(store._store.get(s), device=device)
    c64 = torch.as_tensor(coeff[:, :len(slots)], device=device) @ r64
    return g64, host_gram_s, r64, c64.cpu().numpy()


def offload_stream(device) -> dict:
    """The streamed offload store at n = 2^20 (the smoke's head note):
    pipelined and serial gram and combine in turns, each stage alone, the
    host f64 gram, errors and bits."""
    import shutil
    import tempfile

    import torch

    from iterative_solver_torch.array.offload_store import StreamedOffloadStore

    n, br = OFFLOAD_N, OFFLOAD_BLOCK_ROWS
    store_dir = tempfile.gettempdir()   # where the store's file lives (TMPDIR)
    free = shutil.disk_usage(store_dir).free
    rows = OFFLOAD_ROWS if free >= 1.5 * OFFLOAD_ROWS * n * 8 else OFFLOAD_ROWS_SHORT
    print(f"offload_stream: {rows} rows of history in {store_dir} "
          f"({free / 1e9:.1f} GB free)", flush=True)
    store = StreamedOffloadStore(rows, n, dtype=torch.float32, block_rows=br, device=device)
    t0 = time.perf_counter()
    slots = offload_fill(store, rows, device)
    fill_s = time.perf_counter() - t0
    x, coeff = offload_inputs(store, device)
    g64, host_gram_s, r64, c64 = offload_references(store, slots, x, coeff, device)

    # each stage alone: the products on device-resident blocks, the reads
    # into a pinned buffer, the pinned H2D copies (float64 as the store
    # stages; float32 and the host cast it would need, the design measured
    # and rejected: PERF.md)
    r32 = r64.float()
    del r64
    blocks = [r32[k:k + br] for k in range(0, rows, br)]
    cdev = torch.as_tensor(coeff, dtype=torch.float32, device=device)
    gram_prod_ms = time_ms(lambda: [x @ b.T for b in blocks], device, reps=5)
    comb_prod_ms = time_ms(lambda: sum(cdev[:, k * br:(k + 1) * br] @ b
                                       for k, b in enumerate(blocks)), device, reps=5)
    del blocks, r32
    pinned = {dt: torch.empty((br, n), dtype=dt, pin_memory=True)
              for dt in (torch.float64, torch.float32)}
    view64, view32 = pinned[torch.float64].numpy(), pinned[torch.float32].numpy()
    t0 = time.perf_counter()
    for i, s in enumerate(slots):
        store._store.get_into(s, view64[i % br])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(rows // br):
        view32[...] = view64
    cast_s = time.perf_counter() - t0
    h2d = {}
    for dt, buf in pinned.items():
        dev = torch.empty((br, n), dtype=dt, device=device)
        ms = time_ms(lambda: dev.copy_(buf, non_blocking=True), device, reps=5)
        h2d[str(dt)] = {"ms_per_block": ms, "GB_per_s": buf.numel() * buf.element_size() / ms / 1e6}
        del dev
    del pinned, view64, view32

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, time.perf_counter() - t0

    # the first call pins the two staging buffers (2 x 512 MB): timed alone
    _, first_call_s = timed(lambda: store.gram(x, slots))
    turns, first = [], None
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    for turn in range(OFFLOAD_TURNS):
        rec = {}
        for prefetch in (True, False):
            key = "pipelined" if prefetch else "serial"
            g, rec[f"gram_{key}_s"] = timed(lambda: store.gram(x, slots, prefetch=prefetch))
            c, rec[f"combine_{key}_s"] = timed(
                lambda: store.combine(coeff, slots, prefetch=prefetch))
            if first is None:
                first = (g, c)
                peak_mb = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20
            rec[f"same_bits_{key}"] = bool(np.array_equal(g, first[0])
                                           and torch.equal(c, first[1]))
        turns.append(rec)
    pinned_ok = all(b.is_pinned() for b in store._stage()[0])

    def factors(kind):
        f = sorted(t[f"{kind}_serial_s"] / t[f"{kind}_pipelined_s"] for t in turns)
        return {"min": f[0], "median": f[len(f) // 2], "max": f[-1]}

    gram_err = rel_err(torch.as_tensor(first[0]), torch.as_tensor(g64))[1]
    comb_err = rel_err(first[1].cpu(), torch.as_tensor(c64))[1]
    history_gb = rows * n * 8 / 1e9
    rec = {
        "phase": "offload_stream", "n": n, "rows": rows, "rows_cut": rows != OFFLOAD_ROWS,
        "block_rows": br, "m": OFFLOAD_M,
        "store_dir": store_dir, "store_dir_free_GB": free / 1e9, "history_f64_GB": history_gb,
        "streamed_f32_GB": history_gb / 2, "fill_seconds": fill_s,
        "turns": turns, "overlap_gram": factors("gram"), "overlap_combine": factors("combine"),
        "first_call_s": first_call_s,
        "host_f64_gram_s": host_gram_s,
        "stage_read_s": read_s, "stage_read_GB_per_s": history_gb / read_s,
        "stage_host_cast_s": cast_s, "stage_h2d": h2d,
        "stage_gram_products_ms": gram_prod_ms, "stage_combine_products_ms": comb_prod_ms,
        "device_peak_MB_while_streaming": peak_mb, "history_MB": history_gb * 1e3 / 1.048576,
        "gram_rel_err_vs_host_f64": gram_err, "gram_limit": OFFLOAD_GRAM_LIMIT,
        "combine_rel_err_vs_f64": comb_err, "combine_limit": OFFLOAD_COMBINE_LIMIT,
        "pinned": pinned_ok,
    }
    emit(rec)
    store.close()
    failures = []
    if not all(t["same_bits_pipelined"] and t["same_bits_serial"] for t in turns):
        failures.append("the pipelined and serial results differ in bits")
    if not gram_err <= OFFLOAD_GRAM_LIMIT:
        failures.append(f"gram off the host f64 gram by {gram_err:.3e} > {OFFLOAD_GRAM_LIMIT}")
    if not comb_err <= OFFLOAD_COMBINE_LIMIT:
        failures.append(f"combine off by {comb_err:.3e} > {OFFLOAD_COMBINE_LIMIT}")
    if not pinned_ok:
        failures.append("the staging buffers are not pinned")
    if failures:
        raise AssertionError("offload_stream: " + "; ".join(failures))
    return rec


OFFLOAD_FORMS = {"default": False, "host": True, "streamed": "streamed"}


def solve_offload_parity(bsr, dense, device) -> dict:
    """solve_parity through the three store forms: the default device
    stores, offload=True (host f64) and offload="streamed"; each with the
    CPU's iteration count and the same eigenvalues."""
    recs = {form: solve_parity(bsr, dense, device, offload=offload,
                               phase="solve_offload_parity")
            for form, offload in OFFLOAD_FORMS.items()}
    failures = [f"{form}: {r['iterations']} iterations, the CPU's float32 run took "
                f"{OFFLOAD_PARITY_ITERATIONS[form]}" for form, r in recs.items()
                if abs(r["iterations"] - OFFLOAD_PARITY_ITERATIONS[form]) > 2]
    evals = np.array([r["eigenvalues"] for r in recs.values()])
    if not np.abs(evals - evals[0]).max() <= 1e-5:
        failures.append(f"the stores' eigenvalues differ: {evals}")
    if failures:
        raise AssertionError("solve_offload_parity: " + "; ".join(failures))
    return recs


def banded_solver(matrix, device, case: str, dtype=None, op=None, store=None):
    """BandedEigensolver on the bench matrix's "exact" action (K1-f32) with
    the case's BANDED_MODES settings (streamed: the store's blocks of
    BANDED_STORE_BLOCK_ROWS rows)."""
    from iterative_solver_torch.solvers import BandedEigensolver

    matvec, sym = op or spill_action(matrix, device, dtype)
    deflate, band, m_max, tol = BANDED_MODES[case]
    return BandedEigensolver(matvec, np.diagonal(matrix), matrix.shape[0], band=band,
                             m_max=m_max, dtype=dtype, convergence_threshold=tol,
                             max_iter=BANDED_MAX_ITER, operand=sym, deflate=deflate,
                             store=store, store_block_rows=BANDED_STORE_BLOCK_ROWS,
                             device=device)


def many_root_quality(vals, vecs, matrix, ref) -> dict:
    """The f64 residual of each normalised row against the dense f64
    matrix, max|X X^T - I|, the rows' sorted f64 Rayleigh quotients
    against ``ref``, and the solver's own eigenvalues against ``ref``."""
    xs = vecs[:, : matrix.shape[0]]
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ax = xs @ matrix
    rq = np.sum(xs * ax, axis=1)
    ref = np.asarray(ref)
    return {"f64_max_residual": float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1))),
            "ortho_max": float(np.abs(vecs @ vecs.T - np.eye(len(vecs))).max()),
            "rq_max_abs_err": float(np.abs(np.sort(rq) - ref).max()),
            "eigenvalue_max_abs_err": float(np.abs(np.sort(vals) - ref).max())}


def solve_banded(matrix, device, op) -> dict:
    """32 roots of the bench matrix with BandedEigensolver in both modes."""
    import torch

    recs = {}
    for case, (deflate, *_) in BANDED_MODES.items():
        solver = banded_solver(matrix, device, case, op=op)
        per_sweep = []
        if deflate == "streamed":
            # the f64 residuals of the purged rows at each sweep, against the bar
            check = solver._f64_check

            def logged(x, check=check):
                rq, res = check(x)
                per_sweep.append(sorted(float(r) for r in res))
                return rq, res

            solver._f64_check = logged
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        sync(device)
        t0 = time.perf_counter()
        vals, vecs, errs = solver.solve(BANDED_ROOTS)
        sync(device)
        wall = time.perf_counter() - t0
        launches = solve_launches("symm_f32")
        streamed = deflate == "streamed"
        expected = {"action": k1_launches_of_solve(solver.runs, solver.m_max, probe=False)
                    + (len(solver.runs) if streamed else 0),   # one f64 check per sweep
                    "chain": sum(it for _, it in solver.runs), "gram": 0}
        q = many_root_quality(vals, vecs, matrix, BANDED_REFERENCE_EIGENVALUES)
        history_mb = BANDED_ROOTS * matrix.shape[0] * 8 / 2 ** 20
        held = case in BANDED_HELD
        rec = {"phase": "solve_banded", "case": case, "deflate": deflate, "band": solver.band,
               "held": held, "limits": BANDED_LIMITS.get(case),
               "m_max": solver.m_max, "tol": solver.tol, "runs": solver.runs,
               "iterations": sum(it for _, it in solver.runs), "n_locked": solver.n_locked,
               "seconds": wall, "max_error": float(np.max(errs)), **q,
               "device_peak_MB": (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20,
               "locked_history_f64_MB": history_mb, "launches": launches,
               "expected_launches": expected}
        if streamed:
            rec.update(sweeps=len(solver.runs), max_sweeps=BANDED_MAX_SWEEPS,
                       bar=10 * solver.tol, residuals_per_sweep=per_sweep)
        emit(rec)
        failures = []
        if held:
            res_limit, rq_limit = BANDED_LIMITS[case]
            if not q["f64_max_residual"] <= res_limit:
                failures.append(f"f64 residual {q['f64_max_residual']:.3e} > {res_limit}")
            if not q["rq_max_abs_err"] <= rq_limit:
                failures.append(f"Rayleigh quotients off by {q['rq_max_abs_err']:.3e} > "
                                f"{rq_limit}")
            if not q["ortho_max"] <= BANDED_ORTHO_LIMIT:
                failures.append(f"max|X X^T - I| = {q['ortho_max']:.3e}")
            if solver.n_locked != BANDED_ROOTS:
                failures.append(f"{solver.n_locked} rows locked, not {BANDED_ROOTS}")
        if streamed and not len(solver.runs) <= BANDED_MAX_SWEEPS:
            failures.append(f"{len(solver.runs)} sweeps > {BANDED_MAX_SWEEPS}")
        if launches != expected or min(launches["action"], launches["chain"]) == 0:
            failures.append(f"launches {launches} != expected {expected}")
        if failures:
            raise AssertionError(f"solve_banded[{case}]: " + "; ".join(failures))
        recs[case] = rec
        if solver.store is not None:
            solver.store.close()
    return recs


def flat_operator(n: int, device, dtype=None):
    """A = Q diag(w) Q^T on ``device`` in float64, Q from the QR of a
    default_rng(FLAT_SEED) Gaussian, w = flat_spectrum(n): a dense
    eigenbasis, so the diagonal carries almost no information. Returns (A
    as float64 on the device, its packed "exact" action, w)."""
    import torch

    from iterative_solver_torch.ops.kernels import symm

    g = np.random.default_rng(FLAT_SEED).standard_normal((n, n))
    q, _ = torch.linalg.qr(torch.as_tensor(g, device=device))
    del g
    w = flat_spectrum(n)
    a64 = (q * torch.as_tensor(w, device=device)) @ q.T
    del q
    a64 = 0.5 * (a64 + a64.T)
    sym = symm.SymmetricBlocked.from_dense(a64.cpu().numpy(), b=SPILL_B, dtype=dtype,
                                           device=device)
    return a64, (symm.symm_matmat_kernel, sym), w


def chebyshev_solver(matvec, sym, diag, nroots: int, device, dtype=None, tol=None,
                     max_iter=CHEB_MAX_ITER):
    from iterative_solver_torch.solvers import make_chebyshev_davidson

    return make_chebyshev_davidson(matvec, diag, sym.shape[0], nroots=nroots,
                                   degree=CHEB_DEGREE, m_max=CHEB_M_MAX, rr="full",
                                   operand=sym, convergence_threshold=tol, max_iter=max_iter,
                                   dtype=dtype, device=device)


def jacobi_solver(matvec, sym, diag, nroots: int, device, dtype=None, tol=None,
                  max_iter=FLAT_MAX_ITER):
    from iterative_solver_torch import FusedDavidson

    return FusedDavidson(matvec, diag, sym.shape[0], nroots, m_max=CHEB_M_MAX, rr="full",
                         operand=sym, convergence_threshold=tol, max_iter=max_iter,
                         dtype=dtype, device=device)


def one_cheb_solve(phase, make, v0, nroots, quality, limits, device, degree) -> tuple:
    """A fused solve built by ``make()`` (its construction runs the Lanczos
    bounds where the solver is Chebyshev's): its record, with its launches
    and quality, and the list of its failed checks."""
    import torch

    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    solver = make()
    evals, x, errors, iters = solver.run_on_device(v0)
    sync(device)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_f32")
    matvecs = solver.matvecs
    # a second solve of the warm solver (no bounds, no symmetry probe)
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    _, _, _, steady_iters = solver.run_on_device(v0)
    sync(device)
    steady = time.perf_counter() - t0
    steady_launches = solve_launches("symm_f32")
    cheb = solver.expand is not None
    per_it = degree + 1 if cheb else 1
    expected = {"action": k1_launches_of_solve([(nroots, iters)], solver.m_max, probe=True,
                                               per_iteration=per_it)
                + (LANCZOS_ITERS if cheb else 0),
                "chain": iters, "gram": 0}
    steady_expected = {"action": k1_launches_of_solve([(nroots, steady_iters)], solver.m_max,
                                                      probe=False, per_iteration=per_it),
                       "chain": steady_iters, "gram": 0}
    xs = x.detach().to("cpu", torch.float64).numpy()
    rec = {"phase": phase, "filter": "chebyshev" if cheb else "jacobi", "limits": limits,
           "degree": degree if cheb else None, "nroots": nroots, "tol": solver.tol,
           "iterations": iters, "matvecs": matvecs,
           "matvecs_identity": nroots + iters * nroots * (degree if cheb else 1),
           "converged": bool(np.max(errors) <= solver.tol), "max_error": float(np.max(errors)),
           "seconds_to_solution": wall, "seconds_per_iteration": wall / max(iters, 1),
           "steady_seconds_to_solution": steady, "steady_iterations": steady_iters,
           **quality(evals, xs), "launches": launches, "expected_launches": expected,
           "steady_launches": steady_launches, "steady_expected_launches": steady_expected}
    emit(rec)
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: max error {rec['max_error']:.3e}")
    if rec["matvecs"] != rec["matvecs_identity"]:
        failures.append(f"matvecs {rec['matvecs']} != {rec['matvecs_identity']}")
    if launches != expected:
        failures.append(f"launches {launches} != expected {expected}")
    if steady_launches != steady_expected:
        failures.append(f"steady launches {steady_launches} != expected {steady_expected}")
    res_limit, rq_limit = limits
    if not rec["f64_max_residual"] <= res_limit:
        failures.append(f"f64 residual {rec['f64_max_residual']:.3e} > {res_limit}")
    if not rec["rq_max_abs_err"] <= rq_limit:
        failures.append(f"Rayleigh quotients off by {rec['rq_max_abs_err']:.3e} > {rq_limit}")
    return rec, failures


def solve_chebyshev(matrix, device, op) -> dict:
    """make_chebyshev_davidson on the bench matrix (16 roots); then on the
    flat-diagonal operator, Chebyshev beside the Jacobi FusedDavidson."""
    import torch

    recs, failures = {}, []
    matvec, sym = op
    diag = np.diagonal(matrix)

    def bench_quality(evals, xs):
        q = many_root_quality(evals, xs, matrix, BANDED_REFERENCE_EIGENVALUES[:CHEB_ROOTS])
        return {k: q[k] for k in ("f64_max_residual", "rq_max_abs_err",
                                  "eigenvalue_max_abs_err")}

    recs["bench"], f = one_cheb_solve(
        "solve_chebyshev", lambda: chebyshev_solver(matvec, sym, diag, CHEB_ROOTS, device,
                                                    tol=CHEB_TOL),
        guess(diag, CHEB_ROOTS), CHEB_ROOTS, bench_quality, CHEB_LIMITS["bench"], device,
        CHEB_DEGREE)
    failures += [f"bench: {m}" for m in f]
    if abs(recs["bench"]["iterations"] - CHEB_ITERATIONS["bench"]) > 2:
        failures.append(f"bench: {recs['bench']['iterations']} iterations, the CPU's "
                        f"{CHEB_ITERATIONS['bench']}")
    del sym

    t0 = time.perf_counter()
    a64, (fmatvec, fsym), w = flat_operator(N, device)
    emit({"phase": "flat_operator", "n": N, "seconds": time.perf_counter() - t0})
    fdiag = torch.diagonal(a64).cpu().numpy()
    v0 = guess(fdiag, FLAT_ROOTS)

    def flat_quality(evals, xs):
        xd = torch.as_tensor(xs[:, :N], device=device)
        xd = xd / torch.linalg.vector_norm(xd, dim=1, keepdim=True)
        ax = xd @ a64
        rq = torch.sum(xd * ax, dim=1)
        res = torch.linalg.vector_norm(ax - rq[:, None] * xd, dim=1)
        return {"f64_max_residual": float(res.max()),
                "rq_max_abs_err": float(np.abs(np.sort(rq.cpu().numpy())
                                               - w[:FLAT_ROOTS]).max()),
                "eigenvalue_max_abs_err": float(np.abs(np.sort(evals) - w[:FLAT_ROOTS]).max())}

    for name, make in (
            ("chebyshev", lambda: chebyshev_solver(fmatvec, fsym, fdiag, FLAT_ROOTS, device,
                                                   tol=FLAT_TOL, max_iter=FLAT_MAX_ITER)),
            ("jacobi", lambda: jacobi_solver(fmatvec, fsym, fdiag, FLAT_ROOTS, device,
                                             tol=FLAT_TOL))):
        recs[f"flat_{name}"], f = one_cheb_solve(f"solve_flat_{name}", make, v0, FLAT_ROOTS,
                                                 flat_quality, CHEB_LIMITS["flat"], device,
                                                 CHEB_DEGREE)
        failures += [f"flat {name}: {m}" for m in f]
        want = CHEB_ITERATIONS[f"flat_{name}"]
        if abs(recs[f"flat_{name}"]["iterations"] - want) > max(2, want // 10):
            failures.append(f"flat {name}: {recs[f'flat_{name}']['iterations']} iterations, "
                            f"the CPU's {want}")
    del a64, fsym
    torch.cuda.empty_cache()
    emit({"phase": "chebyshev_vs_jacobi",
          "wall_ratio": recs["flat_chebyshev"]["seconds_to_solution"]
          / recs["flat_jacobi"]["seconds_to_solution"],
          "steady_wall_ratio": recs["flat_chebyshev"]["steady_seconds_to_solution"]
          / recs["flat_jacobi"]["steady_seconds_to_solution"],
          "iteration_ratio": recs["flat_chebyshev"]["iterations"]
          / recs["flat_jacobi"]["iterations"],
          "matvec_ratio": recs["flat_chebyshev"]["matvecs"] / recs["flat_jacobi"]["matvecs"]})
    if failures:
        raise AssertionError("solve_chebyshev: " + "; ".join(failures))
    return recs


# ---------------------------------------------------------------------------
# The examples (examples_torch/): the twin of every examples/*.py script,
# each run through its main() on the card, in this process, at the sizes
# below; one of them again as a user runs it, in a process of its own; and
# the twin notebook's cells.

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch")
# (twin, its arguments on the card): the kernel-bearing twins at the main
# path's n = 8192 with its tiles (512 for K1-f32 and K3; the int8 twin keeps
# its example's 256), the batched scan at the batched phase's 8 x 1024
EXAMPLES = (
    ("packed_symmetric_davidson", ("--n", "8192", "--b", "512")),
    ("refine_to_1e8", ("--n", "8192", "--nroots", "8", "--action", "split")),
    ("quantized_screening", ("--n", "8192")),
    ("hybrid_precision", ()),
    ("ppcg_hard_spectrum", ()),
    ("batched_scan", ("--n", "1024", "--points", "8")),
    ("response_equations", ()),
    ("nonhermitian_eigen", ()),
    ("differentiable_eigenvalues", ()),
    ("eigenvector_adjoint", ()),
    ("checkpoint_resume", ()),
    ("distributed_eigensystem", ()),
    ("foreign_container", ()),
    ("linear_eigensystem_multiroot", ()),
    ("linear_eigensystem", ()),
    ("linear_equations", ()),
    ("nonlinear_equations", ()),
    ("optimize", ()),
)
# quantized_screening's tile and roots on the card: check_int8_kernels holds
# K4 and K5 to their plain versions at this shape too
EXAMPLE_INT8_TILE, EXAMPLE_INT8_ROWS = 256, 6
EXAMPLE_SUBPROCESS = "linear_eigensystem"
EXAMPLE_NOTEBOOK = "OptimizeExample.ipynb"
# the twins that solve in float32: their counts may differ from the CPU's by
# EXAMPLE_F32_SLACK; the float64 ones match the CPU's exactly, but for the
# Davidson stalls of ppcg_hard_spectrum (250-500 iterations, where rounding
# drifts the count by a few percent: tests/test_torch_examples_parity_ppcg.py)
EXAMPLE_F32 = {"packed_symmetric_davidson", "refine_to_1e8", "quantized_screening",
               "hybrid_precision"}
EXAMPLE_F32_SLACK = 2
EXAMPLE_DRIFT = 0.05
# every twin's counts (example_counts) on the CPU at the arguments above,
# from calibrate_examples_cpu.py
EXAMPLE_CPU_ITERATIONS = {
    "packed_symmetric_davidson": {"f32.iterations": 3, "split.iterations": 3},
    "refine_to_1e8": {"iterations": 5, "passes": 1},
    "quantized_screening": {"screen.iterations": 2, "polish.iterations": 100,
        "refine.passes": 2},
    "hybrid_precision": {"iterations": 3, "refine_iterations": 4},
    "ppcg_hard_spectrum": {"ppcg.iterations": 77, "davidson.window.iterations": 495,
        "davidson.window3.iterations": 387, "davidson.full.iterations": 248},
    "batched_scan": {"scan.0.iterations": 10, "scan.1.iterations": 15,
        "scan.2.iterations": 20, "scan.3.iterations": 20, "scan.4.iterations": 25,
        "scan.5.iterations": 25, "scan.6.iterations": 30, "scan.7.iterations": 35,
        "nonsym.0.iterations": 10, "nonsym.1.iterations": 15, "nonsym.2.iterations": 15,
        "nonsym.3.iterations": 20, "nonsym.4.iterations": 25, "nonsym.5.iterations": 25,
        "nonsym.6.iterations": 30, "nonsym.7.iterations": 35},
    "response_equations": {"cg_iterations": 9, "nonsym.0.iterations": 10,
        "nonsym.1.iterations": 10, "nonsym.2.iterations": 10, "nonsym.3.iterations": 10},
    "nonhermitian_eigen": {"host_rr.iterations": 9, "device_rr.iterations": 9,
        "complex_pair.iterations": 22, "linear.iterations": 8},
    "differentiable_eigenvalues": {"points.0.iterations": 23, "points.1.iterations": 18,
        "points.2.iterations": 16, "points.3.iterations": 18, "points.4.iterations": 24},
    "eigenvector_adjoint": {},
    "checkpoint_resume": {"iterations": 8, "nonsym.interrupted_at": 4,
        "nonsym.iterations": 10},
    "distributed_eigensystem": {"iterations": 68},
    "foreign_container": {"runs.0.iterations": 6, "runs.1.iterations": 6,
        "runs.2.iterations": 6, "runs.3.iterations": 5},
    "linear_eigensystem_multiroot": {"iterations": 5},
    "linear_eigensystem": {"iterations": 6},
    "linear_equations": {"iterations": 7},
    "nonlinear_equations": {"iterations": 8},
    "optimize": {"iterations": 7},
    "OptimizeExample": {"bfgs_iterations": 7, "fused_iterations": 34},
}
# the kernels the twins must launch (packed_symmetric_davidson,
# refine_to_1e8, quantized_screening, hybrid_precision)
EXAMPLE_KERNELS = ("K1-f32", "K3", "K2", "K4", "K5")
# the kernels line's names by the launch counters' keys
LAUNCH_NAMES = {"symm_bf16": "K1-bf16", "symm_f32": "K1-f32", "symm_split": "K3",
                "chain": "K2", "symm_int8": "K4", "symm_int8_split": "K5", "bsr": "K6",
                "gram": "K7", "rr3_dots": "K8", "rr3_update": "K8"}


def example_counts(out, prefix: str = "") -> dict:
    """The iteration counts in a twin's dict, by path ("f32.iterations",
    "scan.3.iterations"): each int under a key that ends in "iterations" or
    is "passes" or "interrupted_at"."""
    counts = {}
    for key, value in (out.items() if isinstance(out, dict) else enumerate(out)):
        path = f"{prefix}{key}"
        if isinstance(value, dict) or (isinstance(value, list) and value
                                       and isinstance(value[0], dict)):
            counts.update(example_counts(value, path + "."))
        elif (isinstance(value, int) and not isinstance(value, bool)
              and (str(key).endswith("iterations") or key in ("passes", "interrupted_at"))):
            counts[path] = value
    return counts


def example_count_failures(name: str, counts: dict) -> list:
    """Each count of a card run against the CPU run's (EXAMPLE_CPU_ITERATIONS)."""
    cpu = EXAMPLE_CPU_ITERATIONS[name]
    if sorted(counts) != sorted(cpu):
        return [f"{name}: counts {sorted(counts)}, the CPU run's {sorted(cpu)}"]
    failures = []
    for key, ref in cpu.items():
        slack = (EXAMPLE_F32_SLACK if name in EXAMPLE_F32
                 else int(np.ceil(EXAMPLE_DRIFT * ref)) if key.startswith("davidson.") else 0)
        if abs(counts[key] - ref) > slack:
            failures.append(f"{name}: {key} = {counts[key]}, the CPU run's {ref} (+-{slack})")
    return failures


def example_expected_launches(name: str, out: dict) -> dict:
    """The launches a twin makes on the card, by counter key: each fused
    Davidson solve its action's kernel for init + symmetry probe +
    iterations + restarts and K2 once per iteration; each refinement pass
    the CG init's action and one per CG iteration; nothing else (the other
    twins' actions are dense products), and never K7."""
    expected = {key: 0 for counters in launch_counters() for key in counters}

    def solve(key, iters, nroots, m_max):
        expected[key] += 1 + 2 + iters + expected_restarts(iters, nroots, m_max)
        expected["chain"] += iters

    if name == "packed_symmetric_davidson":
        solve("symm_f32", out["f32"]["iterations"], out["nroots"], out["m_max"])
        solve("symm_split", out["split"]["iterations"], out["nroots"], out["m_max"])
    elif name == "refine_to_1e8":
        solve("symm_split", out["iterations"], out["nroots"], out["m_max"])
        expected["symm_split"] += sum(1 + it for it in out["cg_iterations"])
    elif name == "quantized_screening":
        solve("symm_int8", out["screen"]["iterations"], out["nroots"], out["m_max"])
        solve("symm_int8_split", out["polish"]["iterations"], out["nroots"], out["m_max"])
        expected["symm_int8_split"] += sum(1 + it for it in out["refine"]["cg_iterations"])
    elif name == "hybrid_precision":
        # the host-driven run(): a dense split-K action, the chain each step
        expected["chain"] += out["iterations"]
    return expected


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def twin_main(name: str, argv) -> tuple:
    """(result, printed): the twin's ``main(argv)`` in this process, its
    output captured."""
    import contextlib
    import importlib
    import io

    twin = importlib.import_module(f"examples_torch.{name}")
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            out = twin.main(list(argv))
    except Exception as err:
        raise AssertionError(f"example {name} failed: {err!r}\n{printed.getvalue()[-3000:]}")
    return out, printed.getvalue()


def run_example(name: str, argv, device) -> dict:
    """One twin's main on the card: its own assertions, its counts against
    the CPU run's, its launches against example_expected_launches."""
    import torch

    reset_launches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out, printed = twin_main(name, ["--device", "cuda", *argv])
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {key: read_launches(key) for counters in launch_counters() for key in counters}
    expected = example_expected_launches(name, out)
    counts = example_counts(out)
    rec = {"phase": "example", "name": name, "argv": list(argv), "seconds": seconds,
           "iterations": counts, "cpu_iterations": EXAMPLE_CPU_ITERATIONS[name],
           "launches": launches, "expected_launches": expected, "result": out}
    emit(rec)
    failures = example_count_failures(name, counts)
    if _last_json(printed) != out or out["device"] != "cuda":
        failures.append(f"{name}: its last line is not its result on the card")
    if name == "quantized_screening" and (out["n"], out["b"], out["nroots"]) != (
            N, EXAMPLE_INT8_TILE, EXAMPLE_INT8_ROWS):
        failures.append(f"{name}: ran at n, b, nroots = {out['n']}, {out['b']}, "
                        f"{out['nroots']}, not the shape check_int8_kernels holds")
    if launches != expected:
        failures.append(f"{name}: launches {launches} != expected {expected}")
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


def run_example_subprocess(name: str) -> dict:
    """The twin as a user runs it: ``python3 examples_torch/<name>.py``, in
    a process of its own, on the card by default."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES_DIR, f"{name}.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(EXAMPLES_DIR))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python3 examples_torch/{name}.py exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    out = _last_json(proc.stdout)
    counts = example_counts(out)
    rec = {"phase": "example_subprocess", "name": name, "seconds": seconds,
           "iterations": counts, "result": out}
    emit(rec)
    failures = example_count_failures(name, counts)
    if out["device"] != "cuda":
        failures.append(f"{name}: ran on {out['device']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return rec


def run_example_notebook(device) -> dict:
    """The twin notebook on the card: its counts against the CPU run's, no
    kernel launched."""
    import torch

    from examples_torch import _cli

    os.environ.pop("EXAMPLES_DEVICE", None)
    reset_launches()
    t0 = time.perf_counter()
    out = _cli.run_notebook(os.path.join(EXAMPLES_DIR, EXAMPLE_NOTEBOOK))
    torch.cuda.synchronize(device)
    counts = example_counts(out)
    launches = {key: read_launches(key) for counters in launch_counters() for key in counters}
    rec = {"phase": "example_notebook", "name": EXAMPLE_NOTEBOOK,
           "seconds": time.perf_counter() - t0, "iterations": counts, "launches": launches,
           "result": out}
    emit(rec)
    failures = example_count_failures("OptimizeExample", counts)
    if out["device"] != "cuda" or any(launches.values()):
        failures.append(f"ran on {out['device']}, launches {launches}")
    if failures:
        raise AssertionError(f"{EXAMPLE_NOTEBOOK}: " + "; ".join(failures))
    return rec


def run_examples(device) -> dict:
    """The examples phase; returns each kernel's launches over its twins."""
    t0 = time.perf_counter()
    totals = {}
    for name, argv in EXAMPLES:
        rec = run_example(name, argv, device)
        for key, count in rec["launches"].items():
            totals[LAUNCH_NAMES[key]] = totals.get(LAUNCH_NAMES[key], 0) + count
    run_example_subprocess(EXAMPLE_SUBPROCESS)
    run_example_notebook(device)
    emit({"phase": "examples", "twins": len(EXAMPLES) + 1, "seconds": time.perf_counter() - t0,
          "launches": totals})
    missing = [k for k in EXAMPLE_KERNELS if not totals.get(k)]
    if missing or totals.get("K7"):
        raise AssertionError(f"examples: {missing} not launched, or K7 launched: {totals}")
    return totals


# ---------------------------------------------------------------------------
# The distribution layer (ROADMAP.md Queue 1 item 6b). SHARD_WORLD ranks run
# as processes of this script (``--shard-worker``) on the one card, joined by
# gloo: NCCL refuses two ranks on one card, so every collective is staged
# through pinned host memory (parallel/collectives.py), and these times
# measure gloo over the host, not NVLink. NCCL runs once, at world size 1, in
# this process (``nccl_world1``).

SHARD_WORLD = 4
SHARD_TIMEOUT_S = 600
SHARD_ITER_SLACK = 2      # iterations a sharded solve may differ from the unsharded run
SHARD_ORTHO_LIMIT = 1e-4  # max|X X^T - I| of a sharded solve's Ritz rows
SHARD_TIME_REPS = 10
# tier: (rr, tol, f64 residual limit, Rayleigh-quotient limit, launch key,
# solver keywords): the unsharded solve phases' settings and limits
SHARD_TIERS = {
    "fast": ("window", 2e-4, 1e-3, 1e-5, "symm_bf16", {}),
    "exact": ("full", 1e-5, 1e-4, 1e-8, "symm_f32", {}),
    "precise": ("full", 1e-5, 1e-4, 1e-8, "symm_split", {}),
    "int8": ("window", 5e-3, *INT8_LIMITS["int8"], "symm_int8", {}),
    "int8_precise": ("anchored", 1e-5, *INT8_LIMITS["int8_precise"], "symm_int8_split",
                     {"anchor_every": 2}),
}
# (kernel, tier, tile edge) of the per-rank kernel checks: the tiers'
# from_dense_symmetric tiles at n = 8192
SHARD_KERNELS = (("K1-bf16", "fast", 1024), ("K1-f32", "exact", 512), ("K3", "precise", 512),
                 ("K4", "int8", 1024), ("K5", "int8_precise", 1024))
# the rank that packs each tier's storage (the int8 tiers alone)
SHARD_PACKER = {"int8": 0, "int8_precise": 1, "fast": 2, "exact": 2, "precise": 3}
# K4 at the sharded flagship's shape (64 x 32768, a quarter of its pairs)
SHARD_FLAGSHIP_KERNEL = "K4@flagship"
# the rows of x at which the family phases launch each rank's K1-f32 (1:
# L-BFGS, DIIS and the parity RSPT, BFGS and DIIS; 4 and fewer: the parity
# Davidson and offload as roots converge; 8: Chebyshev), each checked as
# the 16-row case is (``K1-f32@<rows>x8192``)
SHARD_FAMILY_ROWS = (1, 4, 8)
# the unsharded kernel check of each per-rank check's shape
SHARD_UNSHARDED = {"K4": "K4@n8192", SHARD_FLAGSHIP_KERNEL: "K4"}


def dense_quality(x, matrix, ref_evals) -> dict:
    """The f64 checks of Ritz rows against a dense host matrix: the largest
    residual of the normalised rows, the sorted lowest Rayleigh quotients
    against ``ref_evals``, and max|X X^T - I| of the rows as returned."""
    import torch

    x64 = x.detach().to("cpu", torch.float64).numpy()[:, : matrix.shape[0]]
    xs = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
    ax = xs @ matrix  # matrix is symmetric
    rq = np.sum(xs * ax, axis=1)
    rq_low = np.sort(rq)[: len(ref_evals)]
    return {"f64_max_residual": float(np.max(np.linalg.norm(ax - rq[:, None] * xs, axis=1))),
            "rayleigh_quotients": rq_low.tolist(),
            "rq_max_abs_err": float(np.max(np.abs(rq_low - np.asarray(ref_evals)))),
            "orthonormality": float(np.max(np.abs(x64 @ x64.T - np.eye(x64.shape[0]))))}


def in_rank_turns(mesh, fn):
    """``fn()`` on each rank in turn, the others waiting, so a rank's timing
    has the card to itself; returns what ``fn`` returned on this rank."""
    from iterative_solver_torch.parallel.collectives import barrier

    out = None
    for r in range(mesh.size):
        barrier(mesh)
        if mesh.rank == r:
            out = fn()
    barrier(mesh)
    return out


def shard_storages(mesh, matrix, work_dir: str, tiers=None) -> dict:
    """{tier: host storage}: each tier's from_dense_symmetric storage of
    ``matrix`` at n = 8192 (tiles of 1024 for fast and the int8 tiers, 512
    for exact and precise; "exact" in float32, as the card holds it).
    Rank r packs its share of the tiers (SHARD_PACKER) and saves them in
    ``work_dir``; every rank then loads them all (the packing is the slow
    part: about 8 s for an int8 tier, 3 s for the others). ``tiers``: those
    of SHARD_KERNELS to pack (default all five)."""
    import torch

    from iterative_solver_torch.parallel.collectives import barrier
    from iterative_solver_torch.solvers.fused_davidson import packed_storage

    def path(tier):
        return os.path.join(work_dir, f"storage_{tier}.pt")

    wanted = [(tier, b) for _, tier, b in SHARD_KERNELS if tiers is None or tier in tiers]
    for tier, b in wanted:
        if SHARD_PACKER[tier] % mesh.size == mesh.rank:
            torch.save(packed_storage(matrix, tier, b, "cpu", dtype=torch.float32), path(tier))
    barrier(mesh)
    return {tier: torch.load(path(tier), weights_only=False) for tier, _ in wanted}


def shard_actions(mesh, storages) -> dict:
    """{tier: (matvec, operand, ShardedSymmetric)}: this rank's share of
    each tier's pairs on its device."""
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric

    out = {}
    for tier, sym in storages.items():
        ssym = ShardedSymmetric.from_storage(sym, mesh)
        out[tier] = (*ssym.matvec_fn(), ssym)
    return out


def unsharded_kernel(sym, device):
    """The unsharded kernel wrapper of a host storage moved to the card:
    ``fn(x) -> y``, the action the unsharded phases launch."""
    import torch

    return dataclasses.replace(sym, **{
        f.name: getattr(sym, f.name).to(device) for f in dataclasses.fields(sym)
        if isinstance(getattr(sym, f.name), torch.Tensor)}).kernel


# (profiler pattern, kernels per call) of a K1/K3 and a K4/K5 wrapper call
SHARD_DEVICE_PATTERNS = {False: ("symm_packed", SYMM_KERNELS), True: ("symm_int8", 2)}


def shard_kernel_case(mesh, name, ssym, op, x, sh, whole) -> tuple:
    """One kernel on this rank's pairs at x's shape: the partial against its
    plain version (1e-5 of max|y|; K4/K5 bit for bit), the same bits on a
    second call, and (rank 0, ``whole`` the unsharded kernel) the
    reduce-scattered y against the unsharded kernel's y (1e-5). Returns the
    record and its failures."""
    import torch

    matvec = ssym.matvec_fn()[0]
    y = ssym.partial(x, op)
    y_ref = ssym.local.plain(x)
    abs_err, rel = rel_err(y, y_ref)
    agrees = bool(torch.equal(y, y_ref)) if ssym.quantized else rel <= KERNEL_TOL
    same_bits = bool(torch.equal(ssym.partial(x, op), y))
    y_full = sh.gather(matvec(sh.shard(x), op), ssym.n)
    rec = {"phase": "sharded_kernels", "rank": mesh.rank, "name": name,
           "rows": x.shape[0], "n": ssym.n, "b": ssym.b, "pairs": ssym.n_local_pairs,
           "pairs_per_dev": ssym.pairs_per_dev, "max_abs_err": abs_err, "max_rel_err": rel,
           "bit_identical": ssym.quantized, "same_bits": same_bits}
    failures = []
    if whole is not None:
        _, rec["y_rel_err_vs_unsharded"] = rel_err(y_full, whole(x))
        if not rec["y_rel_err_vs_unsharded"] <= KERNEL_TOL:
            failures.append(f"y off the unsharded kernel's by {rec['y_rel_err_vs_unsharded']:.3e}")
    if not agrees:
        failures.append(f"rank partial off its plain version by {rel:.3e}")
    if not same_bits:
        failures.append("a second call gave other bits")
    return rec, failures


def shard_kernel_checks(mesh, matrix, storages, actions, device, flagship=None) -> list:
    """Phase a: each rank's K1-bf16, K1-f32, K3, K4 and K5 on its pairs at
    16 x 8192 (``shard_kernel_case``), per-rank and unsharded device ms
    from the profiler (one rank at a time; CUDA-event ms beside them), and
    one sharded matvec's collectives: calls, bytes staged each way and host
    ms; then K1-f32 at the family phases' rows (SHARD_FAMILY_ROWS, the same
    checks, CUDA-event ms); then K4 at the sharded flagship's shape, 64 x 32768 on the rank's
    quarter of its pairs (``flagship``: its ShardedSymmetric and host
    storage), CUDA-event ms only."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, collectives

    sh = block_sharding(mesh)
    n = matrix.shape[0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((NROOTS, n)),
                        dtype=torch.float32, device=device)
    x_local = sh.shard(x)
    recs = []
    for name, tier, b in SHARD_KERNELS:
        t0 = time.perf_counter()
        matvec, op, ssym = actions[tier]
        # (the unsharded kernel's device ms at this shape is the parent's
        # kernel check's)
        whole = unsharded_kernel(storages[tier], device) if mesh.rank == 0 else None
        rec, failures = shard_kernel_case(mesh, name, ssym, op, x, sh, whole)
        rec["tier"] = tier
        del whole
        pattern, per_call = SHARD_DEVICE_PATTERNS[ssym.quantized]
        rec["rank_device_ms"] = in_rank_turns(mesh, lambda: device_ms(
            lambda: ssym.partial(x, op), device, pattern, per_call)[0])
        rec["rank_plain_ms"] = in_rank_turns(mesh, lambda: time_ms(
            lambda: ssym.local.plain(x), device))
        # one sharded matvec, every rank at once: its collectives
        matvec(x_local, op)
        collectives.reset_counters()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for _ in range(SHARD_TIME_REPS):
            matvec(x_local, op)
        torch.cuda.synchronize(device)
        rec["matvec_wall_ms"] = 1e3 * (time.perf_counter() - t1) / SHARD_TIME_REPS
        rec["per_matvec"] = {
            "staged_calls": collectives.STAGED["calls"] / SHARD_TIME_REPS,
            "staged_bytes": collectives.STAGED["bytes"] / SHARD_TIME_REPS,
            "staged_ms": collectives.STAGED["ms"] / SHARD_TIME_REPS,
            "collective_bytes": collectives.TRAFFIC["bytes"] / SHARD_TIME_REPS}
        if failures:
            raise AssertionError(f"sharded_kernels {name}, rank {mesh.rank}: "
                                 + "; ".join(failures))
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
        torch.cuda.empty_cache()
    _, op, ssym = actions["exact"]
    whole = unsharded_kernel(storages["exact"], device) if mesh.rank == 0 else None
    for rows in SHARD_FAMILY_ROWS:
        t0 = time.perf_counter()
        name = f"K1-f32@{rows}x{n}"
        xr = x[:rows].contiguous()
        rec, failures = shard_kernel_case(mesh, name, ssym, op, xr, sh, whole)
        rec["tier"] = "exact"
        rec["rank_ms"] = in_rank_turns(mesh, lambda: time_ms(lambda: ssym.partial(xr, op),
                                                             device))
        rec["rank_plain_ms"] = in_rank_turns(mesh, lambda: time_ms(
            lambda: ssym.local.plain(xr), device))
        if failures:
            raise AssertionError(f"sharded_kernels {name}, rank {mesh.rank}: "
                                 + "; ".join(failures))
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
    del whole
    torch.cuda.empty_cache()
    if flagship is not None:
        t0 = time.perf_counter()
        ssym, host = flagship
        op = ssym.matvec_fn()[1]
        xf = torch.as_tensor(np.random.default_rng(2).standard_normal((FLAGSHIP_ROOTS, ssym.n)),
                             dtype=torch.float32, device=device)
        whole = unsharded_kernel(host, device) if mesh.rank == 0 else None
        rec, failures = shard_kernel_case(mesh, SHARD_FLAGSHIP_KERNEL, ssym, op, xf, sh, whole)
        del whole
        rec["tier"] = "int8"
        rec["rank_ms"] = in_rank_turns(mesh, lambda: time_ms(lambda: ssym.partial(xf, op),
                                                             device))
        rec["rank_plain_ms"] = in_rank_turns(mesh, lambda: time_ms(
            lambda: ssym.local.plain(xf), device, reps=3))
        if failures:
            raise AssertionError(f"sharded_kernels {SHARD_FLAGSHIP_KERNEL}, rank {mesh.rank}: "
                                 + "; ".join(failures))
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def shard_solve(mesh, matrix, actions, device, tier) -> dict:
    """Phase b: FusedDavidson's generic constructor with the tier's
    ShardedSymmetric matvec, at the unsharded phase's settings; the
    launches of this rank (init, probe, iterations, restarts; no chain),
    the collectives, and (rank 0) the f64 checks."""
    import torch

    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.parallel import block_sharding, collectives

    rr, tol, res_limit, rq_limit, key, kw = SHARD_TIERS[tier]
    matvec, op, _ = actions[tier]
    diag = np.diagonal(matrix)
    t0 = time.perf_counter()
    solver = FusedDavidson(matvec, diag, matrix.shape[0], NROOTS, m_max=M_MAX, rr=rr,
                           convergence_threshold=tol, max_iter=60, operand=op,
                           dtype=torch.float32, sharding=block_sharding(mesh), **kw)
    setup_s = time.perf_counter() - t0
    v0 = guess(diag, NROOTS)
    reset_launches()
    collectives.reset_counters()
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)   # returns host values: synced
    wall = time.perf_counter() - t0
    launches = solve_launches(key)
    staged, traffic = dict(collectives.STAGED), dict(collectives.TRAFFIC)
    t0 = time.perf_counter()
    _, _, _, iters2 = solver.run_on_device(v0)
    wall2 = time.perf_counter() - t0
    restarts = expected_restarts(iters, NROOTS, M_MAX)
    expected = {"action": 1 + 2 + iters + restarts, "chain": 0, "gram": 0}
    rec = {"phase": f"solve_sharded[{tier}]", "rank": mesh.rank, "world": mesh.size,
           "backend": mesh.backend, "tier": tier, "rr": rr, "tol": tol, "n": matrix.shape[0],
           "nroots": NROOTS, "m_max": M_MAX, "fuse_chain": solver.fuse_chain,
           "iterations": iters, "steady_iterations": iters2, "restarts": restarts,
           "converged": bool(np.max(errors) <= tol), "max_error": float(np.max(errors)),
           "evals": [float(e) for e in evals], "seconds": wall, "steady_seconds": wall2,
           "steady_seconds_per_iteration": wall2 / max(iters2, 1), "setup_seconds": setup_s,
           "launches": launches, "expected_launches": expected, "staged": staged,
           "collectives": traffic, "f64_residual_limit": res_limit, "rq_limit": rq_limit}
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: max error {np.max(errors):.3e} > {tol}")
    # (on the CPU, where calibrate_sharded_cpu.py runs this, nothing launches)
    if device.type == "cuda" and (launches != expected or launches["action"] == 0):
        failures.append(f"launches {launches} != expected {expected}")
    if mesh.rank == 0:
        rec.update(dense_quality(x, matrix, REFERENCE_EIGENVALUES))
        if not rec["f64_max_residual"] <= res_limit:
            failures.append(f"f64 residual {rec['f64_max_residual']:.3e} > {res_limit}")
        if not rec["rq_max_abs_err"] <= rq_limit:
            failures.append(f"Rayleigh quotients off by {rec['rq_max_abs_err']:.3e}")
        if not rec["orthonormality"] <= SHARD_ORTHO_LIMIT:
            failures.append(f"max|X X^T - I| {rec['orthonormality']:.3e}")
    if failures:
        raise AssertionError(f"solve_sharded[{tier}], rank {mesh.rank}: " + "; ".join(failures))
    return rec


def shard_flagship(mesh, work_dir: str, n: int = FLAGSHIP_N) -> tuple:
    """The flagship operator (synthetic_packed_int8(n, b=1024, seed=0)):
    the parent's, saved in ``work_dir``, or generated here; sharded by
    ShardedSymmetric.from_int8. Returns (ShardedSymmetric, host storage,
    diagonal, seconds)."""
    import torch

    from iterative_solver_torch.models.synthetic_fci import synthetic_packed_int8
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric

    t0 = time.perf_counter()
    saved = os.path.join(work_dir, "flagship.pt")
    if os.path.exists(saved):
        # the parent's flagship (the same seed), saved for the ranks
        sym = torch.load(saved, weights_only=False)
        diag = sym.diagonal.to(torch.float64).numpy()
    else:
        sym, diag = synthetic_packed_int8(n, b=1024, seed=0, device="cpu")
    return ShardedSymmetric.from_int8(sym, mesh), sym, diag, time.perf_counter() - t0


def shard_ppcg(mesh, device, flagship) -> dict:
    """Phase c: the PPCG flagship (64 roots of synthetic_packed_int8(n,
    b=1024, seed=0), rr_every 8, tol 5e-3) with the K4 matvec sharded by
    ShardedSymmetric.from_int8 (``flagship``: ``shard_flagship``'s); the
    flagship's limits (rank 0)."""
    import torch

    from iterative_solver_torch import FusedPPCG
    from iterative_solver_torch.models.synthetic_fci import implied_matmat_int8
    from iterative_solver_torch.parallel import block_sharding, collectives

    ssym, sym, diag, gen_s = flagship
    n = ssym.n
    matvec, op = ssym.matvec_fn()
    solver = FusedPPCG(matvec, diag, n, FLAGSHIP_ROOTS, rr_every=FLAGSHIP_RR_EVERY,
                       convergence_threshold=FLAGSHIP_TOL, max_iter=400, operand=op,
                       dtype=torch.float32, sharding=block_sharding(mesh))
    v0 = guess(diag, FLAGSHIP_ROOTS)
    reset_launches()
    collectives.reset_counters()
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(v0)
    wall = time.perf_counter() - t0
    launches = solve_launches("symm_int8")
    staged, traffic = dict(collectives.STAGED), dict(collectives.TRAFFIC)
    expected = ppcg_expected_launches(iters, device)
    rec = {"phase": "solve_sharded_ppcg", "rank": mesh.rank, "world": mesh.size, "n": n,
           "nroots": FLAGSHIP_ROOTS, "b": sym.b, "pairs": ssym.n_local_pairs,
           "tol": FLAGSHIP_TOL, "iterations": iters,
           "converged": bool(np.max(errors) <= FLAGSHIP_TOL),
           "max_error": float(np.max(errors)), "evals": [float(e) for e in evals],
           "seconds": wall, "seconds_per_iteration": wall / max(iters, 1),
           "generation_seconds": gen_s, "launches": launches, "expected_launches": expected,
           "staged": staged, "collectives": traffic}
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: max error {np.max(errors):.3e}")
    if device.type == "cuda" and (launches != expected or launches["action"] == 0):
        failures.append(f"launches {launches} != expected {expected}")
    if mesh.rank == 0:
        sym_dev = dataclasses.replace(
            sym, **{f: getattr(sym, f).to(device) for f in ("q", "gq", "ii", "jj", "diagonal")})
        rec.update(quality(x, lambda xs: implied_matmat_int8(xs, sym_dev, diag), diag,
                           FLAGSHIP_ROOTS))
        del sym_dev
        if not rec["f64_max_residual"] <= FLAGSHIP_RES_LIMIT:
            failures.append(f"f64 residual {rec['f64_max_residual']:.3e}")
        if not rec["orthonormality"] <= FLAGSHIP_ORTHO_LIMIT:
            failures.append(f"max|X X^T - I| {rec['orthonormality']:.3e}")
        if not rec["rq_minus_diag_max"] <= FLAGSHIP_SKIP_LIMIT:
            failures.append(f"a root is skipped: {rec['rq_minus_diag_max']:.3e}")
    if failures:
        raise AssertionError(f"solve_sharded_ppcg, rank {mesh.rank}: " + "; ".join(failures))
    return rec


def shard_bsr(mesh, device) -> dict:
    """Phase d: bench.py's sparse operator sharded by block rows
    (ShardedBSR: the plain per-rank body, no kernel), FusedDavidson with 16
    roots, m_max 64, rr "full", tol 1e-5; the sparse phase's limits."""
    import torch

    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr
    from iterative_solver_torch.parallel import block_sharding, collectives
    from iterative_solver_torch.parallel.sharded_bsr import ShardedBSR

    bsr, dense = synthetic_fci_bsr(SPARSE_N, block=SPARSE_BLOCK, density=0.3, seed=1,
                                   dtype=torch.float32, device="cpu")
    s = ShardedBSR.from_bsr(bsr, mesh)
    matvec, op = s.matvec_fn()
    solver = FusedDavidson(matvec, np.diagonal(dense), SPARSE_N, NROOTS, m_max=M_MAX,
                           rr="full", convergence_threshold=1e-5, max_iter=60, operand=op,
                           dtype=torch.float32, sharding=block_sharding(mesh))
    reset_launches()
    collectives.reset_counters()
    t0 = time.perf_counter()
    evals, x, errors, iters = solver.run_on_device(guess(np.diagonal(dense), NROOTS))
    wall = time.perf_counter() - t0
    launches = solve_launches("bsr")
    rec = {"phase": "solve_sharded_bsr", "rank": mesh.rank, "world": mesh.size, "n": SPARSE_N,
           "nroots": NROOTS, "iterations": iters, "converged": bool(np.max(errors) <= 1e-5),
           "max_error": float(np.max(errors)), "evals": [float(e) for e in evals],
           "seconds": wall, "launches": launches,
           "expected_launches": {"action": 0, "chain": 0, "gram": 0},
           "staged": dict(collectives.STAGED), "collectives": dict(collectives.TRAFFIC)}
    failures = []
    if not rec["converged"]:
        failures.append(f"not converged: max error {np.max(errors):.3e}")
    if launches != rec["expected_launches"]:
        failures.append(f"launches {launches}: the sharded BSR body launches no kernel")
    if mesh.rank == 0:
        rec.update(dense_quality(x, dense, REFERENCE_SPARSE_EIGENVALUES))
        if not rec["f64_max_residual"] <= 1e-4:
            failures.append(f"f64 residual {rec['f64_max_residual']:.3e}")
        if not rec["rq_max_abs_err"] <= 1e-8:
            failures.append(f"Rayleigh quotients off by {rec['rq_max_abs_err']:.3e}")
    if failures:
        raise AssertionError(f"solve_sharded_bsr, rank {mesh.rank}: " + "; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# The remaining families under sharding (ROADMAP.md Queue 1 item 6c), on the
# same ranks after phases a-d: each at its unsharded phase's settings and
# limits, the action each rank's K1-f32 ("exact", b = 512) or K3 ("precise")
# on its pairs through ShardedSymmetric, or the dense int8 planes' rank rows
# (torch._int_mm). Iteration counts within SHARD_ITER_SLACK of the unsharded
# card run, or of calibrate_sharded_cpu.py's unsharded float32 CPU run where
# the card has no unsharded twin (SHARD_FAMILY_CPU_ITERATIONS).

SHARD_FAMILIES = ("lbfgs", "diis", "refine", "nonsym", "banded", "chebyshev", "parity",
                  "offload")
# the parity families under sharding, float32 with K1-f32 per rank (the
# unsharded card phase runs them in float64 with a dense matmul, so it is
# not their twin): method -> (options, tolerance); RSPT on the bench matrix,
# BFGS on the quadratic of A+3I about np.linalg.solve(A+3I, b), DIIS on
# (A+3I)x + 0.05 x∘x − b (calibrate_sharded_cpu.py parity)
SHARD_PARITY = {"rspt": ("convergence_threshold=1e-5,max_iter=40", None),
                "bfgs": ("max_size_qspace=6", 1e-3),
                "diis": ("max_size_qspace=8", 1e-4)}
# the checks' limits: |sum of the RSPT series - the lowest eigenvalue|, BFGS's
# max|x - x*|, DIIS's f64 relative residual (the CPU's float32 on 4 ranks:
# 4.2e-8, 7.4e-7, 6.8e-7)
SHARD_PARITY_LIMITS = {"rspt": 1e-6, "bfgs": 1e-5, "diis": 2e-6}
# the offload phase: the parity Davidson (4 roots, tol 1e-5) on the bench
# matrix through each sharded store form
SHARD_OFFLOAD_FORMS = {"host": True, "streamed": "streamed"}
# the port's unsharded float32 CPU iterations of the phases whose card run
# has no unsharded twin (calibrate_sharded_cpu.py parity offload)
SHARD_FAMILY_CPU_ITERATIONS = {"parity_rspt": 4, "parity_bfgs": 4, "parity_diis": 4,
                               "offload_host": 3, "offload_streamed": 3}


def family_record(mesh, phase, key, iters, seconds, launches, expected, **extra) -> dict:
    """A sharded family phase's record: the rank, the iterations compared
    with the unsharded run ``key``, the seconds, the staged collectives and
    their count, this rank's launches against ``expected`` (K2, K6 and K7
    must stay 0)."""
    from iterative_solver_torch.parallel import collectives

    return {"phase": phase, "rank": mesh.rank, "world": mesh.size, "unsharded_key": key,
            "device_type": mesh.device.type,
            "iterations": iters, "seconds": seconds, "launches": launches,
            "expected_launches": expected, "staged": dict(collectives.STAGED),
            "collectives": dict(collectives.TRAFFIC),
            "staged_collectives": collectives.STAGED["calls"], **extra}


def family_launches(key: str) -> dict:
    """``solve_launches`` with the BSR action (K6) beside it."""
    return {**solve_launches(key), "bsr": read_launches("bsr")}


def family_check(rec, failures) -> dict:
    """Raise with the phase's failures and (on the card: on the CPU, where
    calibrate_sharded_cpu.py runs the phases, nothing launches) launch
    mismatches; else return ``rec``."""
    if rec["device_type"] == "cuda" and rec["launches"] != rec["expected_launches"]:
        failures.append(f"launches {rec['launches']} != expected {rec['expected_launches']}")
    if failures:
        raise AssertionError(f"{rec['phase']}, rank {rec['rank']}: " + "; ".join(failures))
    return rec


def begin_family() -> float:
    from iterative_solver_torch.parallel import collectives

    reset_launches()
    collectives.reset_counters()
    return time.perf_counter()


def shifted_action(actions):
    """(matvec, operand) of A + 3 I on this rank's slices: the "exact"
    tier's ShardedSymmetric matvec (K1-f32 on each rank's pairs) plus the
    shift on the rank's slice."""
    matvec, op, _ = actions["exact"]

    def shifted(x, operand):
        return matvec(x, operand) + LINEAR_SHIFT * x

    return shifted, op


def shard_lbfgs(mesh, device, matrix, actions, inputs) -> dict:
    """``solve_sharded_lbfgs``: FusedLBFGS at solve_lbfgs's settings on
    1/2 xᵀ(A+3I)x − bᵀx with ``sharding=``, the gradient (A+3I)x − b from
    the sharded K1-f32 action (one launch per evaluation on each rank, no
    autograd), f all-reduced; the f64 error against np.linalg.solve (rank
    0)."""
    import torch

    from iterative_solver_torch import FusedLBFGS
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.collectives import psum

    sh = block_sharding(mesh)
    n = matrix.shape[0]
    b_loc = sh.shard(linear_rhs(n)[0], torch.float32)
    matvec, op = shifted_action(actions)
    evaluations = [0]

    def value_and_grad(x, operand):
        evaluations[0] += 1
        g = matvec(x[None, :], operand)[0] - b_loc
        # f = 1/2 x.(A+3I)x - b.x = 1/2 x.g - 1/2 b.x
        return psum(0.5 * (torch.dot(x, g) - torch.dot(b_loc, x)), sh), g

    solver = FusedLBFGS(value_and_grad, n, history=LBFGS_HISTORY, dtype=torch.float32,
                        convergence_threshold=LBFGS_TOL, max_iter=LBFGS_MAX_ITER,
                        operand=op, sharding=sh)
    t0 = begin_family()
    x, f, gnorm, iters = solver.run(np.zeros(n))
    wall = time.perf_counter() - t0
    rec = family_record(mesh, "solve_sharded_lbfgs", "lbfgs", iters, wall,
                        family_launches("symm_f32"),
                        {"action": evaluations[0], "chain": 0, "gram": 0, "bsr": 0},
                        evaluations=evaluations[0], gnorm=gnorm, f=f, tol=LBFGS_TOL,
                        evals=[float(f)], launch_key="symm_f32")
    failures = [] if gnorm <= LBFGS_TOL else [f"gradient norm {gnorm:.3e} > {LBFGS_TOL}"]
    if mesh.rank == 0:
        rec["f64_solution_error"] = relative_error(x.cpu().numpy(), inputs["x_ref"])
        rec["f64_solution_error_limit"] = LBFGS_ERR_LIMIT
        if not rec["f64_solution_error"] <= LBFGS_ERR_LIMIT:
            failures.append(f"f64 solution error {rec['f64_solution_error']:.3e}")
    return family_check(rec, failures)


def shard_diis(mesh, device, matrix, actions, inputs) -> dict:
    """``solve_sharded_diis``: FusedDIIS at solve_fused_diis's settings on
    (A+3I)x + 0.05 x∘x − b with ``sharding=``, one sharded K1-f32 launch
    per residual on each rank; the f64 relative residual (rank 0)."""
    import torch

    from iterative_solver_torch import FusedDIIS
    from iterative_solver_torch.parallel import block_sharding

    sh = block_sharding(mesh)
    n = matrix.shape[0]
    b = linear_rhs(n)[0]
    b_loc = sh.shard(b, torch.float32)
    matvec, op = shifted_action(actions)

    def residual(x, operand):
        return matvec(x[None, :], operand)[0] + DIIS_EPS * x * x - b_loc

    solver = FusedDIIS(residual, n, max_size_qspace=DIIS_M, dtype=torch.float32,
                       convergence_threshold=DIIS_TOL, max_iter=DIIS_MAX_ITER, operand=op,
                       diagonals=np.diagonal(matrix) + LINEAR_SHIFT, sharding=sh)
    t0 = begin_family()
    x, err, iters = solver.run(np.zeros(n))
    wall = time.perf_counter() - t0
    rec = family_record(mesh, "solve_sharded_diis", "diis", iters, wall,
                        family_launches("symm_f32"),
                        {"action": 1 + iters, "chain": 0, "gram": 0, "bsr": 0}, err=err,
                        tol=DIIS_TOL, evals=[float(err)], launch_key="symm_f32")
    failures = [] if err <= DIIS_TOL else [f"err {err:.3e} > {DIIS_TOL}"]
    if mesh.rank == 0:
        x = x.to("cpu", torch.float64).numpy()
        res = float(np.linalg.norm(matrix @ x + LINEAR_SHIFT * x + DIIS_EPS * x * x - b)
                    / np.linalg.norm(b))
        rec.update(f64_relative_residual=res, f64_residual_limit=DIIS_RES_LIMIT)
        if not res <= DIIS_RES_LIMIT:
            failures.append(f"f64 relative residual {res:.3e} > {DIIS_RES_LIMIT}")
    return family_check(rec, failures)


def shard_refine(mesh, device, matrix, actions, inputs) -> dict:
    """``refine_sharded``: EigenpairRefiner from the unsharded refinement's
    input (the parent's precise solve) with ``sharding=``, the deflated CG
    on the "precise" ShardedSymmetric matvec (K3 on each rank's pairs; the
    CG init's action and one per CG iteration), the f64 action on the
    rank's device: the 1e-8 bar and the eigenvalues within 1e-9."""
    import torch

    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers.refine import EigenpairRefiner

    matvec, op, _ = actions["precise"]
    a64 = torch.as_tensor(matrix, dtype=torch.float64, device=device)

    def action_f64(xs):
        return (torch.as_tensor(xs, dtype=torch.float64, device=device) @ a64).cpu().numpy()

    refiner = EigenpairRefiner(action_f64, matvec, op, np.diagonal(matrix), matrix.shape[0],
                               NROOTS, dtype=torch.float32, sharding=block_sharding(mesh))
    t0 = begin_family()
    out = refiner.refine(inputs["refine_x0"], tol=REFINE_TOL)
    wall = time.perf_counter() - t0
    del a64
    rq_err = float(np.max(np.abs(np.sort(out.eigenvalues)[:4] - REFERENCE_EIGENVALUES)))
    rec = family_record(mesh, "refine_sharded", "refine", out.passes, wall,
                        family_launches("symm_split"),
                        {"action": sum(1 + it for it in refiner.cg_iterations), "chain": 0,
                         "gram": 0, "bsr": 0},
                        passes=out.passes, cg_iterations=refiner.cg_iterations,
                        history=out.history, converged=out.converged,
                        f64_max_residual=float(out.residual_norms.max()),
                        f64_residual_limit=REFINE_TOL, rq_max_abs_err=rq_err,
                        rq_limit=REFINE_RQ_LIMIT, launch_key="symm_split",
                        evals=[float(e) for e in out.eigenvalues])
    failures = []
    if not out.converged or not out.residual_norms.max() <= REFINE_TOL:
        failures.append(f"not refined to {REFINE_TOL}: history {out.history}")
    if not rq_err <= REFINE_RQ_LIMIT:
        failures.append(f"eigenvalues off by {rq_err:.3e} > {REFINE_RQ_LIMIT}")
    return family_check(rec, failures)


def shard_nonsym(mesh, device, matrix, actions, inputs) -> dict:
    """``solve_sharded_nonsym``: leg_nonsym's operator (n = 8192) in the
    int8_precise tier, rows sharded by ``DenseInt8Split.shard``, x
    gathered and quantized over its full rows, ``torch._int_mm`` on the
    rank's rows; FusedNonSymDavidson with rr "device" at solve_nonsym's
    settings and limits (rank 0: the f64 residuals, the eigenvalues against
    NONSYM_REFERENCE_EIGENVALUES); no kernel of the port launched."""
    import torch

    from iterative_solver_torch import FusedNonSymDavidson
    from iterative_solver_torch.ops.kernels.dense_int8 import (
        DenseInt8Split,
        sharded_matvec_split,
    )
    from iterative_solver_torch.parallel import block_sharding

    tol, res_limit, ev_limit, _ = NONSYM_TIERS["int8_precise"]
    m = nonsym_matrix()
    t0 = time.perf_counter()
    tree = DenseInt8Split.from_dense(m, device="cpu").shard(mesh)
    setup_s = time.perf_counter() - t0
    solver = FusedNonSymDavidson(sharded_matvec_split(mesh), np.diag(m), NONSYM_N,
                                 NONSYM_ROOTS, m_max=NONSYM_M_MAX, dtype=torch.float32,
                                 convergence_threshold=tol, max_iter=NONSYM_MAX_ITER,
                                 operand=tree, rr="device", sharding=block_sharding(mesh))
    t0 = begin_family()
    evals, x, errors, iters = solver.solve(guess(np.diag(m), NONSYM_ROOTS))
    wall = time.perf_counter() - t0
    launches = {**family_launches("symm_f32"), "all": sum(kernel_launches().values())}
    rec = family_record(mesh, "solve_sharded_nonsym", "nonsym", iters, wall, launches,
                        {"action": 0, "chain": 0, "gram": 0, "bsr": 0, "all": 0},
                        nonsym_tier="int8_precise", rr="device", tol=tol,
                        setup_seconds=setup_s,
                        max_error=float(np.max(errors)), roots_returned=len(evals),
                        evals=[float(e) for e in np.real(evals)])
    failures = []
    if not np.max(errors) <= tol or len(evals) != NONSYM_ROOTS:
        failures.append(f"{len(evals)} roots, max error {np.max(errors):.3e} > {tol}")
    if mesh.rank == 0:
        a64 = torch.as_tensor(m, dtype=torch.float64, device=device)
        rec.update(nonsym_quality(x, evals, a64), f64_residual_limit=res_limit,
                   eigenvalue_max_abs_err=eigenvalue_error(evals, NONSYM_REFERENCE_EIGENVALUES),
                   eigenvalue_limit=ev_limit)
        del a64
        if not rec["f64_max_residual"] <= res_limit:
            failures.append(f"f64 residual {rec['f64_max_residual']:.3e} > {res_limit}")
        if not rec["eigenvalue_max_abs_err"] <= ev_limit:
            failures.append(f"eigenvalues {rec['eigenvalue_max_abs_err']:.3e} > {ev_limit}")
    return family_check(rec, failures)


def shard_banded(mesh, device, matrix, actions, inputs) -> dict:
    """``solve_sharded_banded``: BandedEigensolver for the 32 lowest roots
    in bands of 16, m_max 96, tol 5e-5 (the held device mode) with
    ``sharding=``, the deflated sharded K1-f32 action; solve_banded's
    limits (rank 0) and launches (init + iterations + restarts of each
    band; no chain under sharding)."""
    import torch

    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers import BandedEigensolver

    matvec, op, _ = actions["exact"]
    deflate, band, m_max, tol = BANDED_MODES["device"]
    solver = BandedEigensolver(matvec, np.diagonal(matrix), matrix.shape[0], band=band,
                               m_max=m_max, dtype=torch.float32, convergence_threshold=tol,
                               max_iter=BANDED_MAX_ITER, operand=op, deflate=deflate,
                               sharding=block_sharding(mesh))
    t0 = begin_family()
    vals, vecs, errs = solver.solve(BANDED_ROOTS)
    wall = time.perf_counter() - t0
    expected = {"action": k1_launches_of_solve(solver.runs, m_max, probe=False), "chain": 0,
                "gram": 0, "bsr": 0}
    rec = family_record(mesh, "solve_sharded_banded", "banded",
                        sum(it for _, it in solver.runs), wall, family_launches("symm_f32"),
                        expected, runs=solver.runs, band=band, m_max=m_max, tol=tol,
                        n_locked=solver.n_locked, max_error=float(np.max(errs)),
                        evals=[float(v) for v in vals], launch_key="symm_f32")
    failures = []
    if mesh.rank == 0:
        q = many_root_quality(vals, vecs, matrix, BANDED_REFERENCE_EIGENVALUES)
        res_limit, rq_limit = BANDED_LIMITS["device"]
        rec.update(q, limits=[res_limit, rq_limit])
        if not q["f64_max_residual"] <= res_limit:
            failures.append(f"f64 residual {q['f64_max_residual']:.3e} > {res_limit}")
        if not q["rq_max_abs_err"] <= rq_limit:
            failures.append(f"Rayleigh quotients off by {q['rq_max_abs_err']:.3e}")
        if not q["ortho_max"] <= BANDED_ORTHO_LIMIT:
            failures.append(f"max|X X^T - I| = {q['ortho_max']:.3e}")
    if solver.n_locked != BANDED_ROOTS:
        failures.append(f"{solver.n_locked} rows locked, not {BANDED_ROOTS}")
    return family_check(rec, failures)


def shard_flat_operator(mesh, device, work_dir: str):
    """The flat operator of solve_chebyshev: rank 0 builds it
    (``flat_operator``) and saves its packed "exact" storage (host, float32)
    and diagonal for the other ranks; returns (storage, diagonal, the f64
    operator on rank 0's device or None, w)."""
    import torch

    from iterative_solver_torch.parallel.collectives import barrier

    path = os.path.join(work_dir, "flat.pt")
    a64 = None
    if mesh.rank == 0:
        a64, (_, fsym), w = flat_operator(N, device)
        host = dataclasses.replace(fsym, **{
            f.name: getattr(fsym, f.name).cpu() for f in dataclasses.fields(fsym)
            if isinstance(getattr(fsym, f.name), torch.Tensor)})
        torch.save((host, torch.diagonal(a64).cpu().numpy()), path)
        del fsym
    barrier(mesh)
    host, fdiag = torch.load(path, weights_only=False)
    return host, fdiag, a64, flat_spectrum(N)


def shard_chebyshev(mesh, device, matrix, actions, inputs) -> dict:
    """``solve_sharded_chebyshev``: make_chebyshev_davidson (degree 4, m_max
    64, rr "full", 8 roots, tol 1e-4) on the flat-diagonal operator with
    ``sharding=``: the Lanczos bounds sharded, the filter around the
    sharded K1-f32 matvec; solve_chebyshev's flat limits (rank 0), the
    matvec identity and the launches (bounds, probe, init, degree + 1 per
    iteration, one per restart; no chain)."""
    import torch

    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric
    from iterative_solver_torch.solvers import make_chebyshev_davidson

    t0 = time.perf_counter()
    host, fdiag, a64, w = shard_flat_operator(mesh, device, inputs["work_dir"])
    matvec, op = ShardedSymmetric.from_symmetric(host, mesh).matvec_fn()
    del host
    setup_s = time.perf_counter() - t0
    t0 = begin_family()
    solver = make_chebyshev_davidson(matvec, fdiag, N, nroots=FLAT_ROOTS, degree=CHEB_DEGREE,
                                     m_max=CHEB_M_MAX, rr="full", operand=op,
                                     convergence_threshold=FLAT_TOL, max_iter=FLAT_MAX_ITER,
                                     dtype=torch.float32, sharding=block_sharding(mesh))
    evals, x, errors, iters = solver.run_on_device(guess(fdiag, FLAT_ROOTS))
    wall = time.perf_counter() - t0
    expected = {"action": k1_launches_of_solve([(FLAT_ROOTS, iters)], CHEB_M_MAX, probe=True,
                                               per_iteration=CHEB_DEGREE + 1) + LANCZOS_ITERS,
                "chain": 0, "gram": 0, "bsr": 0}
    rec = family_record(mesh, "solve_sharded_chebyshev", "chebyshev", iters, wall,
                        family_launches("symm_f32"), expected, setup_seconds=setup_s,
                        matvecs=solver.matvecs,
                        matvecs_identity=FLAT_ROOTS + iters * FLAT_ROOTS * CHEB_DEGREE,
                        max_error=float(np.max(errors)), tol=FLAT_TOL,
                        evals=[float(e) for e in evals], launch_key="symm_f32")
    failures = []
    if not np.max(errors) <= FLAT_TOL:
        failures.append(f"not converged: max error {np.max(errors):.3e}")
    if rec["matvecs"] != rec["matvecs_identity"]:
        failures.append(f"matvecs {rec['matvecs']} != {rec['matvecs_identity']}")
    if mesh.rank == 0:
        xd = x.detach().to(device, torch.float64)
        xd = xd / torch.linalg.vector_norm(xd, dim=1, keepdim=True)
        ax = xd @ a64
        rq = torch.sum(xd * ax, dim=1)
        res = float(torch.linalg.vector_norm(ax - rq[:, None] * xd, dim=1).max())
        rq_err = float(np.abs(np.sort(rq.cpu().numpy()) - w[:FLAT_ROOTS]).max())
        res_limit, rq_limit = CHEB_LIMITS["flat"]
        rec.update(f64_max_residual=res, rq_max_abs_err=rq_err, limits=[res_limit, rq_limit])
        del a64, xd, ax
        if not res <= res_limit:
            failures.append(f"f64 residual {res:.3e} > {res_limit}")
        if not rq_err <= rq_limit:
            failures.append(f"Rayleigh quotients off by {rq_err:.3e} > {rq_limit}")
    return family_check(rec, failures)


def slice_problem(action=None, residual=None, diagonals=None):
    """A parity ``Problem`` written per rank slice, counting its calls (one
    sharded K1-f32 launch each): ``action(rows)``; or ``residual(x) ->
    (global value, the rank's slice of the residual)``."""
    import iterative_solver_torch as its

    class SliceProblem(its.Problem):
        calls = 0

        def action(self, parameters):
            SliceProblem.calls += 1
            return action(parameters)

        def residual(self, parameters):
            SliceProblem.calls += 1
            return residual(parameters)

        def diagonals(self):
            return diagonals

    return SliceProblem()


def shard_parity(mesh, device, matrix, actions, inputs) -> list:
    """``solve_sharded_parity[rspt|bfgs|diis]``: the parity families with
    ``sharding=`` in float32, each action or residual one sharded K1-f32
    launch per rank: RSPT (create_linear_eigensystem(n, 1, "RSPT")) on the
    bench matrix, its series' sum against the lowest eigenvalue;
    create_optimize(n, "BFGS") on 1/2 (x − x*)ᵀ(A+3I)(x − x*), x* =
    np.linalg.solve(A+3I, b); create_nonlinear_equations(n, "DIIS") on
    (A+3I)x + 0.05 x∘x − b; the problems written per slice (global value,
    the rank's slice of the gradient)."""
    import torch

    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.collectives import psum

    sh = block_sharding(mesh)
    n = matrix.shape[0]
    f32 = dict(dtype=torch.float32, sharding=sh)
    matvec, op, _ = actions["exact"]
    shifted, _ = shifted_action(actions)
    diag = np.diagonal(matrix)
    b_loc = sh.shard(linear_rhs(n)[0], torch.float32)
    xref_loc = sh.shard(inputs["x_ref"], torch.float32)

    def quadratic(x):
        d = x - xref_loc
        g = shifted(d[None, :], op)[0]
        return float(psum(0.5 * torch.dot(d, g), sh)), g

    def equations(x):
        return 0.0, shifted(x[None, :], op)[0] + DIIS_EPS * x * x - b_loc

    cases = {
        "rspt": (lambda: its.create_linear_eigensystem(n, 1, "RSPT", SHARD_PARITY["rspt"][0],
                                                       **f32),
                 slice_problem(action=lambda p: matvec(p, op), diagonals=diag)),
        "bfgs": (lambda: its.create_optimize(n, "BFGS", SHARD_PARITY["bfgs"][0], **f32),
                 slice_problem(residual=quadratic, diagonals=diag + LINEAR_SHIFT)),
        "diis": (lambda: its.create_nonlinear_equations(n, "DIIS", SHARD_PARITY["diis"][0],
                                                        **f32),
                 slice_problem(residual=equations, diagonals=diag + LINEAR_SHIFT)),
    }
    recs = []
    for name in SHARD_PARITY:
        make, problem = cases[name]
        solver = make()
        solver.verbosity = its.Verbosity.NONE
        if SHARD_PARITY[name][1] is not None:
            solver.convergence_threshold = SHARD_PARITY[name][1]
        type(problem).calls = 0
        t0 = begin_family()
        converged, x, _ = solver.solve(np.zeros((1, n)), problem=problem,
                                       generate_initial_guess=name == "rspt")
        wall = time.perf_counter() - t0
        calls = type(problem).calls
        rec = family_record(mesh, f"solve_sharded_parity[{name}]", f"parity_{name}",
                            solver.stats.iterations, wall, family_launches("symm_f32"),
                            {"action": calls, "chain": 0, "gram": 0, "bsr": 0},
                            converged=bool(converged), stats=str(solver.stats),
                            options=SHARD_PARITY[name][0], launch_key="symm_f32",
                            evals=[float(e) for e in (solver.rspt_values if name == "rspt"
                                                      else solver.errors)])
        failures = [] if converged else [f"not converged: errors {solver.errors}"]
        limit = SHARD_PARITY_LIMITS[name]
        check = 0.0
        if name == "rspt":
            rec["rspt_sum_error"] = abs(sum(solver.rspt_values) - REFERENCE_EIGENVALUES[0])
            check = rec["rspt_sum_error"]
        else:
            # every rank takes part in the gather; rank 0 checks
            xs = sh.gather(x[0], n).to("cpu", torch.float64).numpy()
        if name == "bfgs" and mesh.rank == 0:
            check = rec["max_abs_error"] = float(np.max(np.abs(xs - inputs["x_ref"])))
        elif name == "diis" and mesh.rank == 0:
            b = linear_rhs(n)[0]
            check = rec["f64_relative_residual"] = float(
                np.linalg.norm(matrix @ xs + LINEAR_SHIFT * xs + DIIS_EPS * xs * xs - b)
                / np.linalg.norm(b))
        rec["limit"] = limit
        if not check <= limit:
            failures.append(f"{check:.3e} > {limit}")
        recs.append(family_check(rec, failures))
    return recs


def shard_offload(mesh, device, matrix, actions, inputs) -> list:
    """``offload_sharded[host|streamed]``: the parity Davidson (4 roots,
    tol 1e-5, float32) on the bench matrix through a sharded
    OffloadBasisStore (host float64) and StreamedOffloadStore, each rank's
    slice of each row in its own file; one sharded K1-f32 launch per
    iteration; the parity phase's limits (rank 0)."""
    import torch

    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding

    sh = block_sharding(mesh)
    n = matrix.shape[0]
    matvec, op, _ = actions["exact"]
    recs = []
    for form, offload in SHARD_OFFLOAD_FORMS.items():
        solver = its.create_linear_eigensystem(n, PARITY_ROOTS, "Davidson",
                                               "convergence_threshold=1e-5", offload=offload,
                                               dtype=torch.float32, sharding=sh)
        solver.set_hermiticity(True)
        solver.verbosity = its.Verbosity.NONE
        problem = slice_problem(action=lambda p: matvec(p, op), diagonals=np.diagonal(matrix))
        t0 = begin_family()
        converged, _, _ = solver.solve(np.zeros((PARITY_ROOTS, n)), problem=problem,
                                       generate_initial_guess=True)
        wall = time.perf_counter() - t0
        iters = solver.stats.iterations
        rec = family_record(mesh, f"offload_sharded[{form}]", f"offload_{form}", iters, wall,
                            family_launches("symm_f32"),
                            {"action": iters, "chain": 0, "gram": 0, "bsr": 0},
                            store=type(solver.xspace.store_v).__name__,
                            converged=bool(converged), stats=str(solver.stats),
                            launch_key="symm_f32",
                            evals=[float(e) for e in solver.eigenvalues()])
        failures = [] if converged else [f"not converged: errors {solver.errors}"]
        params, _ = solver.solution(list(range(PARITY_ROOTS)))
        params = sh.gather(params, n)
        if mesh.rank == 0:
            q = dense_quality(params, matrix, REFERENCE_EIGENVALUES[:PARITY_ROOTS])
            rec.update({k: q[k] for k in ("f64_max_residual", "rq_max_abs_err")})
            if not q["f64_max_residual"] <= 1e-4:
                failures.append(f"f64 residual {q['f64_max_residual']:.3e} > 1e-4")
            if not q["rq_max_abs_err"] <= 1e-8:
                failures.append(f"Rayleigh quotients off by {q['rq_max_abs_err']:.3e}")
        recs.append(family_check(rec, failures))
        solver.xspace.store_v.close()
        solver.xspace.store_a.close()
    return recs


SHARD_FAMILY_RUNNERS = {"lbfgs": shard_lbfgs, "diis": shard_diis, "refine": shard_refine,
                        "nonsym": shard_nonsym, "banded": shard_banded,
                        "chebyshev": shard_chebyshev, "parity": shard_parity,
                        "offload": shard_offload}
# the storages each family needs
SHARD_FAMILY_TIERS = {"lbfgs": ("exact",), "diis": ("exact",), "refine": ("precise",),
                      "banded": ("exact",), "parity": ("exact",), "offload": ("exact",)}


SHARD_PHASES = ("kernels", "solves", "ppcg", "bsr") + SHARD_FAMILIES


def shard_worker(rank: int, world: int, store: str, out_dir: str, device_kind: str,
                 phases, flagship_n: int = FLAGSHIP_N) -> None:
    """One rank: join the gloo group through the file store, run ``phases``
    and write the records to ``<out_dir>/rank<r>.json``."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    from iterative_solver_torch.parallel import init_process_group

    device = torch.device(device_kind) if device_kind == "cpu" else torch.device("cuda", 0)
    mesh = init_process_group(f"file://{store}", world, rank, backend="gloo", device=device)
    recs = [{"phase": "shard_rank", "rank": rank, "world": world, "backend": mesh.backend,
             "device": str(device), "staged": device.type == "cuda"}]
    families = [f for f in SHARD_FAMILIES if f in phases]
    tiers = None if {"kernels", "solves"} & set(phases) else {
        t for f in families for t in SHARD_FAMILY_TIERS.get(f, ())}
    matrix, storages, actions = None, {}, {}
    if tiers is None or tiers or families:
        t0 = time.perf_counter()
        matrix = bench_matrix(N)
        if tiers is None or tiers:
            storages = shard_storages(mesh, matrix, out_dir, tiers)
            actions = shard_actions(mesh, storages)
        recs.append({"phase": "shard_setup", "rank": rank,
                     "seconds": time.perf_counter() - t0})
    flagship = None
    if {"kernels", "ppcg"} & set(phases):
        flagship = shard_flagship(mesh, out_dir, flagship_n)
    if "kernels" in phases:
        recs += shard_kernel_checks(mesh, matrix, storages, actions, device, flagship[:2])
        recs.append({"phase": "shard_profile_retries", "rank": rank,
                     "retries": list(PROFILE_RETRIES)})
    if "solves" in phases:
        recs += [shard_solve(mesh, matrix, actions, device, tier) for tier in SHARD_TIERS]
    if "ppcg" in phases:
        recs.append(shard_ppcg(mesh, device, flagship))
    if "bsr" in phases:
        recs.append(shard_bsr(mesh, device))
    if families:
        inputs = {"work_dir": out_dir}
        with np.load(os.path.join(out_dir, "inputs.npz")) as z:
            inputs.update({k: z[k] for k in z.files})
        for family in families:
            out = SHARD_FAMILY_RUNNERS[family](mesh, device, matrix, actions, inputs)
            recs += out if isinstance(out, list) else [out]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(recs, f)
    torch.distributed.destroy_process_group()


def spawn_shards(phases, device_kind: str = "cuda", world: int = SHARD_WORLD,
                 flagship_n: int = FLAGSHIP_N, timeout: float = SHARD_TIMEOUT_S,
                 flagship=None, inputs=None) -> list:
    """Run ``phases`` on ``world`` rank processes of this script; returns
    each rank's records. ``flagship``: the parent's flagship operator (host
    tensors), saved for the ranks; ``inputs``: the parent's arrays the
    family phases read ({"x_ref", "refine_x0"}), saved for the ranks.
    Any rank that fails, or outlives ``timeout``,
    fails the run; every process started is ended."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        if flagship is not None:
            torch.save(flagship, os.path.join(tmp, "flagship.pt"))
        if inputs is not None:
            np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        store = os.path.join(tmp, "store")
        cmd = [sys.executable, os.path.abspath(__file__), "--shard-worker"]
        procs = [subprocess.Popen(
            cmd + [str(r), str(world), store, tmp, device_kind, str(flagship_n), *phases],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if len(outs) < world or any(p.returncode != 0 for p in procs):
            tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{(o or '')[-4000:]}"
                              for r, (p, o) in enumerate(zip(procs, outs + [""] * world)))
            raise AssertionError(f"a sharded rank failed:\n{tails}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks


def run_sharded(device, unsharded_iters: dict, flagship, kernels, inputs=None) -> dict:
    """Phases a-d and the family phases on SHARD_WORLD ranks; emits one
    record per phase (rank 0's, with every rank's launches, times and
    staged collectives beside it) and checks that every rank returned the
    same bits of the eigenvalues and that each sharded solve took within
    SHARD_ITER_SLACK iterations of the unsharded run (``unsharded_iters``
    by tier or family key; SHARD_FAMILY_CPU_ITERATIONS where the card has
    no unsharded twin); ``kernels`` are the kernel checks' records (the
    unsharded device ms beside each rank's); ``inputs`` the family phases'
    arrays. Returns {kernel: per-rank launches on the sharded solves} and
    the per-rank kernel times."""
    t0 = time.perf_counter()
    ranks = spawn_shards(SHARD_PHASES, flagship=flagship, inputs=inputs)
    unsharded_iters = {**SHARD_FAMILY_CPU_ITERATIONS, **unsharded_iters}
    # the unsharded kernel check at each per-rank check's shape
    by_name = {k["name"]: k for k in kernels}
    emit({"phase": "sharded_ranks", "world": len(ranks), "seconds": time.perf_counter() - t0,
          "ranks": [r[0] for r in ranks]})
    by_phase = {}
    for r, recs in enumerate(ranks):
        for rec in recs[1:]:
            key = rec["phase"] + rec.get("name", "")
            by_phase.setdefault(key, []).append(rec)
    rank_launches = {name: [0] * len(ranks) for name, _, _ in SHARD_KERNELS}
    rank_ms = {}
    failures = []
    for key, recs in by_phase.items():
        head = dict(recs[0])
        if head["phase"] == "shard_setup":
            emit({"phase": "shard_setup", "rank_seconds": [rec["seconds"] for rec in recs]})
            continue
        if head["phase"] == "shard_profile_retries":
            emit({"phase": "shard_profile_retries", "ranks": [rec["retries"] for rec in recs]})
            continue
        if head["phase"] == "sharded_kernels":
            for key_ in ("rank_device_ms", "rank_ms", "rank_plain_ms", "pairs", "per_matvec",
                         "seconds"):
                if key_ in head:
                    head[key_] = [rec[key_] for rec in recs]
            # (the family rows' checks have no unsharded timing beside them)
            whole = by_name.get(SHARD_UNSHARDED.get(head["name"], head["name"]))
            if whole is not None:
                head["unsharded_device_ms"] = whole["kernel_device_ms"]
                head["unsharded_ms"] = whole["ms"]
            if head["name"] in rank_launches:
                rank_ms[head["name"]] = head["rank_device_ms"]
            emit(head)
            continue
        head["rank_launches"] = [rec["launches"] for rec in recs]
        head["rank_seconds"] = [rec["seconds"] for rec in recs]
        head["evals_same_bits_on_every_rank"] = all(rec["evals"] == recs[0]["evals"]
                                                    for rec in recs)
        if not head["evals_same_bits_on_every_rank"]:
            failures.append(f"{key}: the ranks returned different eigenvalues")
        if "unsharded_key" in head:
            # a family phase: its rank-0 record, every rank's staged
            # collectives beside it
            head["rank_staged_collectives"] = [rec["staged_collectives"] for rec in recs]
            ukey = head["unsharded_key"]
            head["unsharded_iterations"] = unsharded_iters.get(ukey)
            if abs(head["iterations"] - unsharded_iters[ukey]) > SHARD_ITER_SLACK:
                failures.append(f"{key}: {head['iterations']} iterations, the unsharded run "
                                f"{unsharded_iters[ukey]}")
            kname = LAUNCH_NAMES.get(head.get("launch_key"))
            if kname in rank_launches:
                for r, rec in enumerate(recs):
                    rank_launches[kname][r] += rec["launches"]["action"]
            emit(head)
            continue
        tier = head.get("tier")
        if tier in unsharded_iters:
            head["unsharded_iterations"] = unsharded_iters[tier]
            if abs(head["iterations"] - unsharded_iters[tier]) > SHARD_ITER_SLACK:
                failures.append(f"{key}: {head['iterations']} iterations, the unsharded run "
                                f"{unsharded_iters[tier]}")
        lkey = SHARD_TIERS[tier][4] if tier else (
            "symm_int8" if head["phase"] == "solve_sharded_ppcg" else None)
        kname = LAUNCH_NAMES.get(lkey)
        if kname in rank_launches:
            for r, rec in enumerate(recs):
                rank_launches[kname][r] += rec["launches"]["action"]
        emit(head)
    for kname, counts in rank_launches.items():
        if min(counts) == 0:
            failures.append(f"{kname} was launched on no sharded solve of a rank: {counts}")
    if failures:
        raise AssertionError("sharded phases: " + "; ".join(failures))
    return {"rank_launches": rank_launches, "rank_ms": rank_ms}


def nccl_world1(matrix, device) -> dict:
    """Phase e: NCCL at world size 1 in this process (a ``file://`` store in
    a temporary directory, so runs side by side never share a rendezvous):
    the "exact" solve with sharding against the same solve without it and
    without the chain kernel (the sharded path never fuses the chain):
    equal iterations, eigenvalues within 1e-6."""
    import tempfile

    import torch

    from iterative_solver_torch import FusedDavidson
    from iterative_solver_torch.parallel import block_sharding, collectives, init_process_group

    rr, tol, res_limit, rq_limit, key, kw = SHARD_TIERS["exact"]
    common = dict(tier="exact", m_max=M_MAX, rr=rr, convergence_threshold=tol, max_iter=60)
    v0 = guess(np.diagonal(matrix), NROOTS)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_process_group(f"file://{tmp}/nccl_store", 1, 0, backend="nccl",
                                  device=device)
        try:
            single = FusedDavidson.from_dense_symmetric(matrix, NROOTS, fuse_chain=False,
                                                        **common)
            s_evals, _, _, s_iters = single.run_on_device(v0)
            sharded = FusedDavidson.from_dense_symmetric(matrix, NROOTS,
                                                         sharding=block_sharding(mesh), **common)
            reset_launches()
            collectives.reset_counters()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            evals, x, errors, iters = sharded.run_on_device(v0)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            launches = solve_launches(key)
            staged, traffic = dict(collectives.STAGED), dict(collectives.TRAFFIC)
        finally:
            torch.distributed.destroy_process_group()
    restarts = expected_restarts(iters, NROOTS, M_MAX)
    expected = {"action": 1 + 2 + iters + restarts, "chain": 0, "gram": 0}
    rec = {"phase": "nccl_world1", "backend": mesh.backend, "world": mesh.size,
           "iterations": iters, "unsharded_iterations": s_iters, "seconds": wall,
           "max_error": float(np.max(errors)),
           "evals_max_abs_diff": float(np.max(np.abs(np.asarray(evals) - np.asarray(s_evals)))),
           "launches": launches, "expected_launches": expected, "staged": staged,
           "collectives": traffic, **dense_quality(x, matrix, REFERENCE_EIGENVALUES)}
    emit(rec)
    failures = []
    if iters != s_iters:
        failures.append(f"{iters} iterations, unsharded {s_iters}")
    if not rec["evals_max_abs_diff"] <= 1e-6:
        failures.append(f"eigenvalues off the unsharded by {rec['evals_max_abs_diff']:.3e}")
    if not np.max(errors) <= tol:
        failures.append(f"not converged: {np.max(errors):.3e}")
    if launches != expected or staged["calls"] != 0:
        failures.append(f"launches {launches} (expected {expected}), staged {staged}")
    if not rec["f64_max_residual"] <= res_limit or not rec["rq_max_abs_err"] <= rq_limit:
        failures.append(f"f64 checks {rec['f64_max_residual']:.3e}, {rec['rq_max_abs_err']:.3e}")
    if failures:
        raise AssertionError("nccl_world1: " + "; ".join(failures))
    return rec


def sass_counts(library) -> dict:
    """Instructions of interest in a built library's SASS, from cuobjdump
    (the toolkit's, beside nvcc): tensor-core products (HMMA float, IMMA
    integer), shared-memory matrix loads (LDSM, .MT88 the transposed ones),
    byte permutes (PRMT), four-way int8 dot products on the CUDA cores
    (IDP, dp4a), asynchronous copies (LDGSTS) and global reductions (REDG;
    F32x4 the vector ones), per kernel function."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    counts = {}
    for function in sass.split("Function : ")[1:]:
        name, body = function.split("\n", 1)
        ops = re.findall(r"\b(HMMA|IMMA|LDSM|PRMT|IDP|LDGSTS|REDG)(\.[A-Za-z0-9_.]+)?", body)
        per = counts.setdefault(name.strip(), {})
        for op, mods in ops:
            per[op + mods] = per.get(op + mods, 0) + 1
    return {"counts": counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from iterative_solver_torch.ops.kernels import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": power,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SOURCES), "built": sorted(logs), "ptxas": ptxas})
    for library in ("symm_packed", "symm_int8"):
        emit({"phase": "sass", "library": library,
              **sass_counts(_build.library_path(library))})
    matrix = bench_matrix(N)
    kernels = check_kernels(matrix, device)
    flagship, flagship_diag, gen_s = make_flagship(device)
    kernels += check_int8_kernels(matrix, flagship, device)
    kernels += check_rr3_kernels(device)
    kernels.append(check_symm_adjoint(matrix, device))
    emit({"phase": "kernel_checks", "kernels": kernels})

    fast = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "fast", "window",
                       2e-4, 1e-3, 1e-5, "symm_bf16")
    precise = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "precise", "full",
                          1e-5, 1e-4, 1e-8, "symm_split")
    exact = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "exact", "full",
                        1e-5, 1e-4, 1e-8, "symm_f32")
    int8 = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "int8", "window",
                       5e-3, *INT8_LIMITS["int8"], "symm_int8")
    int8_precise = solve_phase(matrix, REFERENCE_EIGENVALUES, device, "int8_precise",
                               "anchored", 1e-5, *INT8_LIMITS["int8_precise"],
                               "symm_int8_split", anchor_every=2)
    ppcg = solve_ppcg_flagship(flagship, flagship_diag, gen_s, device)
    ppcg_rr = solve_ppcg_flagship(flagship, flagship_diag, 0.0, device,
                                  tol=FLAGSHIP_RR_TOL, res_limit=FLAGSHIP_RR_RES_LIMIT,
                                  min_iters=FLAGSHIP_RR_EVERY,
                                  phase="solve_ppcg_flagship_full_rr")
    # the flagship's host copy, for the sharded phases at the end
    flagship = dataclasses.replace(flagship, **{
        f: getattr(flagship, f).cpu() for f in ("q", "gq", "ii", "jj", "diagonal")})
    emit(profile_headline(matrix, device))

    pspace = solve_pspace(matrix, device)
    checkpoint = solve_checkpointed(matrix, device)
    solve_batched(device)
    shifted = matrix + LINEAR_SHIFT * np.eye(N)
    b = linear_rhs(N)
    t0 = time.perf_counter()
    x_ref = np.linalg.solve(shifted, b.T).T
    emit({"phase": "linear_reference", "seconds": time.perf_counter() - t0})
    linear = {tier: solve_linear(shifted, b, x_ref, device, tier) for tier in LINEAR_TOLS}
    emit(profile_linear(shifted, b, device))
    lbfgs = solve_lbfgs(shifted, b[0], x_ref[0], device)
    diis = solve_fused_diis(shifted, b[0], device)
    solve_parity_nonlinear(shifted, x_ref[0], device)
    implicit = solve_implicit_diff(matrix, device)
    c_api = solve_c_api(matrix, device)
    # the sharded family phases' inputs, made here once
    family_inputs = {"x_ref": x_ref[0].copy()}
    del shifted, x_ref
    kernels.append(check_chain_raw(N, device))
    refine = refine_precise(matrix, device)
    family_inputs["refine_x0"] = refine.pop("x0")
    nonsym = solve_nonsym_family(device)
    offload_stream(device)
    spill_op = spill_action(matrix, device)
    banded = solve_banded(matrix, device, spill_op)
    cheb = solve_chebyshev(matrix, device, spill_op)
    del matrix, spill_op

    bench_bsr, sparse_dense, bsr_setup_s = make_bench_bsr(device)
    phenol, phenol_diag, phenol_gen_s = phenol_operator(device)
    sparse_kernels = check_sparse_kernels(bench_bsr, phenol, phenol_diag, device)
    emit({"phase": "sparse_kernel_checks", "kernels": sparse_kernels})
    kernels += sparse_kernels
    sparse = solve_sparse_fused(bench_bsr, sparse_dense, bsr_setup_s, device)
    parity = solve_parity(bench_bsr, sparse_dense, device)
    offload_parity = solve_offload_parity(bench_bsr, sparse_dense, device)
    parity_linear = solve_parity_linear(bench_bsr, sparse_dense, device)
    del bench_bsr, sparse_dense
    phenol_rec = solve_phenol(phenol, phenol_diag, phenol_gen_s, device)
    del phenol
    example_launches = run_examples(device)
    # last, as nothing profiled here follows them: the sharded phases (after
    # other processes shared the card, this process's profiler windows
    # dropped device events), then NCCL, whose communicator lives in this
    # process
    unsharded = {rec["tier"]: rec["iterations"]
                 for rec in (fast, precise, exact, int8, int8_precise)}
    unsharded.update(lbfgs=lbfgs["iterations"], diis=diis["iterations"],
                     refine=refine["passes"],
                     nonsym=nonsym["int8_precise_device"]["iterations"],
                     banded=banded["device"]["iterations"],
                     chebyshev=cheb["flat_chebyshev"]["iterations"])
    sharded = run_sharded(device, unsharded, flagship, kernels, family_inputs)
    del flagship
    nccl = nccl_world1(bench_matrix(N), device)

    resumable = list(checkpoint["launches"].values())
    davidson = (fast, precise, exact, int8, int8_precise, sparse, phenol_rec, pspace)
    linear_recs = tuple(linear.values())
    gradients = (lbfgs, diis, implicit, implicit["eigenpairs"])
    # the warm (steady) re-solves of the Chebyshev phase count as solves too
    spill = tuple(banded.values()) + tuple(cheb.values()) + tuple(
        {"launches": r["steady_launches"]} for r in cheb.values())
    offload_parity = tuple(offload_parity.values())
    solves = (davidson + linear_recs + gradients + spill + offload_parity
              + (ppcg, ppcg_rr, parity, parity_linear, refine, c_api))

    def action(*recs):
        return sum(r["launches"]["action"] for r in recs)

    launches = {
        "K1-bf16": action(fast, linear["fast"]) + sum(r["action"] for r in resumable),
        "K1-f32": action(exact, linear["exact"], nccl, c_api, *gradients, *spill),
        "K3": action(precise, pspace, linear["precise"], refine),
        "K2": sum(p["launches"]["chain"] for p in davidson + linear_recs + spill)
        + sum(r["chain"] for r in resumable),
        "K4": action(int8, ppcg, ppcg_rr, linear["int8"]),
        "K5": action(int8_precise, linear["int8_precise"]),
        "K6": action(sparse, parity, phenol_rec, parity_linear, *offload_parity),
        "K7": sum(p["launches"]["gram"] for p in solves) + sum(r["gram"] for r in resumable),
        "K8": sum(p["launches"][key] for p in (ppcg, ppcg_rr) for key in RR3_KEYS),
    }
    off_path = {"K7"}   # no solver calls it, in either package
    if any(launches[k] for k in off_path):
        raise AssertionError(f"a solve launched a kernel off the solver paths: {launches}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = []
    for k in kernels:
        if k["name"] not in launches:
            continue  # a second shape of a kernel already on the line
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0 and k["name"] not in off_path:
            raise AssertionError(f"{k['name']} was not launched on the main path")
        row = {key: k[key] for key in keys}
        # the examples phase's launches, apart from the main path's
        row["example_launches"] = example_launches.get(k["name"], 0)
        if k["name"] in sharded["rank_launches"]:
            # the sharded solves' launches and the kernel's ms on each rank's pairs
            row["rank_launches"] = sharded["rank_launches"][k["name"]]
            row["rank_ms"] = sharded["rank_ms"][k["name"]]
        line.append(row)
    if sorted(k["name"] for k in line) != sorted(launches):
        raise AssertionError(f"the kernels line lists {[k['name'] for k in line]}")
    emit({"phase": "profile_retries", "retries": PROFILE_RETRIES})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        # one rank of the sharded phases (spawn_shards):
        # rank world store out_dir device flagship_n phase...
        a = sys.argv[2:]
        shard_worker(int(a[0]), int(a[1]), a[2], a[3], a[4], a[6:], int(a[5]))
        sys.exit(0)
    sys.exit(main())
