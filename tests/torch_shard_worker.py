"""Worker processes of the port's sharded tests (tests/test_torch_distribution.py,
_sharded_symm, _sharded_bsr, _sharded_solvers).

Each test file spawns its ranks once (``run_workers``): every rank is a
separate Python process that imports torch and the port only (never JAX),
joins a gloo group through a ``file://`` store in the test's temporary
directory (no port to collide on under xdist), runs the named cases on the
CPU in float64 (``CARD_CASES`` on the card in float32) and writes each
case's arrays to ``<out>/<case>_r<rank>.npz``.
The test process then compares them with the JAX package's sharded results
on the same seed-made inputs (the functions below that make them use numpy
only, so both sides share them).

Usage: python torch_shard_worker.py <rank> <world> <store file> <out dir> <case>...
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- inputs shared with the JAX side (numpy only) -----------------------------

def dense_problem(n, seed=0):
    """test_sharded_symm.py's operator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.1 / np.sqrt(n))
    return a + a.T + np.diag(np.linspace(1.0, 20.0, n))


def davidson_matrix(n, seed=0):
    """test_fused_davidson.py's operator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.01
    return a + a.T + np.diag(np.linspace(1.0, 10.0, n))


def multihost_matrix(n=512):
    """multihost_worker.py's operator."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    return a + a.T + np.diag(np.linspace(0.0, 10.0, n))


def ppcg_matrix(n, seed=0):
    """test_fused_ppcg.py's _easy operator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    nlow = max(4, n // 32)
    dvals = np.concatenate([np.linspace(-2.0, 3.0, nlow), np.linspace(6.0, 50.0, n - nlow)])
    return a + a.T + np.diag(dvals)


def spd_matrix(n, seed=0, scale=0.1):
    """test_fused_cg.py's _spd operator."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (scale / np.sqrt(n))
    return a + a.T + np.diag(np.linspace(1.0, 9.0, n))


def unit_guess(diag, nroots):
    v0 = np.zeros((nroots, len(diag)))
    for row, i in enumerate(np.argsort(diag)[:nroots]):
        v0[row, i] = 1.0
    return v0


# -- spawning ---------------------------------------------------------------

def run_workers(out_dir, world: int, cases, timeout: float = 240.0) -> None:
    """Run ``cases`` on ``world`` gloo ranks; raise with every rank's output
    if a rank fails or runs past ``timeout`` seconds."""
    out_dir = str(out_dir)
    store = os.path.join(out_dir, f"store_w{world}")
    from torch_testing import child_env  # here, so that the ranks import no pytest

    env = child_env(PYTHONPATH=ROOT, SHARD_OUT=out_dir)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(world), store, out_dir,
         *cases], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    report = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{(o or '')[-3000:]}"
                       for r, (p, o) in enumerate(zip(procs, outs + [""] * world)))
    if len(outs) < world or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"sharded workers failed:\n{report}")


def load(out_dir, case: str, rank: int) -> dict:
    with np.load(os.path.join(str(out_dir), f"{case}_r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


# -- the cases (run inside the workers) ------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def distr_array(mesh):
    from iterative_solver_torch.array.distr_array import DistrArray

    def make(n, data=None):
        return DistrArray(n, mesh=mesh, data=data)

    out = {}
    a = make(24)
    a.fill(2.0)
    out["fill"] = a.gather_all()
    a.put(3, np.arange(4.0))
    out["put"] = a.get(3, 7)
    a.acc(3, np.ones(4))
    out["acc"] = a.get(3, 7)
    b = make(16, np.arange(16.0))
    out["gather"] = b.gather([1, 5, 9])
    b.scatter([0, 2], [10.0, 20.0])
    out["scatter"] = np.array([b.at(0), b.at(2)])
    b.scatter_acc([0], [1.0])
    out["scatter_acc"] = np.array([b.at(0)])
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(32), rng.standard_normal(32)
    c, d = make(32, x), make(32, y)
    c.axpy(0.5, d)
    out["axpy"] = c.gather_all()
    c.scal(2.0)
    out["scal"] = c.gather_all()
    d.times(c)
    out["times"] = d.gather_all()
    e, f, g = make(8, np.arange(1.0, 9.0)), make(8, np.full(8, 2.0)), make(8)
    g.divide(e, f, shift=1.0)
    out["divide"] = g.gather_all()
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(40), rng.standard_normal(40)
    h, k = make(40, x), make(40, y)
    out["dot"] = np.array([h.dot(k), h.norm()])
    data = np.array([3.0, -7.0, 1.0, 5.0, -2.0, 0.5])
    s = make(6, data)
    out["max_n"] = np.array([i for i, _ in s.max_n(2)])
    out["min_n"] = np.array([i for i, _ in s.min_n(2)])
    out["max_abs_n"] = np.array([i for i, _ in s.max_abs_n(1)])
    out["min_loc_n"] = np.array(s.min_loc_n(1))
    out["select"] = np.array(sorted(s.select(2, max_select=False)))
    p, q = make(4, np.array([1.0, 2.0, 0.1, 3.0])), make(4, np.array([1.0, 1.0, 100.0, 0.1]))
    out["select_max_dot"] = np.array(sorted(p.select_max_dot(2, q)))
    u = make(20, np.arange(20.0))
    out["local_buffers"] = np.concatenate([u.local_buffer(r) for r in range(mesh.size)])
    out["own_buffer"] = u.local_buffer()
    out["size"] = np.array([u.distribution().size])
    # padding stays zero through fill, recip and divide
    v = make(6, np.arange(1.0, 7.0))
    v.fill(3.0)
    v.recip()
    out["recip"] = v.gather_all()
    out["pad"] = v.data[v.count:].numpy()
    return out


@case
def collectives(mesh):
    import torch

    from iterative_solver_torch.parallel import block_sharding, collectives as coll

    sh = block_sharding(mesh)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((3, 64)), rng.standard_normal((5, 64))
    coeff = rng.standard_normal((2, 5))
    xd, yd = sh.shard(x), sh.shard(y)
    gram = coll.sharded_gram(mesh)(xd, yd)
    rec = sh.gather(coll.sharded_reconstruct(mesh)(torch.as_tensor(coeff), yd), 64)
    dots = coll.sharded_dot(mesh)(xd, xd)
    # uneven chunks: n = 10 over the mesh, gathered back whole
    z = rng.standard_normal((2, 10))
    zg = sh.gather(sh.shard(z), 10)
    # reduce-scatter and all-reduce(max)
    part = torch.as_tensor(rng.standard_normal((2, 8 * mesh.size)) * (mesh.rank + 1))
    rs = coll.reduce_scatter(part, mesh, dim=1)
    mx = coll.all_reduce(torch.as_tensor([float(mesh.rank), -float(mesh.rank)]), mesh, "max")
    return {"gram": gram.numpy(), "rec": rec.numpy(), "dots": dots.numpy(),
            "uneven": zg.numpy(), "rs": rs.numpy(), "max": mx.numpy(),
            "range": np.array(sh.local_range(10))}


def _sym_case(mesh, tier):
    import torch

    from iterative_solver_torch.ops.kernels.symm import SymmetricBlocked, SymmetricBlockedSplit
    from iterative_solver_torch.ops.kernels.symm_int8 import (
        SymmetricBlockedInt8,
        SymmetricBlockedInt8Split,
    )
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric

    n, b = 256, 32
    mat = dense_problem(n, seed={"f64": 0, "split": 5, "int8": 10, "int8_split": 10}[tier])
    if tier == "f64":
        s = ShardedSymmetric.from_symmetric(
            SymmetricBlocked.from_dense(mat, b=b, dtype=torch.float64, device="cpu"), mesh)
        x = np.random.default_rng(1).standard_normal((3, n))
    elif tier == "split":
        s = ShardedSymmetric.from_split(SymmetricBlockedSplit.from_dense(mat, b=b, device="cpu"),
                                        mesh)
        x = np.random.default_rng(6).standard_normal((3, n)).astype(np.float32)
    else:
        cls = SymmetricBlockedInt8Split if tier == "int8_split" else SymmetricBlockedInt8
        s = ShardedSymmetric.from_int8(cls.from_dense(mat, b=b, device="cpu"), mesh)
        x = np.random.default_rng(11).standard_normal((3, n)).astype(np.float32)
    matvec, op = s.matvec_fn()
    sh = block_sharding(mesh)
    y = matvec(sh.shard(x), op)
    # the rank's own partial sum, before the reduce-scatter
    partial = s.partial(torch.as_tensor(x), op)
    loc = s.local
    # the rank's tile planes: values / hi / q / q1, then lo / q2
    planes = [getattr(loc, f) for f in loc.OPERAND if f not in ("gq", "diagonal", "ii", "jj")]
    out = {"y": sh.gather(y, n).to(torch.float64).numpy(),
           "partial": partial.to(torch.float64).numpy(),
           "ii": loc.ii.numpy(), "jj": loc.jj.numpy(), "max_p": np.array([s.pairs_per_dev]),
           "diagonal": s.diagonal.to(torch.float64).numpy()}
    for key, plane in zip(("values", "lo"), planes):
        out[key] = plane.numpy() if s.quantized else plane.to(torch.float32).numpy()
    if s.quantized:
        out["gq"] = loc.gq.numpy()
    else:
        # K1/K3's walk lists, built with the shard from the rank's own pairs
        out["work"], out["sums"] = loc.work.numpy(), loc.sums.numpy()
    return out


@case
def symm_f64(mesh):
    return _sym_case(mesh, "f64")


@case
def symm_split(mesh):
    return _sym_case(mesh, "split")


@case
def symm_int8(mesh):
    return _sym_case(mesh, "int8")


@case
def symm_int8_split(mesh):
    return _sym_case(mesh, "int8_split")


@case
def symm_int8_diag_once(mesh):
    import torch

    from iterative_solver_torch.ops.kernels.symm_int8 import SymmetricBlockedInt8
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric

    n, b = 128, 16
    d = np.linspace(-2.0, 30.0, n)
    s = ShardedSymmetric.from_int8(SymmetricBlockedInt8.from_dense(np.diag(d), b=b,
                                                                   device="cpu"), mesh)
    matvec, op = s.matvec_fn()
    sh = block_sharding(mesh)
    x = np.random.default_rng(12).standard_normal((2, n)).astype(np.float32)
    y = matvec(sh.shard(x), op)
    return {"y": sh.gather(y, n).to(torch.float64).numpy(), "width": np.array(y.shape)}


@case
def symm_refusals(mesh):
    from iterative_solver_torch.ops.kernels.symm import SymmetricBlocked
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric

    sym = SymmetricBlocked.from_dense(dense_problem(102), b=34, device="cpu")
    try:
        ShardedSymmetric.from_symmetric(sym, mesh)
    except ValueError as err:
        return {"raised": np.array([1]), "msg": np.array(str(err))}
    return {"raised": np.array([0])}


def _davidson_result(solver, v0, on_device=False):
    run = solver.run_on_device if on_device else solver.run
    evals, x, errors, iters = run(v0)
    return {"evals": np.asarray(evals), "errors": np.asarray(errors),
            "iters": np.array([int(iters)]), "x": x.double().numpy(),
            "matvecs": np.array([solver.matvecs])}


@case
def symm_davidson(mesh):
    """test_sharded_symm.py::test_sharded_fused_davidson_converges."""
    import torch

    from iterative_solver_torch.ops.kernels.symm import SymmetricBlocked
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, b, nroots = 256, 32, 3
    mat = dense_problem(n, seed=4)
    s = ShardedSymmetric.from_symmetric(
        SymmetricBlocked.from_dense(mat, b=b, dtype=torch.float64, device="cpu"), mesh)
    matvec, op = s.matvec_fn()
    solver = FusedDavidson(matvec, np.diag(mat), n, nroots, m_max=6 * nroots,
                           sharding=block_sharding(mesh), convergence_threshold=1e-9,
                           max_iter=200, operand=op)
    return _davidson_result(solver, unit_guess(np.diag(mat), nroots))


@case
def symm_int8_davidson(mesh):
    """test_sharded_symm.py::test_sharded_int8_fused_davidson_converges."""
    import torch

    from iterative_solver_torch.ops.kernels.symm_int8 import SymmetricBlockedInt8Split
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, b, nroots = 256, 32, 3
    mat = dense_problem(n, seed=13)
    s = ShardedSymmetric.from_int8(SymmetricBlockedInt8Split.from_dense(mat, b=b,
                                                                        device="cpu"), mesh)
    matvec, op = s.matvec_fn()
    solver = FusedDavidson(matvec, np.diag(mat), n, nroots, m_max=24, dtype=torch.float32,
                           convergence_threshold=1e-4, max_iter=200, operand=op,
                           sharding=block_sharding(mesh))
    return _davidson_result(solver, unit_guess(np.diag(mat), nroots), on_device=True)


@case
def symm_from_dense_tiers(mesh):
    """FusedDavidson.from_dense_symmetric(sharding=) in every tier against
    the unsharded solver on the same rank."""
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, nroots = 256, 3
    mat = dense_problem(n, seed=7)
    v0 = unit_guess(np.diag(mat), nroots)
    out = {}
    for tier, tol in (("exact", 1e-9), ("fast", 1e-2), ("precise", 1e-4), ("int8", 1e-2),
                      ("int8_precise", 1e-4)):
        kw = dict(tier=tier, b=32, m_max=18, convergence_threshold=tol, device="cpu")
        sharded = FusedDavidson.from_dense_symmetric(mat, nroots,
                                                     sharding=block_sharding(mesh), **kw)
        single = FusedDavidson.from_dense_symmetric(mat, nroots, **kw)
        for tag, solver in (("sharded", sharded), ("single", single)):
            res = _davidson_result(solver, v0, on_device=True)
            out[f"{tier}_{tag}_evals"] = res["evals"]
            out[f"{tier}_{tag}_iters"] = res["iters"]
            out[f"{tier}_{tag}_errors"] = res["errors"]
    return out


@case
def bsr_arrays(mesh):
    import torch

    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_bsr import ShardedBSR

    out = {}
    for tag, n, block, seed in (("even", 512, 16, 1), ("uneven", 336, 16, 2)):
        bsr, _ = synthetic_fci_bsr(n, block=block, seed=seed, dtype=torch.float64,
                                   device="cpu")
        s = ShardedBSR.from_bsr(bsr, mesh)
        matvec, op = s.matvec_fn()
        rng = np.random.default_rng(0 if tag == "even" else 1)
        x = np.zeros((4 if tag == "even" else 2, s.n))
        x[:, :n] = rng.standard_normal((x.shape[0], n))
        sh = block_sharding(mesh)
        y = matvec(sh.shard(x), op)
        out[f"{tag}_y"] = sh.gather(y, s.n).numpy()
        for f in ("loc_values", "loc_col", "loc_row", "rem_values", "rem_col", "rem_row",
                  "diagonal"):
            out[f"{tag}_{f}"] = getattr(s, f).numpy()
        out[f"{tag}_n"] = np.array([s.n, s.rb_per_dev])
    return out


@case
def bsr_int8(mesh):
    import torch

    from iterative_solver_torch.ops.kernels.spmv import BSRMatrix, BSRMatrixInt8
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_bsr import ShardedBSRInt8

    mat = multihost_matrix(512)
    bsr = BSRMatrix.from_dense(mat, bm=16, bn=16, tol=0.0, dtype=torch.float64, device="cpu")
    q = BSRMatrixInt8.from_bsr(bsr)
    s = ShardedBSRInt8.from_int8(q, mesh)
    matvec, op = s.matvec_fn()
    sh = block_sharding(mesh)
    x = np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32)
    y = matvec(sh.shard(x), op)
    acc, sx = s.accumulate(sh.shard(x), op)
    out = {"y": sh.gather(y, 512).to(torch.float64).numpy(),
           "acc": sh.gather(acc, 512).numpy(), "sx": sx.numpy()}
    for f in ("loc_q", "loc_col", "loc_row", "rem_q", "rem_col", "rem_row", "rq", "cq",
              "diagonal"):
        out[f] = getattr(s, f).numpy()
    return out


@case
def bsr_davidson(mesh):
    """test_sharded_bsr.py::test_distributed_sparse_davidson."""
    import torch

    from iterative_solver_torch.models.synthetic_fci import synthetic_fci_bsr
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.parallel.sharded_bsr import ShardedBSR
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, nroots = 1024, 4
    bsr, _ = synthetic_fci_bsr(n, block=32, seed=3, dtype=torch.float64, device="cpu")
    s = ShardedBSR.from_bsr(bsr, mesh)
    matvec, op = s.matvec_fn()
    sh = block_sharding(mesh)
    diag = sh.gather(s.diagonal, s.n).numpy()
    solver = FusedDavidson(matvec, diag, s.n, nroots, m_max=24, sharding=sh, operand=op,
                           max_iter=100)
    return _davidson_result(solver, unit_guess(diag[:n], nroots), on_device=True)


@case
def dense_davidson(mesh):
    """test_fused_davidson.py::test_fused_sharded_matches_single_device, with
    the row-sharded dense matvec."""
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, nroots = 128, 2
    mat = davidson_matrix(n, seed=3)
    rows = matrix_row_sharding(mesh).shard(mat)
    solver = FusedDavidson(row_sharded_matvec(mesh), np.diag(mat), n, nroots, m_max=16,
                           sharding=block_sharding(mesh), operand=rows)
    return _davidson_result(solver, unit_guess(np.diag(mat), nroots))


@case
def dense_davidson_rr(mesh):
    """The window RR, P space and a chunked solve under sharding against the
    same solve on one rank."""
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson

    n, nroots = 128, 3
    mat = davidson_matrix(n, seed=5)
    rows = matrix_row_sharding(mesh).shard(mat)
    v0 = unit_guess(np.diag(mat), nroots)
    p_idx = np.argsort(np.diag(mat))[nroots:nroots + 4]
    out = {}
    for tag, kw in (("window3", dict(rr="window3")),
                    ("pspace", dict(p_space=[{int(i): 1.0} for i in p_idx],
                                    p_actions=mat[p_idx])),
                    ("anchored", dict(rr="anchored"))):
        for where in ("sharded", "single"):
            if where == "sharded":
                solver = FusedDavidson(row_sharded_matvec(mesh), np.diag(mat), n, nroots,
                                       m_max=18, sharding=block_sharding(mesh),
                                       operand=rows, convergence_threshold=1e-9, **kw)
            else:
                import torch

                solver = FusedDavidson(lambda x, op: x @ op.T, np.diag(mat), n, nroots,
                                       m_max=18, operand=torch.as_tensor(mat),
                                       convergence_threshold=1e-9, device="cpu", **kw)
            res = _davidson_result(solver, v0, on_device=True)
            out[f"{tag}_{where}_evals"] = res["evals"]
            out[f"{tag}_{where}_iters"] = res["iters"]
    return out


@case
def ppcg(mesh):
    """test_fused_ppcg.py::test_sharded_solve_matches_single_device."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_ppcg import FusedPPCG

    n, r = 256, 4
    mat = ppcg_matrix(n, seed=10)
    v0 = unit_guess(np.diag(mat), r)
    rows = matrix_row_sharding(mesh).shard(mat)
    sharded = FusedPPCG(row_sharded_matvec(mesh), np.diag(mat), n, r, rr_every=5,
                        convergence_threshold=1e-10, max_iter=300, operand=rows,
                        sharding=block_sharding(mesh))
    single = FusedPPCG(lambda x, op: x @ op.T, np.diag(mat), n, r, rr_every=5,
                       convergence_threshold=1e-10, max_iter=300,
                       operand=torch.as_tensor(mat), device="cpu")
    out = {}
    for tag, solver in (("sharded", sharded), ("single", single)):
        evals, x, errors, iters = solver.run(v0)
        out[f"{tag}_evals"], out[f"{tag}_errors"] = evals, errors
        out[f"{tag}_iters"], out[f"{tag}_x"] = np.array([iters]), x.numpy()
    return out


@case
def ppcg_card(mesh):
    """test_torch_ppcg_rr3.py's sharded card solve: ``ppcg``'s problem in
    float32 on the card, K8 on every rank, beside the one-card eager chain."""
    import torch

    from iterative_solver_torch.ops.kernels import rr3
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_ppcg import FusedPPCG

    n, r = 256, 4
    mat = ppcg_matrix(n, seed=10)
    v0 = unit_guess(np.diag(mat), r)
    rows = matrix_row_sharding(mesh).shard(mat, torch.float32)
    sharded = FusedPPCG(row_sharded_matvec(mesh), np.diag(mat), n, r, rr_every=5,
                        convergence_threshold=1e-4, max_iter=300, operand=rows,
                        sharding=block_sharding(mesh))
    before = dict(rr3.LAUNCHES)
    evals, _, _, iters = sharded.run(v0)
    out = {"sharded_evals": evals, "sharded_iters": np.array([iters]),
           "launches": np.array([rr3.LAUNCHES[k] - before[k] for k in ("rr3_dots", "rr3_update")])}
    auto = rr3.rr3_auto
    rr3.rr3_auto = lambda device, dtype: False
    try:
        single = FusedPPCG(lambda x, op: x @ op.T, np.diag(mat), n, r, rr_every=5,
                           convergence_threshold=1e-4, max_iter=300,
                           operand=torch.as_tensor(mat, dtype=torch.float32, device=mesh.device),
                           device=mesh.device)
        evals, _, _, iters = single.run(v0)
    finally:
        rr3.rr3_auto = auto
    out["eager_evals"], out["eager_iters"] = evals, np.array([iters])
    return out


# the cases that run on the card (the others on the CPU)
CARD_CASES = {"ppcg_card"}


@case
def multihost(mesh):
    """multihost_worker.py's phases over the ranks: the dense row-sharded
    solve, the packed sharded action and the int8 sharded BSR action."""
    import torch

    from iterative_solver_torch.ops.kernels.spmv import BSRMatrix, BSRMatrixInt8, bsr_matmat_int8
    from iterative_solver_torch.ops.kernels.symm import SymmetricBlocked
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.parallel.sharded_bsr import ShardedBSRInt8
    from iterative_solver_torch.parallel.sharded_symm import ShardedSymmetric
    from iterative_solver_torch.solvers.fused_davidson import (
        make_davidson_init,
        make_davidson_solve,
    )

    n, nroots, m_max = 512, 4, 16
    mat = multihost_matrix(n)
    sh = block_sharding(mesh)
    rows = matrix_row_sharding(mesh).shard(mat)
    diag = sh.shard(np.diag(mat))
    matvec = row_sharded_matvec(mesh)
    v0 = sh.shard(unit_guess(np.diag(mat), nroots))
    init = make_davidson_init(matvec, nroots, m_max, sharding=sh)
    solve = make_davidson_solve(matvec, nroots, m_max, sharding=sh)
    final, iters = solve(init(v0, rows), rows, diag, 1e-10, 200)
    ssym = ShardedSymmetric.from_symmetric(
        SymmetricBlocked.from_dense(mat, b=32, dtype=torch.float64, device="cpu"), mesh)
    smv, sop = ssym.matvec_fn()
    x = np.random.default_rng(1).standard_normal((3, n))
    y = sh.gather(smv(sh.shard(x), sop), n).numpy()
    bsr_q = BSRMatrixInt8.from_bsr(BSRMatrix.from_dense(mat, bm=16, bn=16, tol=0.0,
                                                        dtype=torch.float64, device="cpu"))
    qmv, qop = ShardedBSRInt8.from_int8(bsr_q, mesh).matvec_fn()
    xq = x.astype(np.float32)
    yq = sh.gather(qmv(sh.shard(xq), qop), n).to(torch.float64).numpy()
    yq_ref = bsr_matmat_int8(torch.as_tensor(xq), bsr_q).to(torch.float64).numpy()
    return {"iters": np.array([iters]), "evals": final.evals.numpy(),
            "errors": final.errors.numpy(), "packed_err": np.array([np.abs(y - x @ mat).max()]),
            "int8_err": np.array([np.abs(yq - yq_ref).max()]),
            "int8_scale": np.array([max(np.abs(yq_ref).max(), 1.0)])}


@case
def fused_cg(mesh):
    """test_fused_cg.py::test_sharded_matches_single_device."""
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_cg import FusedBlockCG

    n, nrhs = 256, 2
    mat = spd_matrix(n, seed=9)
    b = np.random.default_rng(10).standard_normal((nrhs, n))
    solver = FusedBlockCG(row_sharded_matvec(mesh), np.diag(mat), n, nrhs,
                          convergence_threshold=1e-11, sharding=block_sharding(mesh),
                          operand=matrix_row_sharding(mesh).shard(mat))
    x, errors, iters = solver.solve(b)
    return {"x": x.numpy(), "errors": errors, "iters": np.array([iters])}


@case
def fused_linear(mesh):
    """FusedLinearEquations under sharding: the packed exact tier and the
    row-sharded dense action with a P space."""
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_linear import FusedLinearEquations

    n, nrhs = 256, 2
    mat = spd_matrix(n, seed=9)
    b = np.random.default_rng(10).standard_normal((nrhs, n))
    sh = block_sharding(mesh)
    packed = FusedLinearEquations.from_dense_symmetric(
        mat, nrhs, tier="exact", b=32, m_max=12, convergence_threshold=1e-10, sharding=sh)
    p_idx = [3, 17, 40]
    dense = FusedLinearEquations(row_sharded_matvec(mesh), np.diag(mat), n, nrhs, m_max=14,
                                 convergence_threshold=1e-10, sharding=sh,
                                 operand=matrix_row_sharding(mesh).shard(mat),
                                 p_space=[{i: 1.0} for i in p_idx], p_actions=mat[p_idx])
    out = {}
    for tag, solver in (("packed", packed), ("pspace", dense)):
        x, errors, iters = solver.solve(b)
        out[f"{tag}_x"], out[f"{tag}_errors"] = x.numpy(), errors
        out[f"{tag}_iters"] = np.array([iters])
    return out


@case
def checkpoint(mesh):
    """A sharded run_fast that checkpoints, resumed by a sharded solver; a
    sharded parity checkpoint saved and loaded. Rank 0's files are read
    by the JAX package in the test process."""
    import os as _os

    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_davidson import FusedDavidson
    from iterative_solver_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    out_dir = _os.environ["SHARD_OUT"]
    n, nroots = 128, 2
    mat = davidson_matrix(n, seed=6)
    sh = block_sharding(mesh)
    rows = matrix_row_sharding(mesh).shard(mat)
    v0 = unit_guess(np.diag(mat), nroots)

    def solver(max_iter):
        return FusedDavidson(row_sharded_matvec(mesh), np.diag(mat), n, nroots, m_max=8,
                             sharding=sh, operand=rows, max_iter=max_iter,
                             convergence_threshold=1e-9)

    path = _os.path.join(out_dir, "fused_ck.npz")
    first = solver(6)
    first.run_fast(v0, checkpoint_path=path)
    resumed = solver(200)
    evals, x, errors, _ = resumed.resume_fast(path, keep_checkpointing=False)
    whole = solver(200)
    w_evals, _, _, _ = whole.run_fast(v0)
    # the parity eigensolver, checkpointed after two iterations
    ppath = _os.path.join(out_dir, "parity_ck.npz")
    problem = its.models.MatrixProblem(mat, sharding=matrix_row_sharding(mesh))
    eig = its.create_linear_eigensystem(n, nroots, "Davidson", sharding=sh)
    eig.set_hermiticity(True)
    eig.verbosity = its.Verbosity.NONE
    eig.solve(np.zeros((nroots, n)), problem=problem, generate_initial_guess=True, max_iter=2)
    save_checkpoint(eig, ppath)
    back = load_checkpoint(ppath, sharding=sh)
    return {"evals": evals, "errors": errors, "iters": np.array([resumed.iterations]),
            "whole_evals": w_evals, "whole_iters": np.array([whole.iterations]),
            "parity_s": back.xspace.s, "parity_q": back.xspace.store_v.rows(
                [s_[0] for s_ in back.xspace.q_slots]).numpy(),
            "parity_width": np.array([back.xspace.width])}


STAT_FIELDS = ("iterations", "r_creations", "q_creations", "q_deletions", "d_creations",
               "gemm_inner_ops", "gemm_outer_ops")


def _stats(solver):
    return np.array([getattr(solver.stats, f) for f in STAT_FIELDS])


@case
def parity_eigen(mesh):
    """test_fused_davidson.py::test_parity_solver_with_sharded_blocks."""
    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding

    n = 64
    mat = davidson_matrix(n, seed=4)
    problem = its.models.MatrixProblem(mat, sharding=matrix_row_sharding(mesh))
    solver = its.create_linear_eigensystem(n, 2, "Davidson", sharding=block_sharding(mesh))
    solver.set_hermiticity(True)
    solver.verbosity = its.Verbosity.NONE
    conv, x, r = solver.solve(np.zeros((2, n)), problem=problem, generate_initial_guess=True)
    return {"conv": np.array([bool(conv)]), "evals": np.asarray(solver.eigenvalues()),
            "errors": np.asarray(solver.errors), "stats": _stats(solver),
            "x_width": np.array(x.shape)}


@case
def parity_lineq(mesh):
    """The parity linear equations with sharded stores and a P space
    (max_p), against the JAX package's unsharded solve."""
    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding

    n = 64
    mat = spd_matrix(n, seed=8)
    b = np.random.default_rng(9).standard_normal((2, n))
    problem = its.models.MatrixProblem(mat, sharding=matrix_row_sharding(mesh))
    solver = its.create_linear_equations(n, 2, "Davidson", "max_p=4",
                                         sharding=block_sharding(mesh))
    solver.add_equations(b)
    solver.verbosity = its.Verbosity.NONE
    conv, x, r = solver.solve(np.zeros((2, n)), problem=problem, generate_initial_guess=True)
    sol = block_sharding(mesh).gather(solver.solution_params([0, 1]), n)
    return {"conv": np.array([bool(conv)]), "x": sol.numpy(),
            "errors": np.asarray(solver.errors), "stats": _stats(solver)}


# -- the remaining families under sharding (tests/test_torch_sharded_families.py)

def spd_hessian(n, seed=0):
    """test_fused_families.py's make_spd."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    return a + a.T + np.diag(np.linspace(3.0, 30.0, n))


def quad_operand(n, seed=1):
    """test_fused_diis.py's _quad_operand (eps 0.05)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * 0.1
    mat = a + a.T + np.diag(np.arange(2.0, n + 2.0))
    return mat, rng.standard_normal(n)


def nonsym_op(n, strength=0.15, seed=0):
    """test_dense_int8.py's make_op."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.05 / np.sqrt(n))
    m = a + a.T + np.diag(np.linspace(1.0, 20.0, n))
    m[np.tril_indices(n, -1)] *= 1.0 - strength
    return m


def banded_matrix(n, nlow=16, seed=0):
    """test_banded.py's make_matrix."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (0.02 / np.sqrt(n))
    d = np.concatenate([np.linspace(-3.0, 0.0, nlow), np.linspace(2.0, 20.0, n - nlow)])
    return a + a.T + np.diag(d)


def optimize_hessian(n, rho=0.1):
    """test_optimize.py's make_hessian."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return np.where(i == j, i + 1.0, rho * (1.0 / (1.0 + abs(i - j))))


def rspt_matrix(n, lam=0.05):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((n, n)) * 0.2
    return np.diag(np.arange(1.0, n + 1.0)) + lam * (v + v.T)


def refine_start(mat, nroots, seed=2, noise=1e-4):
    """The lowest eigenvectors of ``mat``, perturbed: a device-converged
    start for the refiner."""
    _, vecs = np.linalg.eigh(mat)
    rng = np.random.default_rng(seed)
    return vecs[:, :nroots].T + noise * rng.standard_normal((nroots, mat.shape[0]))


def _cpu_matvec(x, op):
    return x @ op.T


@case
def family_lbfgs(mesh):
    """FusedLBFGS on 0.5 (x-b)ᵀH(x-b): sharded (the GLOBAL f, the rank's
    slice of g) and unsharded on the rank."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import psum
    from iterative_solver_torch.solvers.fused_lbfgs import FusedLBFGS

    n = 64
    hess = spd_hessian(n, seed=4)
    b = np.linspace(0.5, 1.5, n)
    sh = block_sharding(mesh)
    b_loc = sh.shard(b)

    def vg_sharded(x, rows):
        d = x - b_loc
        g = rows @ sh.gather(d, n)
        return 0.5 * psum(torch.dot(d, g), sh), g

    def vg_single(x, h):
        d = x - torch.as_tensor(b)
        g = h @ d
        return 0.5 * torch.dot(d, g), g

    out = {}
    for tag, solver in (
            ("sharded", FusedLBFGS(vg_sharded, n, operand=matrix_row_sharding(mesh).shard(hess),
                                   sharding=sh, convergence_threshold=1e-6)),
            ("single", FusedLBFGS(vg_single, n, operand=torch.as_tensor(hess),
                                  convergence_threshold=1e-6, device="cpu"))):
        x, f, gnorm, iters = solver.run(np.zeros(n))
        out.update({f"{tag}_x": x.numpy(), f"{tag}_f": np.array([f]),
                    f"{tag}_gnorm": np.array([gnorm]), f"{tag}_iters": np.array([iters])})
    return out


@case
def family_diis(mesh):
    """test_fused_diis.py::test_sharded_matches_single_device with the
    rank's rows of the matrix."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.solvers.fused_diis import FusedDIIS

    n = 256
    mat, b = quad_operand(n, seed=11)
    sh = block_sharding(mesh)

    def residual_sharded(x, op):
        rows, b_loc = op
        return rows @ sh.gather(x, n) + 0.05 * x**2 - b_loc

    def residual_single(x, op):
        m, bb = op
        return m @ x + 0.05 * x**2 - bb

    out = {}
    for tag, solver in (
            ("sharded", FusedDIIS(residual_sharded, n, diagonals=np.diag(mat), sharding=sh,
                                  operand=(matrix_row_sharding(mesh).shard(mat), sh.shard(b)),
                                  convergence_threshold=1e-10)),
            ("single", FusedDIIS(residual_single, n, diagonals=np.diag(mat), device="cpu",
                                 operand=(torch.as_tensor(mat), torch.as_tensor(b)),
                                 convergence_threshold=1e-10))):
        x, err, iters = solver.run(np.zeros(n))
        out.update({f"{tag}_x": x.numpy(), f"{tag}_err": np.array([err]),
                    f"{tag}_iters": np.array([iters])})
    return out


@case
def family_refine(mesh):
    """EigenpairRefiner over a sharded SplitOperator (precise_matvec_fn:
    x gathered once, the rank's rows)."""
    from iterative_solver_torch.ops.precise import (
        SplitOperator,
        precise_matmat,
        precise_matvec_fn,
    )
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers.refine import EigenpairRefiner

    n, nroots = 128, 3
    mat = davidson_matrix(n, seed=8)
    op = SplitOperator.from_dense(mat, n_chunks=8, sharding=block_sharding(mesh))
    ref = EigenpairRefiner(lambda x: x @ mat.T, precise_matvec_fn(op), op.operand(),
                           np.diag(mat), n, nroots, sharding=block_sharding(mesh))
    res = ref.refine(refine_start(mat, nroots), tol=1e-11)
    xs = np.random.default_rng(3).standard_normal((2, n))
    y = block_sharding(mesh).gather(precise_matmat(block_sharding(mesh).shard(xs), op), n)
    return {"evals": res.eigenvalues, "resn": res.residual_norms,
            "passes": np.array([res.passes]), "converged": np.array([res.converged]),
            "history": np.array(res.history), "cg": np.array(ref.cg_iterations),
            "x": res.x, "hi_rows": np.array(op.hi.shape), "y": y.numpy()}


def _nonsym_result(tag, evals, x, errors, iters):
    return {f"{tag}_evals_re": np.real(evals), f"{tag}_evals_im": np.imag(evals),
            f"{tag}_x": x.double().numpy(), f"{tag}_errors": np.asarray(errors),
            f"{tag}_iters": np.array([iters])}


@case
def family_nonsym_int8(mesh):
    """test_dense_int8.py::test_sharded_int8_device_rr_solve: the two-plane
    tier row-sharded by DenseInt8Split.shard, the device-RR solve in
    float32, against the unsharded tree on the rank; the sharded action
    against the unsharded one, bit for bit."""
    import torch

    from iterative_solver_torch.ops.kernels.dense_int8 import (
        DenseInt8,
        DenseInt8Split,
        dense_int8_matvec,
        dense_int8_matvec_split,
        sharded_matvec,
        sharded_matvec_split,
    )
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers.fused_nonsym import FusedNonSymDavidson

    m = nonsym_op(512, seed=9)
    n, r = m.shape[0], 3
    sh = block_sharding(mesh)
    v0 = unit_guess(np.diag(m), r)
    op = DenseInt8Split.from_dense(m, device="cpu")
    out = {}
    for tag, mv, operand, kw in (
            ("sharded", sharded_matvec_split(mesh), op.shard(mesh), dict(sharding=sh)),
            ("single", dense_int8_matvec_split, op.tree(), dict(device="cpu"))):
        sol = FusedNonSymDavidson(mv, np.diag(m), n, r, m_max=12, operand=operand,
                                  convergence_threshold=5e-5, max_iter=100, rr="device",
                                  dtype=torch.float32, **kw)
        out.update(_nonsym_result(tag, *sol.solve(v0)))
    x = np.random.default_rng(4).standard_normal((3, n)).astype(np.float32)
    one = DenseInt8.from_dense(m, device="cpu")
    for tag, q, single, sharded in (("one", one, dense_int8_matvec, sharded_matvec),
                                    ("two", op, dense_int8_matvec_split, sharded_matvec_split)):
        out[f"{tag}_y"] = sh.gather(sharded(mesh)(sh.shard(x), q.shard(mesh)), n).numpy()
        out[f"{tag}_y_single"] = single(torch.as_tensor(x), q.tree()).numpy()
    return out


@case
def family_nonsym(mesh):
    """FusedNonSymDavidson (host and device RR) and FusedNonSymLinearEquations
    (host and device) in float64 on a row-sharded dense operator, and a
    sharded device-tier checkpoint resumed by a sharded solver."""
    import os as _os

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.fused_nonsym import (
        FusedNonSymDavidson,
        FusedNonSymLinearEquations,
    )

    m = nonsym_op(128, seed=3)
    n, r = m.shape[0], 3
    sh = block_sharding(mesh)
    rows = matrix_row_sharding(mesh).shard(m)
    mv = row_sharded_matvec(mesh)
    v0 = unit_guess(np.diag(m), r)
    b = np.random.default_rng(5).standard_normal((2, n))
    out = {}
    for rr in ("host", "device"):
        sol = FusedNonSymDavidson(mv, np.diag(m), n, r, m_max=16, operand=rows, sharding=sh,
                                  convergence_threshold=1e-9, rr=rr)
        out.update(_nonsym_result(f"eig_{rr}", *sol.solve(v0)))
        lin = FusedNonSymLinearEquations(mv, np.diag(m), n, 2, m_max=12, operand=rows,
                                         sharding=sh, convergence_threshold=1e-9, rr=rr)
        x, errors, iters = lin.solve(b)
        out.update({f"lin_{rr}_x": x.numpy(), f"lin_{rr}_errors": np.asarray(errors),
                    f"lin_{rr}_iters": np.array([iters])})
    path = _os.path.join(_os.environ["SHARD_OUT"], "nonsym_ck.npz")
    first = FusedNonSymDavidson(mv, np.diag(m), n, r, m_max=16, operand=rows, sharding=sh,
                                convergence_threshold=1e-9, rr="device", chunk_iters=3,
                                max_iter=3)
    first.solve(v0, checkpoint_path=path)
    resumed = FusedNonSymDavidson(mv, np.diag(m), n, r, m_max=16, operand=rows, sharding=sh,
                                  convergence_threshold=1e-9, rr="device", chunk_iters=3)
    out.update(_nonsym_result("resumed", *resumed.resume(path, keep_checkpointing=False)))
    return out


def _slice_problem(its, sh, n, value_grad, diag):
    """A parity Problem written per slice: residual takes the rank's slice
    and returns the GLOBAL value with the rank's slice of the gradient."""

    class SliceProblem(its.Problem):
        def __init__(self):
            super().__init__()
            self.dimension = n

        def residual(self, parameters):
            return value_grad(parameters)

        def diagonals(self):
            return diag

    return SliceProblem()


def _parity_run(solver, problem, n):
    import torch

    solver.verbosity = 0
    conv, x, _ = solver.solve(np.zeros((1, n)), problem=problem)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return conv, x


@case
def family_parity(mesh):
    """RSPT, OptimizeBFGS, OptimizeSD and NonLinearEquationsDIIS under
    sharding (tests/test_torch_linear_eigensystem.py::test_rspt,
    _optimize.py::test_quadratic_matches_jax, _nonlinear_diis.py's
    quadratic), the problems written per slice."""
    import torch

    import iterative_solver_torch as its
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import psum

    sh = block_sharding(mesh)
    rowsh = matrix_row_sharding(mesh)
    out = {}
    # RSPT
    n = 16
    h = rspt_matrix(n)
    rspt = its.create_linear_eigensystem(n, 1, "RSPT", "convergence_threshold=1e-12,max_iter=40",
                                         sharding=sh)
    rspt.verbosity = 0
    conv, _, _ = rspt.solve(np.zeros((1, n)), problem=its.models.MatrixProblem(h, sharding=rowsh),
                            generate_initial_guess=True)
    out.update(rspt_conv=np.array([bool(conv)]), rspt_values=np.array(rspt.rspt_values),
               rspt_stats=_stats(rspt))
    # the optimisers
    n = 32
    for method in ("BFGS", "SD"):
        hess = optimize_hessian(n, 0.1 if method == "BFGS" else 0.01)
        b = np.linspace(0.5, 1.5, n)
        rows, b_loc = rowsh.shard(hess), sh.shard(b)

        def value_grad(x, rows=rows, b_loc=b_loc):
            d = x - b_loc
            g = rows @ sh.gather(d, n)
            return float(0.5 * psum(torch.dot(d, g), sh)), g

        opt = its.create_optimize(n, method, "max_size_qspace=8" if method == "BFGS" else "",
                                  sharding=sh)
        opt.convergence_threshold = 1e-10
        opt.max_iter = 300
        conv, x = _parity_run(opt, _slice_problem(its, sh, n, value_grad,
                                                  np.diag(hess).copy()), n)
        out.update({f"{method}_conv": np.array([bool(conv)]), f"{method}_stats": _stats(opt),
                    f"{method}_ls": np.array([opt.stats.line_searches,
                                              opt.stats.line_search_steps]),
                    f"{method}_x": sh.gather(x, n).numpy(), f"{method}_value": np.array([opt.value])})
    # DIIS on r = A x + eps x^2 - b
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n)) * 0.1
    mat = a + a.T + np.diag(np.arange(2.0, n + 2.0))
    b = rng.standard_normal(n)
    rows, b_loc = rowsh.shard(mat), sh.shard(b)

    def residual(x):
        return 0.0, rows @ sh.gather(x, n) + 0.05 * x**2 - b_loc

    diis = its.create_nonlinear_equations(n, "DIIS", sharding=sh)
    diis.convergence_threshold = 1e-8
    conv, x = _parity_run(diis, _slice_problem(its, sh, n, residual, np.diag(mat).copy()), n)
    out.update(diis_conv=np.array([bool(conv)]), diis_stats=_stats(diis),
               diis_x=sh.gather(x, n).numpy(), diis_nq=np.array([diis.xspace.dimensions.nQ]))
    return out


@case
def family_banded(mesh):
    """BandedEigensolver in both deflation modes on a row-sharded dense
    matvec, against the unsharded solver on the rank."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.banded import BandedEigensolver

    n = 128
    m = banded_matrix(n, nlow=12, seed=3)
    sh = block_sharding(mesh)
    out = {}
    for mode in ("device", "streamed"):
        for tag, kw in (("sharded", dict(matvec=row_sharded_matvec(mesh), sharding=sh,
                                         operand=matrix_row_sharding(mesh).shard(m))),
                        ("single", dict(matvec=_cpu_matvec, operand=torch.as_tensor(m),
                                        device="cpu"))):
            solver = BandedEigensolver(diagonals=np.diag(m), n=n, band=4, m_max=16,
                                       convergence_threshold=1e-9, deflate=mode,
                                       store_block_rows=3, **kw)
            vals, vecs, errs = solver.solve(8)
            out.update({f"{mode}_{tag}_vals": vals, f"{mode}_{tag}_errs": errs,
                        f"{mode}_{tag}_vecs": vecs, f"{mode}_{tag}_runs": np.array(solver.runs)})
    return out


@case
def family_chebyshev(mesh):
    """test_chebyshev.py::test_chebyshev_sharded_mesh, and the Lanczos
    bounds sharded against unsharded on the rank."""
    import torch

    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding
    from iterative_solver_torch.parallel.collectives import row_sharded_matvec
    from iterative_solver_torch.solvers.chebyshev import (
        estimate_spectral_bounds,
        make_chebyshev_davidson,
    )

    n = 128
    rng = np.random.default_rng(6)
    a = rng.standard_normal((n, n)) * 0.01
    m = a + a.T + np.diag(np.linspace(1.0, 10.0, n))
    sh = block_sharding(mesh)
    rows = matrix_row_sharding(mesh).shard(m)
    solver = make_chebyshev_davidson(row_sharded_matvec(mesh), np.diag(m), n, nroots=2,
                                     degree=3, m_max=14, operand=rows, sharding=sh)
    out = _davidson_result(solver, unit_guess(np.diag(m), 2))
    out["bounds"] = np.array(estimate_spectral_bounds(row_sharded_matvec(mesh), n, rows,
                                                      sharding=sh))
    out["bounds_single"] = np.array(estimate_spectral_bounds(_cpu_matvec, n, torch.as_tensor(m),
                                                             device="cpu"))
    return out


@case
def family_offload(mesh):
    """The parity Davidson through sharded offload stores (host f64 and
    streamed, small blocks), and the stores' block numerics against an
    unsharded store on the rank."""
    import torch

    import iterative_solver_torch as its
    from iterative_solver_torch.array.offload_store import OffloadBasisStore, StreamedOffloadStore
    from iterative_solver_torch.parallel import block_sharding, matrix_row_sharding

    n = 64
    m = davidson_matrix(n, seed=4)
    sh = block_sharding(mesh)
    out = {}
    for tag, offload in (
            ("host", True),
            ("streamed", lambda capacity, nn, dtype, sharding, name="params", device=None:
             StreamedOffloadStore(capacity, nn, dtype=dtype, sharding=sharding, name=name,
                                  block_rows=3, device=device))):
        solver = its.LinearEigensystemDavidson(n, 2, sharding=sh, offload=offload)
        solver.set_hermiticity(True)
        solver.verbosity = 0
        conv, _, _ = solver.solve(np.zeros((2, n)),
                                  problem=its.models.MatrixProblem(m, sharding=matrix_row_sharding(mesh)),
                                  generate_initial_guess=True)
        out.update({f"{tag}_conv": np.array([bool(conv)]),
                    f"{tag}_evals": np.asarray(solver.eigenvalues()),
                    f"{tag}_errors": np.asarray(solver.errors), f"{tag}_stats": _stats(solver)})
    rng = np.random.default_rng(7)
    rows = np.linalg.qr(rng.standard_normal((n, 5)))[0].T
    x = rng.standard_normal((2, n))
    coeff = rng.standard_normal((2, 5))
    for tag, cls in (("hoststore", OffloadBasisStore), ("streamstore", StreamedOffloadStore)):
        kw = dict(block_rows=2) if cls is StreamedOffloadStore else {}
        for where, store in (("sharded", cls(4, n, sharding=sh, **kw)),
                             ("single", cls(4, n, device="cpu", **kw))):
            # the sharded store takes and returns the rank's slices
            local = sh.shard if where == "sharded" else torch.as_tensor
            part = (lambda t: sh.gather(t, n)) if where == "sharded" else (lambda t: t)
            slots = [store.append(local(row)) for row in rows]
            out[f"{tag}_{where}_gram_block"] = store.gram_block(local(x))
            out[f"{tag}_{where}_mgs"] = part(store.mgs_sweep(local(x), slots,
                                                             np.ones(5))).numpy()
            out[f"{tag}_{where}_combine"] = part(store.combine(coeff, slots)).numpy()
            out[f"{tag}_{where}_rows"] = part(store.rows(slots[:2])).numpy()
            store.close()
    return out


@case
def family_vector_ops(mesh):
    """select_max_dot (uneven chunks included), fused_dot and the parity
    optimiser's two-loop dots under sharding against the same calls on the
    whole vectors."""
    import torch

    from iterative_solver_torch.array import vector_ops as vops
    from iterative_solver_torch.parallel import block_sharding
    from iterative_solver_torch.solvers.optimize import _bfgs_backward, _bfgs_forward

    sh = block_sharding(mesh)
    out = {}
    for n in (32, 30):
        rng = np.random.default_rng(n)
        x, y = rng.standard_normal(n), rng.standard_normal(n)
        y[3] = x[3] = 2.0   # a tie of two products, at indices 3 and 17
        x[17], y[17] = 4.0, 1.0
        idx, vals = vops.select_max_dot(sh.shard(x), sh.shard(y), 5, sharding=sh)
        out[f"smd{n}_idx"], out[f"smd{n}_vals"] = idx.numpy(), vals.numpy()
    n = 32
    rng = np.random.default_rng(9)
    x, ys = rng.standard_normal(n), rng.standard_normal((4, n))
    out["fused_dot"] = vops.fused_dot(sh.shard(x), sh.shard(ys), sharding=sh).numpy()
    out["fused_dot_single"] = vops.fused_dot(torch.as_tensor(x), torch.as_tensor(ys)).numpy()
    q, u = rng.standard_normal((4, n)), rng.standard_normal((4, n))
    r = rng.standard_normal(n)
    denom = torch.as_tensor(rng.uniform(1.0, 2.0, 3))
    rs, al = _bfgs_forward(sh.shard(r), sh.shard(q), sh.shard(u), denom, sh)
    r1, al1 = _bfgs_forward(torch.as_tensor(r), torch.as_tensor(q), torch.as_tensor(u), denom)
    zs = _bfgs_backward(sh.shard(r), sh.shard(q), sh.shard(u), denom, al, sh)
    z1 = _bfgs_backward(torch.as_tensor(r), torch.as_tensor(q), torch.as_tensor(u), denom, al1)
    out.update(fwd=sh.gather(rs, n).numpy(), fwd_single=r1.numpy(), alphas=al.numpy(),
               alphas_single=al1.numpy(), bwd=sh.gather(zs, n).numpy(), bwd_single=z1.numpy())
    return out


def main() -> None:
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from iterative_solver_torch.parallel import init_process_group

    device = "cuda:0" if CARD_CASES & set(sys.argv[5:]) else "cpu"
    mesh = init_process_group(f"file://{store}", world, rank, backend="gloo", device=device)
    try:
        for name in sys.argv[5:]:
            result = CASES[name](mesh)
            np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **result)
            print(f"rank {rank}: {name} done", flush=True)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
