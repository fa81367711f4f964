"""Worker processes of the port's sharded tests (tests/test_torch_distribution.py,
_sharded_symm, _sharded_bsr, _sharded_solvers).

Each test file spawns its ranks once (``run_workers``): every rank is a
separate Python process that imports torch and the port only (never JAX),
joins a gloo group through a ``file://`` store in the test's temporary
directory (no port to collide on under xdist), runs the named cases on the
CPU in float64 and writes each case's arrays to ``<out>/<case>_r<rank>.npz``.
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
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, SHARD_OUT=out_dir)
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


def main() -> None:
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from iterative_solver_torch.parallel import init_process_group

    mesh = init_process_group(f"file://{store}", world, rank, backend="gloo", device="cpu")
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
