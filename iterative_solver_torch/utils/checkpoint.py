"""Solver checkpoint/resume (port of iterative_solver_tpu/utils/checkpoint.py).

The reference persists Q/solution vectors in parallel-HDF5 arrays
(DistrArrayHDF5.h:19-60, HDF5Handle.h); here the whole solver state —
subspace equation matrices, the P/Q/D basis vectors, RHS vectors, solution
data, statistics and solver-specific extras — round-trips through either

- a single compressed ``.npz`` (the default), or
- an **HDF5 file with a named-group layout** (``.h5``/``.hdf5`` paths):

    /                     attrs: format_version, meta (JSON string)
    /subspace/{s,h,rhs,value}          equation matrices
    /qspace/{params,actions}           (nQ, N) stacked Q vectors
    /dspace/{params,actions}           (nD, N) stacked D vectors
    /pspace/dense                      (nP, N) dense P rows
    /rhs/{vectors,norms}               right-hand sides
    /solution/{errors,working_set,solutions,eigenvalues}

Both layouts are the JAX package's, byte for byte: a checkpoint written by
either package loads in the other. Every dataset is a plain f64/i64 array.

``save_fused_state``/``load_fused_state`` take the same two formats for the
fused solvers' states; ``save_vecstore_hdf5``/``load_vecstore_hdf5``
persist a native VecStore's rows as one dataset. ``h5py`` is imported only
by the HDF5 paths, which raise ``ImportError`` where it is absent.

Tensors leave the device through ``.cpu()`` and come back onto the
``device`` the loader is given (``None``: the CUDA device, which raises
without it). A state's host ints (``DavidsonState.k``) are stored as 0-d
int32 arrays, as the JAX package stores its int32 scalars, and load back
as host ints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import config

_SHARDING = "sharding is not ported yet (ROADMAP.md Queue 1, item 6)"

# dataset name in the HDF5 tree for each gathered state key
_H5_LAYOUT = {
    "s": "subspace/s",
    "h": "subspace/h",
    "rhs_mat": "subspace/rhs",
    "value": "subspace/value",
    "q_params": "qspace/params",
    "q_actions": "qspace/actions",
    "d_params": "dspace/params",
    "d_actions": "dspace/actions",
    "p_dense": "pspace/dense",
    "rhs_vectors": "rhs/vectors",
    "rhs_norm": "rhs/norms",
    "errors": "solution/errors",
    "working_set": "solution/working_set",
    "solutions": "solution/solutions",
    "eigenvalues": "solution/eigenvalues",
}


def _is_hdf5_path(path: str) -> bool:
    return str(path).endswith((".h5", ".hdf5"))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _collect_block(store, slots) -> np.ndarray:
    return np.asarray(_host(store.rows(list(slots))), dtype=np.float64)


def _write_hdf5(path: str, meta_json: str, data: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["format_version"] = 1
        f.attrs["meta"] = meta_json
        for key, arr in data.items():
            f.create_dataset(_H5_LAYOUT[key], data=np.asarray(arr))


def _read_hdf5(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        meta = json.loads(f.attrs["meta"])
        arrays = {k: np.asarray(f[ds]) for k, ds in _H5_LAYOUT.items() if ds in f}
    return meta, arrays


def save_checkpoint(solver, path: str) -> None:
    """Persist a parity solver mid-solve; the format follows the extension
    (.h5/.hdf5 -> named-group HDF5, anything else -> compressed npz)."""
    xs = solver.xspace
    data = {
        "s": xs.s,
        "h": xs.h,
        "rhs_mat": xs.rhs,
        "value": xs.value,
        "q_params": _collect_block(xs.store_v, [s[0] for s in xs.q_slots]),
        "q_actions": _collect_block(xs.store_a, [s[1] for s in xs.q_slots]),
        "d_params": _collect_block(xs.store_v, [s[0] for s in xs.d_slots]),
        "d_actions": _collect_block(xs.store_a, [s[1] for s in xs.d_slots]),
        "rhs_vectors": _collect_block(xs.store_v, xs.rhs_slots),
        "rhs_norm": np.asarray(xs.rhs_norm, dtype=np.float64),
        "p_dense": _collect_block(xs.store_v, xs.p_slots),
        "errors": np.asarray(solver.errors, dtype=np.float64),
        "working_set": np.asarray(solver.working_set, dtype=np.int64),
        "solutions": _host(getattr(solver.subspace_solver, "solutions", np.zeros((0, 0)))),
    }
    try:
        data["eigenvalues"] = np.asarray(solver.subspace_solver.eigenvalues, dtype=np.float64)
    except Exception:
        data["eigenvalues"] = np.zeros(0)

    meta = {
        "solver_class": type(solver).__name__,
        "n": solver.n,
        "nroots": solver.nroots,
        "convergence_threshold": solver.convergence_threshold,
        "max_iter": solver.max_iter,
        "hermitian": xs.hermitian,
        "action_dot_action": xs.action_dot_action,
        "p_sparse": [
            {str(k): float(v) for k, v in p.items()} for p in xs.p_sparse
        ],
        "stats": {k: int(v) for k, v in vars(solver.stats).items()},
        "extras": {},
    }
    # solver-family extras needed for a faithful resumption
    if hasattr(solver, "_last_values"):
        meta["extras"]["last_values"] = list(map(float, solver._last_values))
    if hasattr(solver, "rspt_values"):
        meta["extras"]["rspt_values"] = list(map(float, solver.rspt_values))
    if hasattr(solver, "_alphas"):
        meta["extras"]["alphas"] = list(map(float, np.asarray(solver._alphas)))
    if hasattr(solver, "max_size_qspace"):
        meta["extras"]["max_size_qspace"] = int(solver.max_size_qspace)

    if _is_hdf5_path(path):
        _write_hdf5(path, json.dumps(meta), data)
    else:
        np.savez_compressed(path, meta=json.dumps(meta), **data)


def load_checkpoint(path: str, sharding=None, dtype=None, device=None):
    """Rebuild a parity solver from a checkpoint; returns the restored
    solver, on ``device``. A checkpoint of a class that is not a parity
    solver raises ``ValueError``."""
    from ..array import vector_ops as vops
    from ..solvers.linear_eigensystem import LinearEigensystemDavidson, LinearEigensystemRSPT
    from ..solvers.linear_equations import LinearEquationsDavidson
    from ..solvers.nonlinear_diis import NonLinearEquationsDIIS
    from ..solvers.optimize import OptimizeBFGS, OptimizeSD

    if sharding is not None:
        raise NotImplementedError(_SHARDING)
    registry = {
        cls.__name__: cls
        for cls in (LinearEigensystemDavidson, LinearEigensystemRSPT, LinearEquationsDavidson,
                    NonLinearEquationsDIIS, OptimizeBFGS, OptimizeSD)
    }
    if _is_hdf5_path(path):
        meta, arrays = _read_hdf5(path)
    else:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            arrays = {k: z[k] for k in z.files if k != "meta"}

    cls = registry.get(meta["solver_class"])
    if cls is None:
        raise ValueError(f"checkpoint of a {meta['solver_class']}, which is not a "
                         f"parity solver of this package")
    solver = cls(meta["n"], meta["nroots"], dtype=dtype, device=device)
    solver.convergence_threshold = meta["convergence_threshold"]
    solver.max_iter = meta["max_iter"]
    xs = solver.xspace
    xs.hermitian = meta["hermitian"]
    xs.action_dot_action = meta["action_dot_action"]
    if hasattr(solver.subspace_solver, "hermitian"):
        solver.subspace_solver.hermitian = meta["hermitian"]
    if "max_size_qspace" in meta["extras"] and hasattr(solver, "max_size_qspace"):
        solver.max_size_qspace = meta["extras"]["max_size_qspace"]

    def dev(row):
        return vops.to_device(row, xs.dtype, xs.device)

    # restore basis vectors in logical order
    for row in arrays["p_dense"]:
        xs.p_slots.append(xs.store_v.append(dev(row)))
    xs.p_sparse = [
        {int(k): float(v) for k, v in p.items()} for p in meta["p_sparse"]
    ]
    for vec in arrays["rhs_vectors"]:
        xs.rhs_slots.append(xs.store_v.append(dev(vec)))
    xs.rhs_norm = list(arrays["rhs_norm"])
    for qp, qa in zip(arrays["q_params"], arrays["q_actions"]):
        xs.q_slots.append((xs.store_v.append(dev(qp)), xs.store_a.append(dev(qa)),
                           next(xs._unique_id)))
    for dp, da in zip(arrays["d_params"], arrays["d_actions"]):
        xs.d_slots.append((xs.store_v.append(dev(dp)), xs.store_a.append(dev(da))))
    xs.s = arrays["s"]
    xs.h = arrays["h"]
    xs.rhs = arrays["rhs_mat"]
    xs.value = arrays["value"]

    solver.errors = list(arrays["errors"])
    solver.working_set = [int(i) for i in arrays["working_set"]]
    solver.subspace_solver.solutions = arrays["solutions"]
    if arrays["eigenvalues"].size and hasattr(solver.subspace_solver, "eigenvalues"):
        try:
            solver.subspace_solver.eigenvalues = arrays["eigenvalues"]
        except AttributeError:
            pass
    solver.subspace_solver.errors = list(arrays["errors"])
    for k, v in meta["stats"].items():
        setattr(solver.stats, k, v)
    if "last_values" in meta["extras"] and hasattr(solver, "_last_values"):
        solver._last_values = meta["extras"]["last_values"]
    if "rspt_values" in meta["extras"] and hasattr(solver, "rspt_values"):
        solver.rspt_values = meta["extras"]["rspt_values"]
    if "alphas" in meta["extras"] and hasattr(solver, "_alphas"):
        solver._alphas = np.asarray(meta["extras"]["alphas"])
    return solver


# ---------------------------------------------------------------------------
# fused-solver states (solvers/fused_davidson.DavidsonState and the others)


def _field_array(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (int, np.integer)):
        return np.asarray(value, dtype=np.int32)
    return np.asarray(value)


def save_fused_state(state, path: str, **meta) -> None:
    """Persist a fused solver's state (a flat NamedTuple of tensors and
    host ints; optional fields may be None). Extra keyword metadata
    (tolerances, iteration counts, ...) round-trips through the json
    header."""
    present = [(name, value) for name, value in zip(state._fields, state)
               if value is not None]
    data = {name: _field_array(value) for name, value in present}
    header = {"fields": [n for n, _ in present], "meta": dict(meta)}

    def _jsonable(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().tolist()
        raise TypeError(f"unserialisable checkpoint metadata: {type(v)}")

    if _is_hdf5_path(path):
        import h5py

        with h5py.File(path, "w") as f:
            f.attrs["format_version"] = 1
            f.attrs["meta"] = json.dumps(header, default=_jsonable)
            for name, arr in data.items():
                f.create_dataset(f"state/{name}", data=arr)
        return
    np.savez_compressed(path, meta=json.dumps(header, default=_jsonable), **data)


def load_named_state(path: str, cls, sharding=None, dtype=None, device=None):
    """Rebuild any flat NamedTuple state saved by ``save_fused_state``.
    0-d integer fields load as host ints (the port's slot and iteration
    counters), other integer fields as int tensors, float fields as
    ``dtype`` (default: as stored) on ``device``. Missing optional fields
    restore as None. Returns ``(state, meta)``."""
    if sharding is not None:
        raise NotImplementedError(_SHARDING)
    device = config.resolve_device(device)
    if _is_hdf5_path(path):
        import h5py

        with h5py.File(path, "r") as f:
            header = json.loads(f.attrs["meta"])
            arrays = {k: np.asarray(f[f"state/{k}"]) for k in header["fields"]}
    else:
        if not path.endswith(".npz") and not os.path.exists(path):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["meta"]))
            arrays = {k: z[k] for k in header["fields"]}

    def restore(arr):
        if np.issubdtype(arr.dtype, np.integer):
            return int(arr) if arr.ndim == 0 else torch.as_tensor(arr, device=device)
        return torch.as_tensor(arr, dtype=dtype, device=device)

    fields = {name: restore(arr) for name, arr in arrays.items()}
    for missing in set(cls._fields) - set(fields):
        fields[missing] = None
    return cls(**fields), header["meta"]


def load_fused_state(path: str, sharding=None, dtype=None, device=None):
    """Rebuild a DavidsonState (+ the saved metadata dict) from disk: the
    DavidsonState case of ``load_named_state``."""
    from ..solvers.fused_davidson import DavidsonState

    return load_named_state(path, DavidsonState, sharding=sharding, dtype=dtype,
                            device=device)


# ---------------------------------------------------------------------------
# VecStore rows as an HDF5 dataset (the DistrArrayHDF5-as-Qvector analogue,
# DistrArrayHDF5.h:19-60): a store's live rows land in one (nrows, N)
# dataset plus the slot index that maps rows back to store slots.


def save_vecstore_hdf5(store, path: str, group: str = "vecstore",
                       slots=None) -> None:
    """Dump a VecStore's (or BasisStore's) rows to ``<group>/rows`` with
    the originating slot ids in ``<group>/slots``."""
    import h5py

    if slots is None:
        valid = getattr(store, "_valid", None)
        slots = sorted(valid) if valid is not None else list(range(store.capacity))
    rows = np.stack([np.asarray(_host(store.get(s)), dtype=np.float64) for s in slots]) \
        if slots else np.zeros((0, getattr(store, "n", getattr(store, "row_len", 0))))
    with h5py.File(path, "a") as f:
        if group in f:
            del f[group]
        g = f.create_group(group)
        g.create_dataset("rows", data=rows)
        g.create_dataset("slots", data=np.asarray(slots, dtype=np.int64))


def load_vecstore_hdf5(path: str, group: str = "vecstore"):
    """Return ``(rows, slots)`` from a store dump."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f[group]
        return np.asarray(g["rows"]), [int(s) for s in np.asarray(g["slots"])]
