"""ctypes wrapper of the native vector store (port of
iterative_solver_tpu/native/vecstore.py).

The port cannot import the JAX package's wrapper: importing any module of
``iterative_solver_tpu`` runs its ``__init__``, which imports JAX. So it
keeps this copy over the same repo-root source, ``native/vecstore.cpp``
(the file-backed row store with a two-buffer prefetch pipeline, the
reference's DistrArrayFile/BufferManager analogue), built with g++ at
first use into ``build/torch_native/`` and named by a hash of the source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "vecstore.cpp"
_BUILD_DIR = _ROOT / "build" / "torch_native"


def build_native() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"libvecstore-{digest}.so"
    if not so_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
               "-pthread", str(_SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True)
        tmp.replace(so_path)
    return so_path


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    i64 = ctypes.c_int64
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.vecstore_create.restype = ctypes.c_void_p
    lib.vecstore_create.argtypes = [i64, i64, ctypes.c_char_p]
    lib.vecstore_destroy.argtypes = [ctypes.c_void_p]
    lib.vecstore_capacity.restype = i64
    lib.vecstore_capacity.argtypes = [ctypes.c_void_p]
    lib.vecstore_row_len.restype = i64
    lib.vecstore_row_len.argtypes = [ctypes.c_void_p]
    lib.vecstore_put.restype = ctypes.c_int
    lib.vecstore_put.argtypes = [ctypes.c_void_p, i64, dp]
    lib.vecstore_get.restype = ctypes.c_int
    lib.vecstore_get.argtypes = [ctypes.c_void_p, i64, dp]
    lib.vecstore_gemm_inner.restype = ctypes.c_int
    lib.vecstore_gemm_inner.argtypes = [ctypes.c_void_p, dp, i64, ip, i64, dp]
    lib.vecstore_gemm_outer.restype = ctypes.c_int
    lib.vecstore_gemm_outer.argtypes = [ctypes.c_void_p, dp, i64, ip, i64, dp]
    lib.vecstore_axpy.restype = ctypes.c_int
    lib.vecstore_axpy.argtypes = [ctypes.c_void_p, i64, ctypes.c_double, dp]
    lib.vecstore_scal.restype = ctypes.c_int
    lib.vecstore_scal.argtypes = [ctypes.c_void_p, i64, ctypes.c_double]
    lib.vecstore_dot.restype = ctypes.c_double
    lib.vecstore_dot.argtypes = [ctypes.c_void_p, i64, i64, ctypes.POINTER(ctypes.c_int)]
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class VecStore:
    """Host/disk tier for basis-vector histories: rows of float64 in a file,
    with the block numerics streamed through the native double-buffered
    pipeline. Without ``path`` the file is an anonymous one in
    ``tempfile.gettempdir()`` (``TMPDIR``), unlinked as soon as it is open,
    so it goes when the store closes."""

    def __init__(self, capacity: int, row_len: int, path: Optional[str] = None):
        self._lib = _load()
        scratch = None
        if not path:
            fd, scratch = tempfile.mkstemp(prefix="vecstore-")
            os.close(fd)
        try:
            self._h = self._lib.vecstore_create(capacity, row_len,
                                                (path or scratch).encode())
        finally:
            if scratch is not None:
                os.unlink(scratch)   # the store's open descriptor keeps the file
        if not self._h:
            raise OSError("vecstore_create failed")
        self.capacity = capacity
        self.row_len = row_len
        self._free = list(range(capacity - 1, -1, -1))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.vecstore_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    # -- slot management (parity with BasisStore) -----------------------
    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("VecStore full")
        return self._free.pop()

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def append(self, vec) -> int:
        slot = self.alloc()
        self.put(slot, vec)
        return slot

    # -- IO --------------------------------------------------------------
    def put(self, slot: int, vec) -> None:
        arr = np.ascontiguousarray(np.asarray(vec, dtype=np.float64))
        if arr.size != self.row_len:
            raise ValueError(f"row of {arr.size} values, the store holds {self.row_len}")
        rc = self._lib.vecstore_put(self._h, slot, _dptr(arr))
        if rc != 0:
            raise OSError(f"vecstore_put failed rc={rc}")

    def get(self, slot: int) -> np.ndarray:
        out = np.empty(self.row_len, dtype=np.float64)
        self.get_into(slot, out)
        return out

    def get_into(self, slot: int, out: np.ndarray) -> None:
        """Read one row straight into ``out``, a C-contiguous float64 array of
        ``row_len`` values (a row of a pinned staging buffer, say): no row is
        allocated or copied again. The read releases the GIL (ctypes), so it
        overlaps the calling process's other threads."""
        if (out.dtype != np.float64 or out.size != self.row_len
                or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(f"get_into needs a writable C-contiguous float64 row of "
                             f"{self.row_len} values, got {out.dtype} {out.shape}")
        rc = self._lib.vecstore_get(self._h, slot, _dptr(out))
        if rc != 0:
            raise OSError(f"vecstore_get failed rc={rc}")

    # -- streamed block numerics ----------------------------------------
    def _slots(self, slots: Sequence[int]):
        arr = np.ascontiguousarray(np.asarray(slots, dtype=np.int64))
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def gram(self, x, slots: Sequence[int]) -> np.ndarray:
        """(m, n) x rows(slots)^T -> (m, k), streamed with prefetch."""
        x = np.ascontiguousarray(np.atleast_2d(np.asarray(x, dtype=np.float64)))
        out = np.zeros((x.shape[0], len(slots)), dtype=np.float64)
        if not len(slots):
            return out
        keep, ptr = self._slots(slots)
        rc = self._lib.vecstore_gemm_inner(self._h, _dptr(x), x.shape[0], ptr, keep.size,
                                           _dptr(out))
        if rc != 0:
            raise OSError(f"vecstore_gemm_inner failed rc={rc}")
        return out

    def combine(self, coeff, slots: Sequence[int]) -> np.ndarray:
        """coeff (m, k) @ rows(slots) -> (m, n), streamed with prefetch."""
        coeff = np.ascontiguousarray(np.atleast_2d(np.asarray(coeff, dtype=np.float64)))
        out = np.zeros((coeff.shape[0], self.row_len), dtype=np.float64)
        if not len(slots):
            return out
        keep, ptr = self._slots(slots)
        rc = self._lib.vecstore_gemm_outer(self._h, _dptr(coeff), coeff.shape[0], ptr,
                                           keep.size, _dptr(out))
        if rc != 0:
            raise OSError(f"vecstore_gemm_outer failed rc={rc}")
        return out

    def axpy(self, slot: int, alpha: float, vec) -> None:
        arr = np.ascontiguousarray(np.asarray(vec, dtype=np.float64))
        rc = self._lib.vecstore_axpy(self._h, slot, float(alpha), _dptr(arr))
        if rc != 0:
            raise OSError(f"vecstore_axpy failed rc={rc}")

    def scale(self, slot: int, alpha: float) -> None:
        rc = self._lib.vecstore_scal(self._h, slot, float(alpha))
        if rc != 0:
            raise OSError(f"vecstore_scal failed rc={rc}")

    def dot(self, slot_a: int, slot_b: int) -> float:
        status = ctypes.c_int(0)
        val = self._lib.vecstore_dot(self._h, slot_a, slot_b, ctypes.byref(status))
        if status.value != 0:
            raise OSError("vecstore_dot failed")
        return float(val)
