"""Build and load the port's CUDA C++ kernels at first use.

Each source ``csrc/<name>.cu`` becomes a shared library of its own with a
plain C interface (no PyTorch headers, so a build takes seconds), compiled
for Hopper by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/torch_kernels/lib<name>-<hash>.so

and loaded with ``ctypes``. The file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. ``build`` starts one ``nvcc`` for each missing library, all at once.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``check`` raises on a nonzero code, so a
refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("symm_packed", "chain", "symm_int8", "spmv", "gram", "rr3")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of iterative_solver_torch "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process each, all started together. Returns the compiler's output
    (``-Xptxas=-v`` register and shared-memory report) per built name.
    Raises with the compiler's output if any build fails."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    logs, failures = {}, []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the C entry points take it
    (the raw handle, without building a ``torch.cuda.Stream``)."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))
