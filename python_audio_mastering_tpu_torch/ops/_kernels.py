"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  :func:`library`
runs ``nvcc`` on the package's own sources at first use, into
``<package>/_build/`` (ignored by git), under a name keyed by the sources'
and flags' hash, so an edited source is never served a stale library.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelLibrary", "library"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, t, wt, s_in, y, mono, C, nb, L, S, mix, drive, width, stream
    "pam_front_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                        _P],
    # x, t, wt, s_in, out, C, nb, L, S, h, stream
    "pam_kweight_cells": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an existing build was loaded
    compiler_log: str        # nvcc/ptxas output (registers, spills)


def _nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``$PATH`` or the default toolkit
    location; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _sources():
    return sorted(_SRC_DIR.glob("*.cu")), sorted(_SRC_DIR.glob("*.cuh"))


def _digest(files):
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    cu, cuh = _sources()
    so = _BUILD_DIR / f"libpam_kernels_{_digest(cu + cuh)}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc_path(), *_NVCC_FLAGS, "-I", str(_SRC_DIR), "-o",
               str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=so, build_seconds=seconds,
                         compiler_log=log)
