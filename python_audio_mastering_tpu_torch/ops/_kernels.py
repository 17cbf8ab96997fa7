"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  :func:`library`
runs ``nvcc`` on the package's own sources at first use, one compiler
process per source, all started together, then links them into one
library in ``<package>/_build/`` (ignored by git), under a name keyed by
the sources' and flags' hash, so an edited source is never served a stale
library.  Nothing is built or loaded when this module is imported.
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

import torch

__all__ = ["KernelLibrary", "library", "ptr", "raise_on", "upload",
           "wants_grad", "check_kernel_arg", "check_channel_major_arg"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    # x, packed, wt, s_in, y, mono, C, nb, L, S, dry, wet, drive, width,
    # stream
    "pam_front_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                        _F, _P],
    # x, packed, wt, s_in, out, C, nb, L, S, h, stream
    "pam_kweight_cells": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, packed, wt2, s_lp, s_hp, out, C, nb, L, S, h, stream
    "pam_band_energies": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, packed, wt2, s_lp, s_hp, cols, y, mono, C, nb, L, S, h, stream
    "pam_band_gain_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P],
    # m, ca, cr, hmax, lo, hi, stops, ctrl, B, T, stream
    "pam_pass1_hull": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # m, ca, cr, att0, lo, hi, stops, bnd, starts, count, ctrl, B, T, stream
    "pam_pass1_runs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _P],
    # m, ca, cr, incomes, out, B, T, stream
    "pam_replay": [_P, _P, _P, _P, _P, _I, _I, _P],
    # m, ca, cr, att0, idx_ex, s_out, s_new, s_alt, ctrl, B, T, iters,
    # rounds, stream
    "pam_replay_bnd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P],
    # x, sos, nsec, zi, n_valid, y, zf, ysec, F, R, N, kmax, smem, stream
    "pam_sos_scan_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I,
                         _I, _P],
    "pam_sos_scan_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I,
                         _I, _P],
    # x, gain, y, C, T, M, n, threshold, knee, variant, stream
    "pam_gain_limit": [_P, _P, _P, _I, _I, _LL, _LL, _F, _F, _I, _P],
    # x, y, n, C, sn, sc, look, true_peak, ceiling, rho, rho_tile, taps,
    # flags, vals, tiles, stream
    "pam_lookahead_limit": [_P, _P, _LL, _I, _LL, _LL, _I, _I, _F, _D, _D,
                            _P, _P, _P, _I, _P],
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


def _compile_all(nvcc, sources, obj_dir):
    """Compile every source to an object file, all ``nvcc`` processes at
    once; returns the objects and the compilers' output."""
    procs = []
    for src in sources:
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *_NVCC_FLAGS, "-c", "-I", str(_SRC_DIR), "-o", str(obj),
               str(src)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs, logs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return objs, log


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    cu, cuh = _sources()
    so = _BUILD_DIR / f"libpam_kernels_{_digest(cu + cuh)}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        obj_dir = _BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
        obj_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        nvcc = _nvcc_path()
        t0 = time.perf_counter()
        objs, log = _compile_all(nvcc, cu, obj_dir)
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        shutil.rmtree(obj_dir, ignore_errors=True)
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


def upload(values, dtype, device):
    """A small host constant (list or array) as a tensor on ``device``.

    The copy is queued on the current stream without a host
    synchronisation (a plain ``torch.tensor(..., device="cuda")`` waits
    for the stream); the pageable source is staged before the call
    returns, so it may be freed at once."""
    t = torch.as_tensor(values, dtype=dtype)
    return t.to(device, non_blocking=True)


def ptr(t):
    """A tensor's device address for a ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def raise_on(name, err):
    """Raise if a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def wants_grad(*tensors):
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them (None and non-tensors passed over) requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_kernel_arg(kernel):
    """The JAX package's ``kernel`` switch (``"auto"``, ``"pallas"``,
    ``"xla"``, ``"pallas_interpret"``): the port picks its route by the
    tensors' device, so only ``"auto"`` is taken."""
    if kernel != "auto":
        raise ValueError(f"kernel={kernel!r}: the port picks its kernels by "
                         "device (CUDA kernels on the card, their plain "
                         "versions on the CPU); only 'auto' is taken")


def check_channel_major_arg(channel_major):
    """The JAX package's ``channel_major`` flag: its ``(C, N)`` body is on
    the ROADMAP's "Do not port" list, so only ``False`` is taken."""
    if channel_major:
        raise ValueError("channel_major=True: the JAX package's (C, N) "
                         "channel-major body is not ported (ROADMAP, "
                         "'Do not port'); pass (N, C) audio")
