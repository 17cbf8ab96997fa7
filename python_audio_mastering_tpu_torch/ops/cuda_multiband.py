"""The port's hand-written kernels and their plain PyTorch versions.

Counterpart of ``python_audio_mastering_tpu.ops.pallas_multiband`` for the
two kernels on the no-multiband chain:

* :func:`front_chain` (CUDA ``csrc/front_chain.cu``) — saturate → EQ from
  per-block states → stereo width, plus the mono downmix;
* :func:`kweight_cells` (CUDA ``csrc/kweight_cells.cu``) — K-weighting from
  per-block states → square → ``h``-bucket sums.

Each wrapper takes its plain version (``*_ref``) for a tensor on the CPU,
and launches its kernel for a CUDA tensor or raises: there is no fallback
on the card.  Each counts its kernel launches in ``<wrapper>.launches``
(only where it launches the kernel); :func:`reset_launch_counts` and
:func:`launch_counts` read and clear them.
"""

from __future__ import annotations

import ctypes

import torch

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    saturate,
    saturation_coefs,
)

__all__ = ["front_chain", "front_chain_ref", "kweight_cells",
           "kweight_cells_ref", "launch_counts", "reset_launch_counts"]

# the template instantiations and tile height of csrc/blocked_iir.cuh
_KERNEL_BLOCK_SIZES = (128, 256, 384, 512)
_KERNEL_MAX_CHANNELS = 32


def front_chain_ref(xrows, s_in_eq, t_eq, w_eq, saturation_percent, width,
                    emit_mono: bool = False):
    """Plain version of :func:`front_chain` (same algebra)."""
    c, nb, L = xrows.shape
    xs = saturate(xrows, saturation_percent).reshape(c * nb, L)
    y = xs @ t_eq + s_in_eq.reshape(c * nb, -1) @ w_eq.T
    y = stereo_width(y.reshape(c, nb, L), width, channel_axis=0)
    if emit_mono:
        return y, y.mean(dim=0)
    return y


def kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop):
    """Plain version of :func:`kweight_cells` (same algebra)."""
    c, nb, L = xrows.shape
    if L % hop != 0:
        raise ValueError(f"hop {hop} must divide block size {L}")
    kx = xrows.reshape(c * nb, L) @ t_kw + s_in.reshape(c * nb, -1) @ w_kw.T
    return (kx * kx).reshape(c, nb, L // hop, hop).sum(dim=-1).reshape(
        c, nb * (L // hop))


def _check_operands(name, xrows, s_in, t, w):
    """Validate what the CUDA kernels take; returns ``(C, nb, L, S)``."""
    if xrows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xrows.device}")
    if xrows.ndim != 3 or s_in.ndim != 3:
        raise ValueError(f"{name}: rows must be (C, nb, L) and states "
                         f"(C, nb, S)")
    c, nb, L = xrows.shape
    s = s_in.shape[2]
    if L not in _KERNEL_BLOCK_SIZES or not 1 <= c <= _KERNEL_MAX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes L in "
                         f"{_KERNEL_BLOCK_SIZES} and 1..."
                         f"{_KERNEL_MAX_CHANNELS} channels, got L={L}, C={c}")
    want = {"rows": ((c, nb, L), xrows), "states": ((c, nb, s), s_in),
            "T": ((L, L), t), "W": ((L, s), w)}
    for what, (shape, ten) in want.items():
        if tuple(ten.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(ten.shape)}, "
                             f"expected {shape}")
        if ten.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {ten.dtype}")
        if ten.device != xrows.device:
            raise ValueError(f"{name}: {what} is on {ten.device}, rows on "
                             f"{xrows.device}")
    for what, ten in (("rows", xrows), ("states", s_in)):
        if not ten.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return c, nb, L, s


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def front_chain(xrows, s_in_eq, t_eq, w_eq, saturation_percent, width,
                emit_mono: bool = False):
    """Fused chain front over rows form: one signal read + one write.

    Args:
      xrows: ``(C, nb, L)`` RAW rows signal (pre-saturation), float32.
      s_in_eq: ``(C, nb, S)`` per-block EQ incoming states, computed from
        the SATURATED signal (``iir.sosfilt_states_rows``).
      t_eq / w_eq: the EQ's ``T (L, L)`` and ``W (L, S)`` operators.
      saturation_percent / width: the slider values.
      emit_mono: also return the output's channel mean ``(nb, L)``.

    Returns ``y (C, nb, L)``, or ``(y, mono)`` with ``emit_mono``.
    """
    if xrows.device.type == "cpu":
        return front_chain_ref(xrows, s_in_eq, t_eq, w_eq,
                               saturation_percent, width, emit_mono)
    c, nb, L, s = _check_operands("front_chain", xrows, s_in_eq, t_eq, w_eq)
    y = torch.empty_like(xrows)
    mono = (torch.empty((nb, L), dtype=xrows.dtype, device=xrows.device)
            if emit_mono else None)
    wt = w_eq.T.contiguous()
    t_eq = t_eq.contiguous()
    mix, drive = saturation_coefs(saturation_percent)
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_front_chain(
            _ptr(xrows), _ptr(t_eq), _ptr(wt), _ptr(s_in_eq), _ptr(y),
            None if mono is None else _ptr(mono), c, nb, L, s, mix, drive,
            float(width), stream)
    _raise_on("front_chain", err)
    front_chain.launches += 1
    return (y, mono) if emit_mono else y


def kweight_cells(xrows, s_in, t_kw, w_kw, hop):
    """Hop-bucketed K-weighted energy sums ``(C, nb·L/hop)``.

    Args:
      xrows: ``(C, nb, L)`` rows-form meter input (mono ``(1, nb, L)`` on
        the reference-parity chain), float32.
      s_in: ``(C, nb, S)`` per-block incoming K-filter states.
      t_kw / w_kw: the K-filter's ``T (L, L)`` / ``W (L, S)`` operators
        (float64-built: the K-weighting poles sit near the unit circle).
      hop: bucket width ``h``, a divisor of ``L`` (``gcd(cell, L)``).
    """
    if xrows.device.type == "cpu":
        return kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop)
    c, nb, L, s = _check_operands("kweight_cells", xrows, s_in, t_kw, w_kw)
    if L % hop != 0:
        raise ValueError(f"hop {hop} must divide block size {L}")
    out = torch.empty((c, nb * (L // hop)), dtype=xrows.dtype,
                      device=xrows.device)
    wt = w_kw.T.contiguous()
    t_kw = t_kw.contiguous()
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_kweight_cells(_ptr(xrows), _ptr(t_kw), _ptr(wt),
                                    _ptr(s_in), _ptr(out), c, nb, L, s,
                                    int(hop), stream)
    _raise_on("kweight_cells", err)
    kweight_cells.launches += 1
    return out


front_chain.launches = 0
kweight_cells.launches = 0
_WRAPPERS = (front_chain, kweight_cells)


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
