"""The quality mode's lookahead true-peak limiter in one kernel a track
(K10, CUDA ``csrc/lookahead_limit.cu``).

The JAX package has no kernel here: XLA runs ``ops/limiter.py``'s jnp
ops.  In plain torch they are ~40 whole-track passes.
:func:`lookahead_limit` reads each frame once and writes each frame once:
the 4× interpolator's float32 FMAs, the peak envelope, the raw gain, its
erosion and look-wide moving average (a float64 sum), the float64 release
and the gain's multiply.

Its plain version is ``ops.limiter.lookahead_limit_ref``, the limiter's
stages, which the CPU, float64, autograd and the streamed limiter take;
``ops.limiter.lookahead_limiter`` chooses between them.  The wrapper
launches the kernel for a CUDA tensor or raises, and counts its launches
in ``lookahead_limit.launches`` (read through
``cuda_multiband.launch_counts``).

A tile holds 4352 slots of gain, ``4352 − 3·look`` frames of output and
their halos, so the kernel takes a look-ahead of at most
:data:`MAX_LOOK` frames (31 ms at 44.1 kHz, 14 ms at 96 kHz; the chain's
is 1.5 ms).
"""

from __future__ import annotations

import math

import torch

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on

__all__ = ["lookahead_limit", "look_frames", "release_rho", "MAX_LOOK"]

_SLOTS = 4352          # csrc/lookahead_limit.cu: gain slots a tile
MAX_LOOK = (_SLOTS - 256) // 3


def look_frames(sample_rate, lookahead_ms):
    """The look-ahead in frames, at least 1."""
    return max(1, int(lookahead_ms * sample_rate / 1000.0))


def release_rho(sample_rate, release_ms):
    """The release's factor a frame, ``exp(−1 / release frames)``."""
    return math.exp(-1.0 / (release_ms * sample_rate / 1000.0))


def lookahead_limit(x, taps, sample_rate, ceiling_db=-1.0, lookahead_ms=1.5,
                    release_ms=60.0, true_peak=True):
    """The lookahead limiter of ``x`` in one launch.

    Args:
      x: ``(N, C)`` or ``(N,)`` float32 on the card, any strides (the
        chain's track is a view of its channel-major rows).
      taps: the interpolator's 128 float32 taps on ``x``'s device,
        ``h[4·i + p]`` (phase ``p``'s tap ``i``); unread without
        ``true_peak``.
      the rest: as ``ops.limiter.lookahead_limiter``'s, a look-ahead of
        at most :data:`MAX_LOOK` frames.

    Returns a new contiguous tensor of ``x``'s shape.  The arithmetic is
    the plain stages' (the FIR's float32 FMAs in the order of their
    product, the moving sum and the release in float64), its sums grouped
    by tile: the output agrees with theirs within a few float32 units.
    """
    if x.device.type != "cuda":
        raise ValueError(f"lookahead_limit: no kernel for device {x.device}")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"lookahead_limit: x must be (N, C) or (N,) "
                         f"float32, got {tuple(x.shape)} {x.dtype}")
    n, c = x.shape
    look = look_frames(sample_rate, lookahead_ms)
    if c < 1 or look > MAX_LOOK:
        raise ValueError(f"lookahead_limit: {c} channels and a look-ahead "
                         f"of {look} frames; the kernel takes 1 channel or "
                         f"more and at most {MAX_LOOK} frames")
    y = torch.empty((n, c), dtype=x.dtype, device=x.device)
    if n:
        frames = _SLOTS - 3 * look          # a tile's
        tiles = -(-n // frames)
        rho = release_rho(sample_rate, release_ms)
        flags = torch.zeros(tiles + 1, dtype=torch.int32, device=x.device)
        vals = torch.empty(2 * tiles, dtype=torch.float64, device=x.device)
        lib = _kernels.library().lib
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.pam_lookahead_limit(
                _ptr(x), _ptr(y), n, c, x.stride(0), x.stride(1), look,
                int(bool(true_peak)), 10.0 ** (ceiling_db / 20.0), rho,
                rho ** frames, _ptr(taps), _ptr(flags), _ptr(vals), tiles,
                stream)
        _raise_on("lookahead_limit", err)
        lookahead_limit.launches += 1
    return y[:, 0] if squeeze else y


lookahead_limit.launches = 0
