"""The chain's tail in one kernel: each track's loudness gain, the soft
limiter of either variant and the unfold from the rows form to ``(T, n,
C)`` (K9, CUDA ``csrc/gain_limit.cu``).

The JAX package has no kernel here: XLA fuses ``x * gain``, the limiter
and the transpose into one elementwise pass.  In plain torch they are a
full multiply, a strided read of the ``(T, n, C)`` view and a dozen more
elementwise passes.  :func:`gain_limit` reads each input sample once and
writes each output sample once, in the same float32 operations as
``waveshaper.soft_limiter`` / ``soft_limiter_legacy`` of ``xr * gain``, in
their order, so it agrees with them bit for bit on the card.

Like ``ops.cuda_multiband``'s wrappers, :func:`gain_limit` takes its plain
version :func:`gain_limit_ref` for a tensor on the CPU and launches the
kernel for a CUDA tensor or raises; it counts its launches in
``gain_limit.launches`` and the twin its calls in ``gain_limit_ref.calls``
(both read through ``cuda_multiband.launch_counts`` / ``plain_calls``).
Under autograd (the automaster's chain: the signal and the gain derived
from it) it runs through :class:`_GainLimitFn`, whose forward is the same
launch and whose backward is the VJP in plain torch.
"""

from __future__ import annotations

import torch

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on
from python_audio_mastering_tpu_torch.ops._kernels import (
    wants_grad as _wants_grad,
)
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    soft_limiter,
    soft_limiter_legacy,
)

__all__ = ["gain_limit", "gain_limit_ref", "KNEE"]

KNEE = 0.02                 # waveshaper.soft_limiter's default knee
_VARIANTS = {"worker": 0, "legacy": 1}


def gain_limit_ref(xr, gain, n, threshold, variant="worker", knee=KNEE):
    """Plain version of :func:`gain_limit`: the chain's unfused tail,
    ``xr * gain``, the ``(T, n, C)`` view and the variant's limiter, made
    contiguous."""
    gain_limit_ref.calls += 1
    tracks = xr.shape[1]
    if gain is not None:
        xr = xr * gain.view(1, tracks, 1)
    y = xr[:, :, :n].permute(1, 2, 0)
    if variant == "legacy":
        y = soft_limiter_legacy(y, threshold=threshold)
    else:
        y = soft_limiter(y, threshold=threshold, knee=knee)
    return y.contiguous()


def gain_limit(xr, gain, n, threshold, variant="worker", knee=KNEE):
    """The mastered ``(T, n, C)`` from the post-multiband (or post-front)
    rows ``xr (C, T, M)``, ``M >= n``, float32.

    Args:
      xr: ``(C, T, M)`` the signal, each ``(channel, track)`` a row of
        ``M = nb·L`` samples of which the first ``n`` are kept.
      gain: ``(T,)`` each track's linear loudness gain on ``xr``'s device,
        or None (loudness off: no multiply).
      n: the frames of the output.
      threshold: the limiter's threshold (``ChainConfig.limiter_threshold``).
      variant: ``"worker"`` (the rational knee of
        ``waveshaper.soft_limiter``, at ``knee``) or ``"legacy"`` (``tanh``
        above the threshold, ``soft_limiter_legacy``).

    Returns ``y (T, n, C)``, contiguous: ``limiter(gain[t] · xr[c, t, i])``
    at ``y[t, i, c]``.
    """
    if variant not in _VARIANTS:
        raise ValueError(f"gain_limit: unknown variant {variant!r}")
    if _wants_grad(xr, gain):
        return _GainLimitFn.apply(xr, gain, int(n), float(threshold),
                                  variant, float(knee))
    return _gain_limit_forward(xr, gain, n, threshold, variant, knee)


def _gain_limit_forward(xr, gain, n, threshold, variant, knee):
    """K9's launch on a CUDA tensor (its plain version on the CPU)."""
    if xr.device.type == "cpu":
        return gain_limit_ref(xr, gain, n, threshold, variant, knee)
    if xr.device.type != "cuda":
        raise ValueError(f"gain_limit: no kernel for device {xr.device}")
    if xr.ndim != 3 or xr.dtype != torch.float32:
        raise ValueError(f"gain_limit: xr must be (C, T, M) float32, got "
                         f"{tuple(xr.shape)} {xr.dtype}")
    c, tracks, m = xr.shape
    n = int(n)
    if not 1 <= n <= m:
        raise ValueError(f"gain_limit: n = {n} frames of rows of {m}")
    if gain is not None and (tuple(gain.shape) != (tracks,)
                             or gain.dtype != torch.float32
                             or gain.device != xr.device):
        raise ValueError(f"gain_limit: gain must be ({tracks},) float32 on "
                         f"{xr.device}, got {tuple(gain.shape)} {gain.dtype} "
                         f"on {gain.device}")
    xr = xr.contiguous()
    g = None if gain is None else gain.contiguous()
    y = torch.empty((tracks, n, c), dtype=xr.dtype, device=xr.device)
    lib = _kernels.library().lib
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        err = lib.pam_gain_limit(_ptr(xr), None if g is None else _ptr(g),
                                 _ptr(y), c, tracks, m, n, float(threshold),
                                 float(knee), _VARIANTS[variant], stream)
    _raise_on("gain_limit", err)
    gain_limit.launches += 1
    return y


class _GainLimitFn(torch.autograd.Function):
    """K9 under autograd.  Forward: the kernel (the plain version on the
    CPU).  Backward, in plain torch, with ``z = gain·x`` recomputed (not
    saved): where ``|z| > thr`` the limiter's derivative, worker ``(1 +
    q²)^(-3/2)``, ``q = (|z| − thr)/knee``, legacy ``thr·(1 − tanh²z)``,
    else 1; ``dz = dy · f'(z)``, ``dx = dz · gain`` on the first ``n``
    frames (0 on the padding), ``d gain[t] = Σ dz · x`` over track
    ``t``.  Nothing but the inputs is saved."""

    @staticmethod
    def forward(ctx, xr, gain, n, threshold, variant, knee):
        ctx.n, ctx.threshold, ctx.variant, ctx.knee = (n, threshold, variant,
                                                       knee)
        ctx.save_for_backward(xr, gain)
        return _gain_limit_forward(xr, gain, n, threshold, variant, knee)

    @staticmethod
    def backward(ctx, dy):
        xr, gain = ctx.saved_tensors
        n, thr = ctx.n, ctx.threshold
        tracks = xr.shape[1]
        x = xr[:, :, :n].permute(1, 2, 0)
        z = x if gain is None else x * gain.view(tracks, 1, 1)
        above = z.abs() > thr
        if ctx.variant == "legacy":
            th = torch.tanh(z)
            slope = thr * (1.0 - th * th)
        else:
            q = (z.abs() - thr) / ctx.knee
            slope = (1.0 + q * q) ** -1.5
        dz = dy * torch.where(above, slope, torch.ones_like(slope))
        d_x = d_gain = None
        if ctx.needs_input_grad[0]:
            d_x = torch.zeros_like(xr)
            d_x[:, :, :n] = (dz if gain is None
                             else dz * gain.view(tracks, 1, 1)).permute(
                                 2, 0, 1)
        if gain is not None and ctx.needs_input_grad[1]:
            d_gain = (dz * x).sum(dim=(1, 2))
        return d_x, d_gain, None, None, None, None


gain_limit.launches = 0
gain_limit_ref.calls = 0
