"""Memoryless nonlinearities of the worker chain: the tanh exciter and the
soft-knee limiter (counterpart of ``python_audio_mastering_tpu.ops.waveshaper``,
worker variant; reference engine:128-134, 224-227).  Pure functions."""

from __future__ import annotations

import torch

__all__ = ["saturation_coefs", "saturate", "soft_limiter"]


def saturation_coefs(saturation_percent):
    """``(mix, drive)`` of the exciter: ``mix = (pct/100)^2``,
    ``drive = 1 + 4·mix``."""
    mix = (float(saturation_percent) / 100.0) ** 2
    return mix, 1.0 + mix * 4.0


def saturate(x, saturation_percent):
    """Dry/wet tanh waveshaper: ``(1-mix)·x + mix·tanh(x·drive)``
    (the identity at 0 %)."""
    mix, drive = saturation_coefs(saturation_percent)
    return (1.0 - mix) * x + mix * torch.tanh(x * drive)


def soft_limiter(x, threshold=0.98, knee=0.02):
    """Rational soft knee above ``threshold``:
    ``thr + (|x|-thr)/sqrt(1 + ((|x|-thr)/knee)^2)``, sign preserving."""
    ax = x.abs()
    over = ax - threshold
    limited = threshold + over / torch.sqrt(1.0 + (over / knee) ** 2)
    return torch.where(ax > threshold, limited * torch.sign(x), x)
