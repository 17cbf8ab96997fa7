"""Memoryless nonlinearities of both chain variants (counterpart of
``python_audio_mastering_tpu.ops.waveshaper``).  Pure functions.

* ``saturate`` / ``soft_limiter`` — the worker chain (reference
  engine:128-134, 224-227);
* ``saturate_legacy`` / ``soft_limiter_legacy`` — the legacy chain of the
  monolith service (reference main.py:94-97, 189-192).

Both exciters are one form, ``dry·x + wet·tanh(drive·x)``
(:func:`exciter`), whose three coefficients :func:`exciter_coefs` gives
per variant: the ``front_chain`` kernel takes them as it finds them, and
the EQ states pass before it reads the signal through the same
:func:`exciter`.

A slider given as a tensor takes a tensor route: the coefficients stay
tensors of the slider (``mix``, ``drive`` and ``dry = 1 − mix`` in its
dtype, as the JAX chain computes them in the signal's), so autograd
reaches the slider through them.  A float slider's coefficients are
rounded as the JAX chain computes them in the signal's dtype: in float32
``dry = fp32(1 − fp32(mix))`` and the legacy ``g`` in float32, in float64
neither (a float32 ``dry`` in a float64 chain was 3.8e-9 from JAX's at
saturation 10, and the multiband compressor carries that to its output).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["saturation_coefs", "legacy_gain", "exciter_coefs", "exciter",
           "saturate", "saturate_legacy", "soft_limiter",
           "soft_limiter_legacy"]


def saturation_coefs(saturation_percent):
    """``(mix, drive)`` of the worker exciter: ``mix = (pct/100)^2``,
    ``drive = 1 + 4·mix``."""
    mix = (float(saturation_percent) / 100.0) ** 2
    return mix, 1.0 + mix * 4.0


def legacy_gain(amount, dtype=torch.float32):
    """The legacy exciter's ``g = 1 + 4·amount/100``, in ``dtype``'s
    precision (float32 or float64) as the JAX chain computes it."""
    if dtype == torch.float64:
        return 1.0 + (float(amount) / 100.0) * 4.0
    a = np.float32(amount)
    return float(np.float32(1.0) + (a / np.float32(100.0)) * np.float32(4.0))


def exciter_coefs(saturation_percent, variant: str = "worker",
                  dtype=torch.float32):
    """``(dry, wet, drive)`` of ``dry·x + wet·tanh(drive·x)``.

    Worker: ``dry = 1 − mix`` (``fp32(1 − fp32(mix))`` for a float32
    ``dtype``, the signal's), ``wet = mix``, ``drive = 1 + 4·mix``.
    Legacy: ``tanh(g·x)/g`` as ``dry = 0``, ``wet = 1/g``, ``drive = g``
    (:func:`legacy_gain`); at amount 0 the identity, ``(1, 0, 1)``.
    A ``(dry, wet, drive)`` triple passes through unchanged (a tensor in it
    stays a tensor).  A tensor slider gives tensors: worker ``mix =
    (s/100)^2``, ``dry = 1 − mix``, ``drive = 1 + 4·mix``; legacy ``g = 1
    + 4·s/100`` and the identity where ``s == 0`` (a ``where``, as JAX's
    ``saturate_legacy``).
    """
    if isinstance(saturation_percent, (tuple, list)):
        return tuple(c if isinstance(c, torch.Tensor) else float(c)
                     for c in saturation_percent)
    if isinstance(saturation_percent, torch.Tensor):
        s = saturation_percent
        if variant == "legacy":
            g = 1.0 + (s / 100.0) * 4.0
            off = s == 0.0
            one, zero = torch.ones_like(g), torch.zeros_like(g)
            return (torch.where(off, one, zero),
                    torch.where(off, zero, 1.0 / g), torch.where(off, one, g))
        mix = (s / 100.0) ** 2
        return 1.0 - mix, mix, 1.0 + mix * 4.0
    if variant == "legacy":
        if float(saturation_percent) == 0.0:
            return 1.0, 0.0, 1.0
        g = legacy_gain(saturation_percent, dtype)
        return 0.0, 1.0 / g, g
    mix, drive = saturation_coefs(saturation_percent)
    if dtype == torch.float64:
        return 1.0 - mix, mix, drive
    return float(np.float32(1.0) - np.float32(mix)), mix, drive


def exciter(x, coefs):
    """``dry·x + wet·tanh(x·drive)`` for ``coefs = (dry, wet, drive)``."""
    dry, wet, drive = coefs
    return dry * x + wet * torch.tanh(x * drive)


def saturate(x, saturation_percent):
    """Dry/wet tanh waveshaper: ``(1-mix)·x + mix·tanh(x·drive)``
    (the identity at 0 %)."""
    return exciter(x, exciter_coefs(saturation_percent, dtype=x.dtype))


def saturate_legacy(x, amount):
    """Gain-compensated tanh ``tanh(x·g)/g``, ``g = 1 + 4·amount/100``;
    the identity at amount 0 (main.py:95; a ``where`` for a tensor
    ``amount``)."""
    if isinstance(amount, torch.Tensor):
        g = 1.0 + (amount / 100.0) * 4.0
        return torch.where(amount == 0.0, x, torch.tanh(x * g) / g)
    if float(amount) == 0.0:
        return x
    g = legacy_gain(amount, x.dtype)
    return torch.tanh(x * g) / g


def soft_limiter(x, threshold=0.98, knee=0.02):
    """Rational soft knee above ``threshold``:
    ``thr + (|x|-thr)/sqrt(1 + ((|x|-thr)/knee)^2)``, sign preserving."""
    ax = x.abs()
    over = ax - threshold
    limited = threshold + over / torch.sqrt(1.0 + (over / knee) ** 2)
    return torch.where(ax > threshold, limited * torch.sign(x), x)


def soft_limiter_legacy(x, threshold=0.98):
    """tanh limiter: ``tanh(x)·thr`` where ``|x| > thr`` (main.py:189-192)."""
    return torch.where(x.abs() > threshold, torch.tanh(x) * threshold, x)
