"""Biquad / SOS filter design, float64 on the host.

Counterpart of ``python_audio_mastering_tpu.ops.biquad`` for the designs
this slice needs.  Every function returns second-order sections in scipy
layout, rows of ``[b0, b1, b2, 1.0, a1, a2]``, as a float64 numpy array:
the port's sliders are concrete per job, so the filters are designed on
the host and only their blocked operators go to the device.

* ``reference_*`` — the reference engine's shelf/peak formulas, including
  its doubled ``w0 = 2*pi*fc/nyquist`` (its "250 Hz" shelf corners at
  500 Hz; DESIGN.md §3) and the clamp of ``w0`` just under pi (DESIGN.md
  D10).
* ``deman_*`` — the tan-based K-weighting designs that reproduce the
  ITU-R BS.1770-4 48 kHz tables and generalize to any sample rate.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "reference_shelf_sos",
    "reference_peak_sos",
    "deman_high_shelf_sos",
    "deman_high_pass_sos",
]


def _row(b0, b1, b2, a0, a1, a2):
    return np.array([[b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0]],
                    dtype=np.float64)


def _reference_w0(sample_rate, hz):
    return min(2.0 * math.pi * (hz / (0.5 * sample_rate)), 0.999 * math.pi)


def reference_shelf_sos(sample_rate, cutoff_hz, gain_db, kind):
    """Shelf exactly as the reference computes it (identity at 0 dB)."""
    w0 = _reference_w0(sample_rate, cutoff_hz)
    a = 10.0 ** (float(gain_db) / 20.0)
    q = 0.707
    cosw0 = math.cos(w0)
    alpha = math.sin(w0) / (2.0 * q)
    sqrt_a = math.sqrt(a)
    if kind == "low":
        return _row(a * ((a + 1) - (a - 1) * cosw0 + 2 * sqrt_a * alpha),
                    2 * a * ((a - 1) - (a + 1) * cosw0),
                    a * ((a + 1) - (a - 1) * cosw0 - 2 * sqrt_a * alpha),
                    (a + 1) + (a - 1) * cosw0 + 2 * sqrt_a * alpha,
                    -2 * ((a - 1) + (a + 1) * cosw0),
                    (a + 1) + (a - 1) * cosw0 - 2 * sqrt_a * alpha)
    if kind == "high":
        return _row(a * ((a + 1) + (a - 1) * cosw0 + 2 * sqrt_a * alpha),
                    -2 * a * ((a - 1) + (a + 1) * cosw0),
                    a * ((a + 1) + (a - 1) * cosw0 - 2 * sqrt_a * alpha),
                    (a + 1) - (a - 1) * cosw0 + 2 * sqrt_a * alpha,
                    2 * ((a - 1) - (a + 1) * cosw0),
                    (a + 1) - (a - 1) * cosw0 - 2 * sqrt_a * alpha)
    raise ValueError(f"kind must be 'low' or 'high', got {kind!r}")


def reference_peak_sos(sample_rate, center_hz, gain_db, q=1.0):
    """Peaking EQ exactly as the reference computes it (identity at 0 dB)."""
    w0 = _reference_w0(sample_rate, center_hz)
    a = 10.0 ** (float(gain_db) / 20.0)
    cosw0 = math.cos(w0)
    alpha = math.sin(w0) / (2.0 * q)
    return _row(1 + alpha * a, -2 * cosw0, 1 - alpha * a,
                1 + alpha / a, -2 * cosw0, 1 - alpha / a)


_KW_SHELF_G = 3.999843853973347
_KW_SHELF_Q = 0.7071752369554196
_KW_SHELF_FC = 1681.974450955533
_KW_HP_Q = 0.5003270373238773
_KW_HP_FC = 38.13547087602444


def deman_high_shelf_sos(sample_rate, gain_db=_KW_SHELF_G, q=_KW_SHELF_Q,
                         fc=_KW_SHELF_FC):
    """Stage-1 K-weighting high shelf (+4 dB above ~1.5 kHz)."""
    k = math.tan(math.pi * fc / sample_rate)
    vh = 10.0 ** (gain_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b0 = (vh + vb * k / q + k * k) / a0
    b1 = 2.0 * (k * k - vh) / a0
    b2 = (vh - vb * k / q + k * k) / a0
    a1 = 2.0 * (k * k - 1.0) / a0
    a2 = (1.0 - k / q + k * k) / a0
    return np.array([[b0, b1, b2, 1.0, a1, a2]], dtype=np.float64)


def deman_high_pass_sos(sample_rate, q=_KW_HP_Q, fc=_KW_HP_FC):
    """Stage-2 K-weighting high pass (RLB weighting, ~38 Hz)."""
    k = math.tan(math.pi * fc / sample_rate)
    denom = 1.0 + k / q + k * k
    a1 = 2.0 * (k * k - 1.0) / denom
    a2 = (1.0 - k / q + k * k) / denom
    return np.array([[1.0, -2.0, 1.0, 1.0, a1, a2]], dtype=np.float64)
