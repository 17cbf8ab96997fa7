"""Biquad / SOS filter design, float64 on the host.

Counterpart of ``python_audio_mastering_tpu.ops.biquad`` for the designs
this slice needs.  Every function returns second-order sections in scipy
layout, rows of ``[b0, b1, b2, 1.0, a1, a2]``, as a float64 numpy array:
the port's sliders are concrete per job, so the filters are designed on
the host and only their blocked operators go to the device.

* ``reference_*`` — the reference engine's shelf/peak formulas, including
  its doubled ``w0 = 2*pi*fc/nyquist`` (its "250 Hz" shelf corners at
  500 Hz; DESIGN.md §3) and the clamp of ``w0`` just under pi (DESIGN.md
  D10); ``rbj_*`` the textbook RBJ designs, ``w0 = 2*pi*fc/fs``.  Given
  a tensor gain the shelves and peaks are torch functions of it: a
  float64 ``(1, 6)`` tensor on the gain's device, in the graph (the
  automaster differentiates through them).  As in the JAX package there
  is no branch at 0 dB, so a fit that starts at 0 dB has a gradient.
* ``deman_*`` — the tan-based K-weighting designs that reproduce the
  ITU-R BS.1770-4 48 kHz tables and generalize to any sample rate.
* :func:`butter_sos` — Butterworth sections for the multiband crossovers,
  the same arithmetic as the JAX package's (scipy's transfer function,
  sections paired by ascending pole magnitude).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "reference_shelf_sos",
    "reference_peak_sos",
    "rbj_shelf_sos",
    "rbj_peak_sos",
    "rbj_highpass_sos",
    "deman_high_shelf_sos",
    "deman_high_pass_sos",
    "butter_sos",
    "sos_identity",
]


def _row(b0, b1, b2, a0, a1, a2):
    return np.array([[b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0]],
                    dtype=np.float64)


def _row_t(b0, b1, b2, a0, a1, a2):
    """:func:`_row` of tensor (or float) coefficients, float64."""
    vals = [b0 / a0, b1 / a0, b2 / a0, torch.ones_like(a0), a1 / a0,
            a2 / a0]
    return torch.stack(vals)[None]


def _gain_a(gain_db):
    """``10^(gain/20)``: float64 from a float, or a float64 tensor."""
    if isinstance(gain_db, torch.Tensor):
        return 10.0 ** (gain_db.to(torch.float64) / 20.0), torch.sqrt, _row_t
    return 10.0 ** (float(gain_db) / 20.0), math.sqrt, _row


def _reference_w0(sample_rate, hz):
    return min(2.0 * math.pi * (hz / (0.5 * sample_rate)), 0.999 * math.pi)


def sos_identity(dtype=np.float32):
    """A single pass-through SOS section."""
    return np.array([[1.0, 0.0, 0.0, 1.0, 0.0, 0.0]], dtype=dtype)


def reference_shelf_sos(sample_rate, cutoff_hz, gain_db, kind):
    """Shelf exactly as the reference computes it (identity at 0 dB);
    a torch function of a tensor ``gain_db``."""
    return _shelf_sos(_reference_w0(sample_rate, cutoff_hz), gain_db, kind)


def rbj_shelf_sos(sample_rate, cutoff_hz, gain_db, kind):
    """Textbook RBJ shelf (corner actually at ``cutoff_hz``)."""
    return _shelf_sos(2.0 * math.pi * cutoff_hz / sample_rate, gain_db,
                      kind)


def _shelf_sos(w0, gain_db, kind):
    """The RBJ shelf algebra at a given ``w0``."""
    a, sqrt, row = _gain_a(gain_db)
    q = 0.707
    cosw0 = math.cos(w0)
    alpha = math.sin(w0) / (2.0 * q)
    sqrt_a = sqrt(a)
    if kind == "low":
        return row(a * ((a + 1) - (a - 1) * cosw0 + 2 * sqrt_a * alpha),
                   2 * a * ((a - 1) - (a + 1) * cosw0),
                   a * ((a + 1) - (a - 1) * cosw0 - 2 * sqrt_a * alpha),
                   (a + 1) + (a - 1) * cosw0 + 2 * sqrt_a * alpha,
                   -2 * ((a - 1) + (a + 1) * cosw0),
                   (a + 1) + (a - 1) * cosw0 - 2 * sqrt_a * alpha)
    if kind == "high":
        return row(a * ((a + 1) + (a - 1) * cosw0 + 2 * sqrt_a * alpha),
                   -2 * a * ((a - 1) + (a + 1) * cosw0),
                   a * ((a + 1) + (a - 1) * cosw0 - 2 * sqrt_a * alpha),
                   (a + 1) - (a - 1) * cosw0 + 2 * sqrt_a * alpha,
                   2 * ((a - 1) - (a + 1) * cosw0),
                   (a + 1) - (a - 1) * cosw0 - 2 * sqrt_a * alpha)
    raise ValueError(f"kind must be 'low' or 'high', got {kind!r}")


def reference_peak_sos(sample_rate, center_hz, gain_db, q=1.0):
    """Peaking EQ exactly as the reference computes it (identity at 0 dB);
    a torch function of a tensor ``gain_db``."""
    return _peak_sos(_reference_w0(sample_rate, center_hz), gain_db, q)


def rbj_peak_sos(sample_rate, center_hz, gain_db, q=1.0):
    """Textbook RBJ peaking EQ (centre actually at ``center_hz``)."""
    return _peak_sos(2.0 * math.pi * center_hz / sample_rate, gain_db, q)


def _peak_sos(w0, gain_db, q):
    a, _, row = _gain_a(gain_db)
    cosw0 = math.cos(w0)
    alpha = math.sin(w0) / (2.0 * q)
    return row(1 + alpha * a, -2 * cosw0, 1 - alpha * a,
               1 + alpha / a, -2 * cosw0, 1 - alpha / a)


def rbj_highpass_sos(sample_rate, cutoff_hz, q):
    """Textbook RBJ high pass."""
    w0 = 2.0 * math.pi * cutoff_hz / sample_rate
    cosw0 = math.cos(w0)
    alpha = math.sin(w0) / (2.0 * q)
    return _row((1 + cosw0) / 2, -(1 + cosw0), (1 + cosw0) / 2, 1 + alpha,
                -2 * cosw0, 1 - alpha)


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


def _butter_prototype(order):
    """Analog Butterworth lowpass prototype poles (gain 1, no zeros)."""
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order)
    poles = -np.sin(theta) + 1j * np.cos(theta)
    return poles


def _bilinear_zpk(z, p, k, fs):
    fs2 = 2.0 * fs
    degree = len(p) - len(z)
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def _zpk2sos(z, p, k):
    """Pair conjugate roots into SOS rows (gain folded into first section).

    Poles/zeros are paired in order of ascending pole magnitude so the
    highest-Q section runs last, mirroring scipy's default ordering intent.
    """
    # Sort into conjugate pairs (+ possibly one real root for odd orders).
    def split(roots):
        real = sorted([r.real for r in roots if abs(r.imag) < 1e-10])
        cplx = sorted([r for r in roots if r.imag > 1e-10], key=lambda r: abs(r))
        return real, cplx

    preal, pcplx = split(p)
    zreal, zcplx = split(z)

    sections = []
    # Complex pole pairs, ascending magnitude (least → most resonant).
    for pp in pcplx:
        a = np.poly([pp, np.conj(pp)]).real  # [1, a1, a2]
        if zcplx:
            zz = zcplx.pop(0)
            b = np.poly([zz, np.conj(zz)]).real
        elif len(zreal) >= 2:
            b = np.poly([zreal.pop(0), zreal.pop(0)]).real
        elif len(zreal) == 1:
            b = np.array([0.0, 1.0, -zreal.pop(0)])  # degree-1 numerator
            b = np.array([b[1], b[2], 0.0])
        else:
            b = np.array([1.0, 0.0, 0.0])
        sections.append(np.concatenate([b, a]))
    # Real poles: combine two at a time, else a first-order section.
    while preal:
        if len(preal) >= 2:
            a = np.poly([preal.pop(0), preal.pop(0)]).real
        else:
            a = np.array([1.0, -preal.pop(0), 0.0])
        if len(zreal) >= 2 and a[2] != 0.0:
            b = np.poly([zreal.pop(0), zreal.pop(0)]).real
        elif zreal:
            b = np.array([1.0, -zreal.pop(0), 0.0])
        else:
            b = np.array([1.0, 0.0, 0.0])
        sections.append(np.concatenate([b, a]))
    sos = np.array(sections, dtype=np.float64)
    sos[0, :3] *= k
    return sos


def butter_sos(order, wn, btype="lowpass", fs=None):
    """Butterworth digital filter as SOS, matching scipy's transfer function.

    Args mirror ``scipy.signal.butter``: ``wn`` is the -3 dB frequency,
    normalized to Nyquist unless ``fs`` is given.  ``btype`` in
    {'lowpass', 'highpass', 'bandpass'}.
    """
    wn = np.asarray(wn, dtype=np.float64)
    if fs is not None:
        wn = wn / (0.5 * fs)
    if np.any(wn <= 0) or np.any(wn >= 1):
        raise ValueError(f"wn must be in (0, 1) after normalization, got {wn}")

    p = _butter_prototype(order)
    z = np.array([], dtype=complex)
    k = 1.0
    fs_design = 2.0
    warped = 2.0 * fs_design * np.tan(np.pi * wn / fs_design)

    if btype == "lowpass":
        p = p * warped
        k = k * np.real(warped ** order)
    elif btype == "highpass":
        k = k * np.real(1.0 / np.prod(-p))
        p = warped / p
        z = np.zeros(order, dtype=complex)
    elif btype == "bandpass":
        bw = warped[1] - warped[0]
        w0 = np.sqrt(warped[0] * warped[1])
        p_lp = p * bw / 2
        p = np.concatenate([
            p_lp + np.sqrt(p_lp ** 2 - w0 ** 2),
            p_lp - np.sqrt(p_lp ** 2 - w0 ** 2),
        ])
        z = np.zeros(order, dtype=complex)
        k = k * bw ** order
    else:
        raise ValueError(f"unsupported btype {btype!r}")

    z, p, k = _bilinear_zpk(z, p, k, fs_design)
    return _zpk2sos(z, p, k)
