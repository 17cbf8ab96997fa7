"""The plain reference of the chain in quality mode, in NumPy and SciPy:
the front and the loudness gain of ``reference/chain.py``, then the
lookahead true-peak limiter, written again from its definition.

    worker:  saturate → 4-band EQ → width → [3-band compressor] →
             BS.1770 gated loudness → gain → lookahead true-peak limiter

The stages before the limiter are ``reference/chain.py``'s own
(``resolve_settings``, the variant's front, ``_compress``,
``integrated_loudness``, ``_Arith``), read and not changed.  The limiter,
in float64, at a ceiling of −1 dBTP:

* the interpolator: a Kaiser-windowed sinc of 4 phases × 32 taps, β 9,
  its taps summing to 4 (a DC gain of 4, 1 a phase), applied as a direct
  sum to the signal zero-padded by 16 samples at each end; position ``j``
  of phase ``p`` is ``Σ_i h[4i + p]·xp[j + 31 − i]``;
* the peak envelope: at each position the larger of the sample peak and
  the interpolated peaks, across channels;
* the raw gain ``min(1, 10^(−1/20) / max(peak, 1e-9))``;
* ``look = int(1.5 ms · fs)`` samples (66 at 44.1 kHz);
* erosion: the min over ``[i − look, i + look]``, the edges replicated;
* the moving average over ``[i, i + look)``, the end replicated;
* the release, one sample at a time: ``g[i] = min(a[i], 1 − (1 −
  g[i−1])·ρ)``, ``ρ = exp(−1 / (60 ms · fs))``, ``g[−1] = 1``;
* ``y = x·g``.

Each track is limited to its own end: the reference sees the unpadded
track only.

Where it departs from the port's own formulation (``ops/limiter.py``,
``ops/meters.py``):

* the interpolator is a direct sum over each phase's taps
  (``numpy.convolve``); the port multiplies blocks of 1024 samples by a
  banded operator, in float32;
* erosion is ``scipy.ndimage.minimum_filter1d``; the port takes log-depth
  doubling passes of a forward min over the edge-padded gain;
* the moving average is a direct sum of ``look`` values; the port
  differences a float64 running sum;
* the release is a loop over the samples; the port takes the recurrence's
  closed form, a prefix max in the log domain, in float64;
* every stage is float64; the port's signal is float32.

It is written in NumPy and SciPy, not PyTorch: a reference module here
imports ``math``, ``numpy`` and ``scipy`` only (the harness's workers
that run it never load ``torch``), as ``reference/chain.py`` does.

``precision="tf32"`` computes the control instead: the front as
``reference/chain.py``'s control computes it, the interpolator's input
rounded to TF32, and every other stage of the limiter in float32 (the
release's carried gain in float64, its output in float32).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

from .chain import (
    PRECISIONS,
    _Arith,
    _compress,
    _legacy_front,
    _worker_front,
    integrated_loudness,
    resolve_settings,
    round_tf32,
)

__all__ = ["master_track", "limit", "release", "interpolator",
           "interpolated_peak", "true_peak", "PRECISIONS", "CEILING_DB",
           "MODE"]

MODE = "lookahead_truepeak"   # the configuration's limiter_mode
CEILING_DB = -1.0
LOOKAHEAD_MS = 1.5
RELEASE_MS = 60.0
FACTOR, TAPS, BETA = 4, 32, 9.0
PAD = TAPS // 2               # zeros at each end of the interpolated signal
GAIN_FLOOR = 1e-9             # the peak under which the gain is 1


def interpolator():
    """The phases' taps, ``(FACTOR, TAPS)``: row ``p`` holds ``h[4i + p]``
    of the 128-tap Kaiser-windowed sinc."""
    n = FACTOR * TAPS
    t = (np.arange(n) - (n - 1) / 2.0) / FACTOR
    h = np.sinc(t) * np.kaiser(n, BETA)
    h = h * FACTOR / h.sum()
    return h.reshape(TAPS, FACTOR).T


def interpolated_peak(x, ar=None):
    """The largest magnitude of ``x``'s interpolated samples at each
    position, across channels and phases: ``(n,)`` of ``x`` ``(n, C)``."""
    ar = ar or _Arith("float64")
    n = x.shape[0]
    xp = np.pad(np.asarray(x, np.float64), ((PAD, PAD), (0, 0)))
    if ar.tf32:
        xp = round_tf32(xp).astype(np.float64)
    peak = np.zeros(n)
    for ch in range(xp.shape[1]):
        for taps in interpolator():
            np.maximum(peak, np.abs(np.convolve(xp[:, ch], taps,
                                                mode="valid")[:n]), out=peak)
    return ar.cast(peak)


def true_peak(x):
    """The true peak of ``x`` ``(n, C)`` in dBTP, by this interpolator."""
    x = np.asarray(x, np.float64)
    peak = max(float(np.abs(x).max()), float(interpolated_peak(x).max()))
    return 20.0 * math.log10(max(peak, 1e-12))


def release(a, rho):
    """``g[i] = min(a[i], 1 − (1 − g[i−1])·rho)`` from ``g[−1] = 1``, one
    sample at a time."""
    g, out = 1.0, []
    push = out.append
    for ai in np.asarray(a, np.float64).tolist():
        r = 1.0 - (1.0 - g) * rho
        g = ai if ai < r else r
        push(g)
    return np.asarray(out)


def limit(x, fs, ar=None):
    """The lookahead true-peak limiter over one whole track ``x``
    ``(n, C)``."""
    ar = ar or _Arith("float64")
    x = ar.cast(x)
    n = x.shape[0]
    peak = np.maximum(np.abs(x).max(axis=1), interpolated_peak(x, ar))
    ceiling = 10.0 ** (CEILING_DB / 20.0)
    raw = ar.cast(np.minimum(1.0, ceiling / np.maximum(peak, GAIN_FLOOR)))
    look = max(1, int(LOOKAHEAD_MS * fs / 1000.0))
    eroded = ndimage.minimum_filter1d(raw, size=2 * look + 1, mode="nearest")
    ext = np.concatenate([eroded, np.full(look, eroded[-1])])
    window = ar.cast(np.ones(look))
    avg = ar.cast(np.convolve(ext, window, mode="valid")[:n] / ar.cast(look))
    rho = math.exp(-1.0 / (RELEASE_MS * fs / 1000.0))
    g = ar.cast(release(avg, rho))
    return ar.cast(x * g[:, None])


def master_track(x, settings, chain, precision="float64"):
    """Master one track ``x`` ``(n, C)`` with the settings dict and the
    chain's deployment (a configuration's ``chain`` dict: ``variant``,
    ``sample_rate``, ``comp_hop``, and ``limiter_mode``, which must be
    :data:`MODE`).  Returns ``(y (n, C), measured LUFS, y)``: the limiter
    has no branch that rounding decides, so ``y`` is its own alternative."""
    mode = chain.get("limiter_mode")
    if mode != MODE:
        raise ValueError(f"limiter_mode {mode!r}: this reference masters "
                         f"with the lookahead true-peak limiter ({MODE!r})")
    ar = _Arith(precision)
    fs, variant = int(chain["sample_rate"]), chain["variant"]
    s = resolve_settings(settings)
    front = _legacy_front if variant == "legacy" else _worker_front
    y = front(ar, ar.cast(x), fs, s)
    if s["multiband"]:
        y = _compress(ar, y, fs, variant, int(chain["comp_hop"]), s)
    measured = math.nan
    if s["lufs"] is not None:
        measured = integrated_loudness(y.mean(axis=1), fs, ar)
        gain = (10.0 ** ((s["lufs"] - measured) / 20.0)
                if math.isfinite(measured) else 1.0)
        y = ar.cast(y * gain)
    y = limit(y, fs, ar)
    return y, measured, y
