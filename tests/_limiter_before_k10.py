"""The quality limiter's one-shot path as it read before K10: a verbatim
copy of ``ops.limiter``'s plain stages and ``lookahead_limiter`` from
then, the golden version that ``lookahead_limit_ref`` and the CPU route
are held to bit for bit (``test_torch_lookahead_limit.py``)."""

import math

import torch
import torch.nn.functional as F

from python_audio_mastering_tpu_torch.ops.meters import (
    _interpolate,
    _oversample_taps,
)
from python_audio_mastering_tpu_torch.utils.tracing import span

_SCAN_ROW = 1024   # samples a row of the release's prefix max


def _windowed_min_forward(g, window):
    """min over ``[i, i + window)`` per position, by log-depth doubling."""
    n = g.shape[0]
    out = g
    span = 1
    while span < window:
        step = min(span, window - span)
        shifted = torch.cat([out[step:],
                             out.new_full((step,), float("inf"))])[:n]
        out = torch.minimum(out, shifted)
        span += step
    return out


def _prefix_max(v):
    """Running max of a 1-D tensor: ``torch.cummax`` along rows of
    :data:`_SCAN_ROW`, then each row raised to the max of the rows before
    it."""
    n = v.shape[0]
    rows = -(-n // _SCAN_ROW)
    m = F.pad(v, (0, rows * _SCAN_ROW - n), value=-math.inf).reshape(
        rows, _SCAN_ROW)
    m = torch.cummax(m, dim=1).values
    if rows > 1:
        before = torch.cummax(m[:-1, -1], dim=0).values
        # out of place: autograd keeps m for the maximum's backward
        m = torch.cat([m[:1], torch.maximum(m[1:], before[:, None])])
    return m.reshape(-1)[:n]


@span("release")
def _release_scan(target, rho, g0=None):
    """Exact release: ``g[i] = min(target[i], 1 − (1 − g[i−1])·rho)``.

    ``g0``: the gain before the first sample (1 at the signal start; the
    carried gain when streaming), a 0-d tensor or a float.  Computed in
    float64 (see the module docstring) and returned in ``target``'s dtype;
    the final ``min`` with ``target`` keeps the cap exact.
    """
    n = target.shape[0]
    t64 = target.to(torch.float64)
    log_rho = math.log(rho)
    steps = torch.arange(n, dtype=torch.float64,
                         device=target.device) * log_rho
    # 1 − t ≤ 0 (a smoothed gain at 1, or a rounding above it) is log 0 =
    # −inf and never wins the max; the inner where keeps log's gradient
    # finite there (0, not 0/0) under autograd
    u1 = 1.0 - t64
    pos = u1 > 0.0
    m = _prefix_max(torch.where(pos, torch.log(torch.where(pos, u1, 1.0)),
                                -math.inf) - steps)
    if g0 is not None:
        # the carried u[−1] = 1 − g0 enters as the term j = −1
        u0 = 1.0 - torch.as_tensor(g0, dtype=torch.float64,
                                   device=target.device)
        m = torch.maximum(m, torch.log(u0) + log_rho)
    u = torch.exp(m + steps)
    return torch.minimum(t64, 1.0 - u).to(target.dtype)


def _tp_khalf(true_peak: bool) -> int:
    """Half-width of the true-peak interpolator's per-phase tap window."""
    if not true_peak:
        return 0
    return (_oversample_taps(4).shape[0] // 4) // 2


def _peak_env(x, true_peak):
    """Per-position cross-channel (true-)peak envelope ``(N,)`` of ``(N, C)``
    audio.  The interpolator sees ``x`` zero-padded by ``khalf``: right at
    the signal's edges; streaming callers give it real context, so the
    padded positions are never used there."""
    n = x.shape[0]
    peak = x.abs().amax(dim=1)
    if not true_peak:
        return peak
    # interpolate the SIGNED waveform per channel, then rectify and pool
    acc = _interpolate(x, 4, pad=_tp_khalf(True))     # (C, n + 1, 4)
    return torch.maximum(peak, acc[:, :n].abs().amax(dim=(0, 2)))


def _attack_gain(raw_gain, look):
    """Erosion (centred windowed min, edges replicated) and a look-wide
    moving average: every value in the average comes from a window that
    covers position ``i``, so ``smoothed[i] ≤ raw_gain[i]``, a smooth
    attack with no overshoot and no added latency."""
    n = raw_gain.shape[0]
    padded = torch.cat([raw_gain[:1].expand(look), raw_gain,
                        raw_gain[-1:].expand(look)])
    att_gain = _windowed_min_forward(padded, 2 * look + 1)[:n]
    if look > 1:
        ext = torch.cat([att_gain, att_gain[-1:].expand(look)])
        csum = F.pad(torch.cumsum(ext.to(torch.float64), dim=0), (1, 0))
        att_gain = ((csum[look: n + look] - csum[:n]) / look).to(
            raw_gain.dtype)
    return att_gain


def _limiter_gain(work, sample_rate, ceiling_db, lookahead_ms, true_peak):
    """Raw gain from the peak envelope, then the attack: ``(N,)``."""
    look = max(1, int(lookahead_ms * sample_rate / 1000.0))
    ceiling = 10.0 ** (ceiling_db / 20.0)
    with span("truepeak"):
        peak = _peak_env(work, true_peak)
    with span("attack"):
        raw_gain = torch.clamp(ceiling / torch.clamp_min(peak, 1e-9),
                               max=1.0)
        return _attack_gain(raw_gain, look)


def _rho(sample_rate, release_ms):
    return math.exp(-1.0 / (release_ms * sample_rate / 1000.0))


def lookahead_limiter(x, sample_rate, ceiling_db=-1.0, lookahead_ms=1.5,
                      release_ms=60.0, true_peak=True):
    """Limit ``(N, C)`` (or ``(N,)``) audio to ``ceiling_db`` (dBTP by
    default).  The output has the input's shape and is time-aligned with
    it (the gain curve looks ahead; the signal is not delayed)."""
    x = torch.as_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    att_gain = _limiter_gain(x, sample_rate, ceiling_db, lookahead_ms,
                             true_peak)
    gain = _release_scan(att_gain, _rho(sample_rate, release_ms))
    y = x * gain[:, None]
    return y[:, 0] if squeeze else y
