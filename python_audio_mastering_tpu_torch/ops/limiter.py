"""True-peak lookahead brickwall limiter (quality mode).

Counterpart of ``python_audio_mastering_tpu.ops.limiter``, every stage a
whole-signal tensor operation:

* detection: the per-sample cross-channel peak, by default the 4×
  oversampled true-peak envelope (the interpolator of ``ops.meters``);
* attack: the raw gain is eroded by a forward-looking windowed min
  (log-depth doubling passes) and smoothed by a look-wide moving average,
  so the gain reaches its floor before the peak arrives.  The moving
  average's running sum is taken in float64: a float32 sum over a whole
  track drifts (the JAX package's does, ~2.9e-2 at 180 s, past the
  ceiling);
* release: ``g[i] = min(t[i], 1 − (1 − g[i−1])·ρ)``.  With ``u = 1 − g``
  each step is ``u[i] = max(1 − t[i], ρ·u[i−1])``, so ``u[i] = max_j≤i
  (1 − t[j])·ρ^(i−j)``, and in the log domain that is a plain prefix max:
  ``log u[i] = i·log ρ + max_j≤i (log(1 − t[j]) − j·log ρ)``.  The prefix
  max runs as ``torch.cummax`` over rows and once more over the rows'
  maxima, in float64 (the offsets ``j·log ρ`` grow with the signal; at
  float64 they stay exact to ~1e-12 of the gain over an hour).  It is the
  JAX package's associative scan, exact up to rounding.

:func:`lookahead_limiter_chunk` runs it chunk by chunk with a carried
history and pending buffer and the release gain, matching the one-shot
limiter to rounding.  Nothing in either path synchronises with the host.

On a CUDA float32 signal outside autograd, :func:`lookahead_limiter` is
one launch of K10 (``ops.lookahead_limit``, ``csrc/lookahead_limit.cu``):
the FIR's float32 FMAs, the envelope, erosion, the float64 moving sum
and the float64 release in shared memory and registers, each frame read
once and written once.  The kernel takes a look-ahead of at most
:data:`MAX_LOOK` frames (31 ms at 44.1 kHz; the chain's is 1.5 ms) and
raises beyond it.  Everywhere else (the CPU, float64, autograd) the
limiter runs the plain stages above, its twin :func:`lookahead_limit_ref`,
at any look-ahead; so does :func:`lookahead_limiter_chunk`.  The twin
counts its calls in ``lookahead_limit_ref.calls``
(``cuda_multiband.plain_calls``).

Each plain stage opens a ``utils.tracing`` span: ``truepeak`` (the
interpolator and the peak envelope), ``attack`` (the raw gain, erosion
and moving average) and ``release`` (the float64 prefix-max scan); the
gain multiply and the casts lie outside them.  The kernel opens none: on
the card the stages are one launch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops._kernels import (
    wants_grad as _wants_grad,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import (
    counts_plain_calls,
)
from python_audio_mastering_tpu_torch.ops.lookahead_limit import (
    MAX_LOOK,
    lookahead_limit,
)
from python_audio_mastering_tpu_torch.ops.lookahead_limit import (
    look_frames as _look,
)
from python_audio_mastering_tpu_torch.ops.lookahead_limit import (
    release_rho as _rho,
)
from python_audio_mastering_tpu_torch.ops.meters import (
    _interpolate,
    _oversample_taps,
)
from python_audio_mastering_tpu_torch.utils.tracing import span

__all__ = ["lookahead_limiter", "lookahead_limiter_chunk",
           "lookahead_limiter_init", "LookaheadLimiterState",
           "lookahead_limit_ref", "MAX_LOOK"]

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
    if rho == 0.0:
        # no memory: u[i] = max(1 − t[i], 0), the carried gain unread
        return torch.minimum(t64, 1.0 - torch.clamp_min(1.0 - t64, 0.0)).to(
            target.dtype)
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
    look = _look(sample_rate, lookahead_ms)
    ceiling = 10.0 ** (ceiling_db / 20.0)
    with span("truepeak"):
        peak = _peak_env(work, true_peak)
    with span("attack"):
        raw_gain = torch.clamp(ceiling / torch.clamp_min(peak, 1e-9),
                               max=1.0)
        return _attack_gain(raw_gain, look)


def lookahead_limiter(x, sample_rate, ceiling_db=-1.0, lookahead_ms=1.5,
                      release_ms=60.0, true_peak=True):
    """Limit ``(N, C)`` (or ``(N,)``) audio to ``ceiling_db`` (dBTP by
    default).  The output has the input's shape and is time-aligned with
    it (the gain curve looks ahead; the signal is not delayed).

    A CUDA float32 signal that needs no gradient takes K10
    (``ops.lookahead_limit``), which takes a look-ahead of at most
    :data:`MAX_LOOK` frames and raises ``ValueError`` beyond it; anything
    else the plain stages (:func:`lookahead_limit_ref`), at any
    look-ahead."""
    x = torch.as_tensor(x)
    args = (sample_rate, ceiling_db, lookahead_ms, release_ms, true_peak)
    if x.is_cuda and x.dtype == torch.float32 and not _wants_grad(x):
        return lookahead_limit(x, _k10_taps(x.device), *args)
    return lookahead_limit_ref(x, *args)


@counts_plain_calls
def lookahead_limit_ref(x, sample_rate, ceiling_db=-1.0, lookahead_ms=1.5,
                        release_ms=60.0, true_peak=True):
    """Plain version of K10 ``ops.lookahead_limit``: the limiter's stages as
    whole-signal tensor operations, on any device and dtype, under
    autograd too."""
    lookahead_limit_ref.calls += 1
    x = torch.as_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    att_gain = _limiter_gain(x, sample_rate, ceiling_db, lookahead_ms,
                             true_peak)
    gain = _release_scan(att_gain, _rho(sample_rate, release_ms))
    y = x * gain[:, None]
    return y[:, 0] if squeeze else y


@functools.lru_cache(maxsize=8)
def _k10_taps(device):
    """The interpolator's taps as the kernel reads them, on ``device``: 128
    float32, ``h[4·i + p]`` (phase ``p``'s tap ``i``), the float32
    operator's."""
    return _kernels.upload(_oversample_taps(4), torch.float32, device)


lookahead_limit_ref.calls = 0


# ---------------------------------------------------------------------------
# Streaming (chunked) execution with one-shot parity
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LookaheadLimiterState:
    """Carried streaming state.

    ``buf`` holds the raw input samples still needed: ``pend`` positions
    not yet emitted (they lack right context), preceded by up to ``look +
    khalf`` samples of history (left context for their gain windows).
    ``g`` is the release gain carried (a 0-d tensor on the signal's
    device).  ``pend`` is a Python int: it settles at ``2·look + khalf``
    after the first chunk, and every shape follows from it on the host.
    """

    buf: Any
    g: Any
    pend: int = 0


def lookahead_limiter_init(channels: int, dtype=torch.float32,
                           device="cpu"):
    """Fresh state for :func:`lookahead_limiter_chunk`."""
    return LookaheadLimiterState(
        buf=torch.zeros((0, channels), dtype=dtype, device=device),
        g=torch.ones((), dtype=dtype, device=device), pend=0)


def lookahead_limiter_chunk(chunk, state: LookaheadLimiterState, sample_rate,
                            ceiling_db=-1.0, lookahead_ms=1.5,
                            release_ms=60.0, true_peak=True, flush=False):
    """One streaming step of the lookahead limiter.

    Feed ``(M, C)`` chunks in order, then one call with ``flush=True``
    (``chunk`` may be None) to drain the pending buffer with the one-shot
    right-edge semantics.  The emissions, concatenated, equal
    :func:`lookahead_limiter` on the whole signal up to rounding: every
    gain stage but the release has finite support (erosion ±look, the
    average +look, the interpolator ±khalf), so recomputing it on ``buf ++
    chunk`` is exact, and the release carries one gain.

    Returns ``(y_emitted (E, C), new_state)``: E differs from the chunk
    length only at the first and final calls.
    """
    look = max(1, int(lookahead_ms * sample_rate / 1000.0))
    khalf = _tp_khalf(true_peak)
    h_left = look + khalf
    h_right = 2 * look + khalf

    if chunk is None:
        chunk = state.buf[:0]
    if chunk.ndim == 1:
        chunk = chunk[:, None]
    work = (torch.cat([state.buf.to(chunk.dtype), chunk])
            if state.buf.shape[0] else chunk)
    w = work.shape[0]
    e0 = state.buf.shape[0] - state.pend   # first un-emitted position
    n_avail = w - e0
    n_emit = n_avail if flush else max(0, n_avail - h_right)
    new_pend = n_avail - n_emit
    new_buf = work[max(0, w - (new_pend + h_left)):]
    if n_emit == 0:
        return (work[:0], LookaheadLimiterState(buf=new_buf, g=state.g,
                                                pend=new_pend))

    att_gain = _limiter_gain(work, sample_rate, ceiling_db, lookahead_ms,
                             true_peak)
    gain = _release_scan(att_gain[e0: e0 + n_emit],
                         _rho(sample_rate, release_ms), g0=state.g)
    y = work[e0: e0 + n_emit] * gain[:, None]
    return y, LookaheadLimiterState(buf=new_buf, g=gain[-1], pend=new_pend)
