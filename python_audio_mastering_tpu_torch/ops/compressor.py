"""Dynamic-range compressor with pydub's ``compress_dynamic_range``
contract, in plain torch over the port's ballistics kernels.

Counterpart of ``python_audio_mastering_tpu.ops.compressor`` (see the JAX
module's docstring for the contract):

* detector: the channel-mean squared signal over a lookback window of
  ``attack`` ms before each control step (``hop`` samples a step),
  partial at the start; the windowed means are differences of a running
  sum (:func:`cumsum_mxu`) taken in float64 (:func:`stats_from_buckets`);
* gain computer: ``max_att = (1 - 1/ratio)·max(0, dB(rms/thresh))``
  (:func:`gain_computer_stats_bt`);
* ballistics: exact on the kernels of ``ops.ballistics``
  (:func:`attenuation_exact`), or the JAX package's block-parallel
  approximation (:func:`attenuation_blocked`, warm-started by the
  exact-at-freeze coarse pre-scan :func:`attenuation_coarse`), which runs
  on the same kernels: its windows are rows of one ``(rows, steps)``
  timeline, the pre-context and padding frozen by zero targets.

Stats dicts here carry the ballistics' per-band rate factors beside the
JAX package's entries: ``ca = hop / attack_frames`` and ``cr = hop /
release_frames`` (the kernels take ``max_att`` and these, not the
``inc``/``dec`` arrays).  :func:`attenuation_scan`, a Python loop of one
step at a time, is the oracle ``ops.ballistics`` is tested against.
"""

from __future__ import annotations

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops._kernels import upload
from python_audio_mastering_tpu_torch.ops.ballistics import ballistics_rates_bt

__all__ = ["cumsum_mxu", "gain_computer_stats", "gain_computer_stats_bt",
           "stats_from_buckets", "bucket_sums", "detector_stats",
           "detector_stats_bands", "attenuation_scan", "attenuation_exact",
           "attenuation_coarse", "attenuation_blocked",
           "attenuation_blocked_bt",
           "compressor_gain_db", "compress_dynamic_range"]

COARSE_FACTOR = 64   # the coarse pre-scan's decimation (JAX default)


def cumsum_mxu(x, axis=-1, block=512):
    """Inclusive cumsum along ``axis`` as a two-stage partition: a
    ``(nb, block) @ triu(ones)`` product within blocks of ``block``
    elements, then an exclusive carry of the block totals.  Short inputs
    (at most ``2 · block``) take ``torch.cumsum``.  Runs in ``x``'s dtype
    (the detector passes float64)."""
    dim = axis % x.ndim
    if x.shape[dim] <= 2 * block:
        return torch.cumsum(x, dim=dim)
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n))
    xb = xb.reshape(x.shape[:-1] + (nb, block))
    tri = torch.triu(torch.ones((block, block), dtype=x.dtype,
                                device=x.device))
    within = xb @ tri
    totals = within[..., -1]
    carry = torch.cumsum(totals, dim=-1) - totals  # exclusive block carry
    out = (within + carry[..., None]).reshape(x.shape[:-1] + (nb * block,))
    return out[..., :n].movedim(-1, dim)


def gain_computer_stats(ms, thresholds_db, ratios, att_f, rel_f, hop):
    """:func:`gain_computer_stats_bt` of time-major ``(T, B)`` envelope
    columns: the stats dict of ``(T, B)`` tensors."""
    stats = gain_computer_stats_bt(ms.T, thresholds_db, ratios, att_f, rel_f,
                                   hop)
    return {k: v.T for k, v in stats.items()}


def gain_computer_stats_bt(ms_bt, thresholds_db, ratios, att_f, rel_f, hop):
    """dB-domain gain computer + ballistics rates from band-major ``(B, T)``
    mean-square envelopes.

    Args:
      thresholds_db / ratios: length-B sliders.
      att_f / rel_f: length-B attack/release frame counts.
    Returns the stats dict of ``(B, T)`` tensors: ``max_att``, ``above``,
    ``inc``, ``dec``.
    """
    dt, dev = ms_bt.dtype, ms_bt.device

    def col(v):
        return upload([float(a) for a in v], dt, dev)[:, None]

    thresh_amp = 10.0 ** (col(thresholds_db) / 20.0)
    rms = torch.sqrt(torch.clamp_min(ms_bt, 0.0))
    db_over = torch.clamp_min(
        20.0 * torch.log10(torch.clamp_min(rms, 1e-30) / thresh_amp), 0.0)
    db_over = torch.where(rms > 0, db_over, 0.0)
    max_att = (1.0 - 1.0 / col(ratios)) * db_over
    return {
        "max_att": max_att,
        "above": rms > thresh_amp,
        "inc": max_att / col(att_f) * hop,
        "dec": max_att / col(rel_f) * hop,
    }


def _frames(ms, sample_rate):
    return max(ms * sample_rate / 1000.0, 1.0)


def bucket_sums(x2, hop):
    """Hop-bucket sums ``(..., ceil(N/hop))`` of ``(..., N)`` rows (the
    last bucket zero-padded), in their dtype."""
    if hop == 1:
        return x2
    n = x2.shape[-1]
    t = -(-n // hop)
    return torch.nn.functional.pad(x2, (0, t * hop - n)).reshape(
        x2.shape[:-1] + (t, hop)).sum(dim=-1)


def stats_from_buckets(xb, t, sample_rate, thresholds_db, ratios,
                       attacks_ms, releases_ms, hop, ctrl_tail=None,
                       look_ctrl=0, valid_ctrl=None, global_ctrl_pos0=None):
    """The detector from hop-bucketed squared-signal sums, band-major.

    ``xb``: ``(B·R, t)``, row ``b·R + i`` the bucket sums of band ``b`` of
    signal ``i`` (R signals: an album's tracks).  ``thresholds_db`` /
    ``ratios``: B values, each a scalar or R of them; ``attacks_ms`` /
    ``releases_ms``: B values.  ``ctrl_tail``: the previous chunk's last
    ``look_ctrl`` buckets ``(B·R, look_ctrl)``, or None at the start of
    the signal.  The windowed means are differences of a running sum
    (:func:`cumsum_mxu`) taken in float64: over ~1M control steps a
    float32 sum loses the short windows to cancellation.  The gain
    computer then runs in ``xb``'s dtype.  ``valid_ctrl``: the new tail
    ends after this many of the ``t`` steps (the rest is padding).
    ``global_ctrl_pos0``: the signal's first control step is this step of
    a longer one (a shard of a sequence-parallel track, whose ``ctrl_tail``
    is the previous shard's, zeros on the first): a window that starts
    before that longer signal's start averages over the samples it has
    (pydub's partial windows), as at the start of an unsharded signal.

    Returns ``(stats dict of (B·R, t) tensors, new_ctrl_tail (B·R,
    look_ctrl))``; the dict also holds the rows' rate factors ``ca``,
    ``cr`` ``(B·R,)``.
    """
    dt, dev = xb.dtype, xb.device
    bands = len(attacks_ms)
    sigs = xb.shape[0] // bands
    offset = 0
    ext = xb
    if ctrl_tail is not None:
        offset = ctrl_tail.shape[1]
        ext = torch.cat([ctrl_tail.to(dt), xb], dim=1)
    ext64 = ext.to(torch.float64).reshape(bands, sigs, -1)
    csum = torch.cat([torch.zeros((bands, sigs, 1), dtype=torch.float64,
                                  device=dev),
                      cumsum_mxu(ext64, axis=2)], dim=2)
    steps = torch.arange(t, dtype=torch.float64, device=dev) * hop

    ms_rows, att_f, rel_f = [], [], []
    for i in range(bands):
        look = max(0, int(attacks_ms[i] * sample_rate / 1000.0))
        look_eff = look if hop == 1 else max(hop, -(-look // hop) * hop)
        wb = min(look if hop == 1 else look_eff // hop, t + offset)
        hi = csum[i, :, offset:offset + t]
        if offset >= wb:
            lo = csum[i, :, offset - wb:offset - wb + t]
            cnt = float(max(look_eff, 1))
            if global_ctrl_pos0 is not None:
                cnt = (steps + global_ctrl_pos0 * hop).clamp(
                    1, max(look_eff, 1))
        else:
            lo = torch.cat([torch.zeros((sigs, wb), dtype=hi.dtype,
                                        device=dev), hi[:, :t - wb]], dim=1)
            cnt = steps.clamp(1, max(look_eff, 1))
        ms_rows.append((hi - lo) / cnt)
        att_f += [_frames(attacks_ms[i], sample_rate)] * sigs
        rel_f += [_frames(releases_ms[i], sample_rate)] * sigs
    ms = torch.cat(ms_rows).to(dt)
    stats = gain_computer_stats_bt(ms, _rows_of(thresholds_db, sigs),
                                   _rows_of(ratios, sigs), att_f, rel_f, hop)
    stats["ca"] = upload([hop / f for f in att_f], dt, dev)
    stats["cr"] = upload([hop / f for f in rel_f], dt, dev)
    if look_ctrl > 0:
        if valid_ctrl is not None:
            ext = ext[:, :offset + valid_ctrl]
        pad = max(0, look_ctrl - ext.shape[1])
        new_tail = torch.nn.functional.pad(ext, (pad, 0))[:, -look_ctrl:]
    else:
        new_tail = ext[:, :0]
    return stats, new_tail


def _rows_of(values, sigs):
    """Per-band values (each a scalar or ``sigs`` of them) as the
    ``B·sigs`` band-major rows' values (row ``b·sigs + i``)."""
    return [float(v) for band in values
            for v in np.broadcast_to(np.asarray(band, np.float64), (sigs,))]


def _band_rows(x):
    """``(N, C)`` or ``(N,)`` → the channel-mean squared signal ``(N,)``."""
    x = x[:, None] if x.ndim == 1 else x
    return (x * x).mean(dim=1)


def detector_stats_bands(bands, sample_rate, thresholds_db, ratios,
                         attacks_ms, releases_ms, hop=1):
    """Per-control-step ballistics inputs of B band signals (JAX
    ``detector_stats_bands``): ``bands`` is ``(B, N, C)`` or a sequence of
    B ``(N, C)`` tensors.  Returns the stats dict of ``(T, B)`` tensors
    (``attenuation_scan``'s layout; ``ca``/``cr`` ``(B,)``)."""
    rows = torch.stack([_band_rows(b) for b in bands])        # (B, N)
    xb = bucket_sums(rows, hop)
    stats, _ = stats_from_buckets(xb, xb.shape[1], sample_rate,
                                  thresholds_db, ratios, attacks_ms,
                                  releases_ms, hop)
    return {k: (v if k in ("ca", "cr") else v.T) for k, v in stats.items()}


def detector_stats(x, sample_rate, threshold_db, ratio, attack_ms,
                   release_ms, hop=1):
    """One band's stats dict of ``(T,)`` tensors (JAX ``detector_stats``;
    ``ca``/``cr`` 0-d)."""
    st = detector_stats_bands([x], sample_rate, (threshold_db,), (ratio,),
                              (attack_ms,), (release_ms,), hop=hop)
    return {k: v[..., 0] for k, v in st.items()}


def attenuation_scan(stats, att0=None):
    """Exact sequential ballistics over stacked control stats.

    ``stats`` values are ``(T, ...)``; trailing dims (a bands axis) ride
    along in the carry.  A step-by-step Python loop: an oracle for tests,
    not a hot path.  Returns ``(att (T, ...), att_final)``.
    """
    m, above = stats["max_att"], stats["above"]
    inc, dec = stats["inc"], stats["dec"]
    att = (torch.zeros(m.shape[1:], dtype=m.dtype) if att0 is None
           else torch.as_tensor(att0, dtype=m.dtype))
    out = torch.empty_like(m)
    for i in range(m.shape[0]):
        attack = torch.minimum(att + inc[i], m[i])
        release = torch.clamp_min(att - dec[i], 0.0)
        att = torch.where(above[i] & (att <= m[i]), attack, release)
        out[i] = att
    return out, att


def _as_bt(stats, att0):
    """A ``(T, ...)`` stats dict as band-major ``(B, T)`` targets with
    ``(B,)`` rates and incoming state, and the trailing shape."""
    m = stats["max_att"]
    trailing = m.shape[1:]
    t = m.shape[0]
    m_bt = m.reshape(t, -1).T.contiguous()
    b = m_bt.shape[0]

    def vec(v):
        return torch.as_tensor(v, dtype=m.dtype, device=m.device).reshape(
            -1).expand(b).contiguous()

    a0 = None if att0 is None else vec(att0)
    return m_bt, vec(stats["ca"]), vec(stats["cr"]), a0, trailing


def _from_bt(att, att_f, trailing):
    t = att.shape[1]
    return att.T.reshape((t,) + trailing), att_f.reshape(trailing)


def attenuation_exact(stats, att0=None, mode: str = "serial"):
    """Exact ballistics of a ``(T, ...)`` stats dict on the kernels
    (``ops.ballistics.ballistics_rates_bt``; the ``"scan"`` execution).
    Returns ``(att (T, ...), att_final)``."""
    m, ca, cr, a0, trailing = _as_bt(stats, att0)
    att, att_f = ballistics_rates_bt(m, ca, cr, a0, mode=mode)
    return _from_bt(att, att_f, trailing)


def _coarse_bt(m, ca, cr, factor, att0):
    """The coarse pre-scan of band-major targets: exact ballistics on
    every ``factor``-th step with the rates times ``factor``.  Returns
    ``(att_c (B, ceil(T/factor)), att_final)``."""
    return ballistics_rates_bt(m[:, ::factor], ca * factor, cr * factor,
                               att0, mode="serial")


def attenuation_coarse(stats, factor, att0=None):
    """Exact-at-freeze coarse estimate (JAX ``attenuation_coarse``): the
    ballistics on every ``factor``-th control step with rates scaled by
    ``factor``, sampled back onto the full grid ``(T, ...)``.  pydub's
    below-threshold freeze is exact at any rate, so this tracks the long
    memory the blocked pass's warm-up cannot."""
    m, ca, cr, a0, trailing = _as_bt(stats, att0)
    att_c, final = _coarse_bt(m, ca, cr, factor, a0)
    idx = torch.arange(m.shape[1], device=m.device) // factor
    return _from_bt(att_c[:, idx], final, trailing)


def attenuation_blocked_bt(m, ca, cr, block_ctrl, overlap_ctrl, att0=None,
                           coarse_factor=COARSE_FACTOR):
    """Block-parallel ballistics of band-major ``(B, T)`` targets (the JAX
    package's ``attenuation_blocked``) on the exact kernels.

    The timeline is cut into ``nb`` blocks of ``block_ctrl`` steps; each
    block is replayed over its ``overlap_ctrl`` steps of pre-context and
    its own steps, starting from the coarse pre-scan's value where the
    pre-context begins (block 0 from ``att0``).  Pre-context before the
    signal and padding after it have zero targets, which freeze the state,
    as the JAX windows' zero fill does.  The ``B·nb`` windows are the rows
    of one ``(B·nb, overlap + block)`` timeline with per-row rates and
    incoming states, run by ``ballistics_rates_bt`` in serial mode (K5,
    K6).  Returns ``(att (B, T), att_final (B,))``.
    """
    b, t = m.shape
    dt, dev = m.dtype, m.device
    nb = -(-t // block_ctrl)
    a0 = torch.zeros((b,), dtype=dt, device=dev) if att0 is None else att0
    if coarse_factor and t > coarse_factor:
        att_c, _ = _coarse_bt(m, ca, cr, coarse_factor, a0)
        warm = torch.clamp_min(
            torch.arange(nb, device=dev) * block_ctrl - overlap_ctrl, 0)
        att0s = att_c[:, warm // coarse_factor].clone()
        att0s[:, 0] = a0
    else:
        att0s = a0[:, None].expand(b, nb)
    span = overlap_ctrl + block_ctrl
    mp = torch.nn.functional.pad(m, (overlap_ctrl, nb * block_ctrl - t))
    windows = mp.unfold(1, span, block_ctrl).reshape(b * nb, span)
    att, _ = ballistics_rates_bt(
        windows, ca.repeat_interleave(nb), cr.repeat_interleave(nb),
        att0s.reshape(b * nb).contiguous(), mode="serial")
    att = att[:, overlap_ctrl:].reshape(b, nb * block_ctrl)[:, :t]
    return att, att[:, -1]


def attenuation_blocked(stats, block_ctrl, overlap_ctrl, att0=None,
                        coarse_factor=COARSE_FACTOR):
    """:func:`attenuation_blocked_bt` of a ``(T, ...)`` stats dict."""
    m, ca, cr, a0, trailing = _as_bt(stats, att0)
    att, att_f = attenuation_blocked_bt(m, ca, cr, block_ctrl, overlap_ctrl,
                                        a0, coarse_factor)
    return _from_bt(att, att_f, trailing)


def _default_overlap(sample_rate, release_ms, hop):
    """≥ 4 release time constants of context wipe out the warm-up error."""
    return max(64, int(4 * release_ms * sample_rate / 1000.0 / hop))


def compressor_gain_db(x, sample_rate, threshold_db, ratio, attack_ms,
                       release_ms, hop=1, block_ctrl=None,
                       overlap_ctrl=None):
    """Full-rate attenuation (dB ≥ 0) of one band ``(N, C)`` or ``(N,)``:
    ``(N,)``.  Exact ballistics, or the blocked ones with ``block_ctrl``."""
    stats = detector_stats(x, sample_rate, threshold_db, ratio, attack_ms,
                           release_ms, hop=hop)
    if block_ctrl is None:
        att, _ = attenuation_exact(stats)
    else:
        if overlap_ctrl is None:
            overlap_ctrl = _default_overlap(sample_rate, release_ms, hop)
        att, _ = attenuation_blocked(stats, block_ctrl, overlap_ctrl)
    n = x.shape[0]
    if hop > 1:
        att = att.repeat_interleave(hop)[:n]
    return att


def compress_dynamic_range(x, sample_rate, threshold=-20.0, ratio=4.0,
                           attack=5.0, release=50.0, hop=1,
                           block_ctrl=None, overlap_ctrl=None):
    """pydub-contract compressor on float audio ``(N, C)`` or ``(N,)``."""
    att = compressor_gain_db(x, sample_rate, threshold, ratio, attack,
                             release, hop=hop, block_ctrl=block_ctrl,
                             overlap_ctrl=overlap_ctrl)
    gain = 10.0 ** (-att / 20.0)
    if x.ndim == 2:
        gain = gain[:, None]
    return x * gain
