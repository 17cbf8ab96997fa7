"""The compressor's control-rate math, plain torch.

Counterpart of the parts of ``python_audio_mastering_tpu.ops.compressor``
that the multiband chain reaches (the pydub ``compress_dynamic_range``
contract; see the JAX module's docstring):

* :func:`cumsum_mxu` — the detector's running sum as a two-stage
  partition (a within-block triangular product plus an exclusive carry of
  block totals);
* :func:`gain_computer_stats_bt` — dB-domain gain computer over band-major
  ``(B, T)`` mean-square envelopes;
* :func:`attenuation_scan` — the exact sequential ballistics as a Python
  loop, the oracle the kernels' driver (``ops.ballistics``) is tested
  against.
"""

from __future__ import annotations

import torch

from python_audio_mastering_tpu_torch.ops._kernels import upload

__all__ = ["cumsum_mxu", "gain_computer_stats_bt", "attenuation_scan"]


def cumsum_mxu(x, dim=-1, block=512):
    """Inclusive cumsum along ``dim`` as a two-stage partition: a
    ``(nb, block) @ triu(ones)`` product within blocks of ``block``
    elements, then an exclusive carry of the block totals.  Short inputs
    (at most ``2 · block``) take ``torch.cumsum``.  Runs in ``x``'s dtype
    (the detector passes float64)."""
    dim = dim % x.ndim
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
