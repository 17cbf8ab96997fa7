"""EBU R128 / BS.1770-4 meters: momentary, short-term, LRA and true peak.

Counterpart of ``python_audio_mastering_tpu.ops.meters``:

* momentary (400 ms) and short-term (3 s) loudness series, one value per
  100 ms step, from the same K-weighted cell energies the integrated meter
  gates, measured by ``loudness.block_cell_energies`` (the
  ``kweight_cells`` kernel on a CUDA tensor, its plain version on the
  CPU);
* loudness range (EBU Tech 3342): the 10th → 95th percentile spread of
  the short-term series after a −70 LUFS absolute and a −20 LU relative
  gate;
* true peak (BS.1770-4 Annex 2): 4× polyphase FIR interpolation.

The interpolator is one matrix product instead of the JAX package's 4 × 32
shifted multiply-adds: each product row of :data:`_ROW` outputs reads a
window of ``_ROW + 31`` input samples against a banded
``(_ROW + 31, 4 · _ROW)`` operator of the four phases' taps, so the windows
copy the signal ~1.5 times and no convolution (cuDNN, TF32 by default) is
involved.  Like every float32 product of the port on the card it needs
TF32 matmuls off, which the entry points check (``models.chain``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from python_audio_mastering_tpu_torch.ops.loudness import (
    _LOUDNESS_OFFSET,
    block_cell_energies,
    channel_weights,
)

__all__ = ["momentary_loudness", "shortterm_loudness", "loudness_range",
           "lra_from_shortterm", "true_peak_db", "true_peak_linear"]

_ROW = 64           # interpolator outputs per product row


def _sliding_loudness(cell_ms, cells_per_window, weights=None):
    """Loudness of every ``cells_per_window``-cell window of ``(cells, C)``
    energies, one per cell step.  The running sum is taken in float64."""
    n_cells, c = cell_ms.shape
    dt, dev = cell_ms.dtype, cell_ms.device
    if weights is None:
        weights = channel_weights(c, dtype=dt, device=dev)
    if n_cells < cells_per_window:
        return torch.full((0,), float("nan"), dtype=dt, device=dev)
    csum = F.pad(torch.cumsum(cell_ms.to(torch.float64), dim=0), (0, 0, 1, 0))
    win = ((csum[cells_per_window:] - csum[:-cells_per_window])
           / cells_per_window).to(dt)
    eps = float(np.finfo(np.float32).tiny)
    return _LOUDNESS_OFFSET + 10.0 * torch.log10(
        torch.clamp_min(win @ weights, eps))


def _cells(x, sample_rate, downmix):
    """100 ms K-weighted cell energies ``(N // cell, C)`` of ``(N, C)`` or
    ``(N,)`` audio, through the rows meter."""
    x = torch.as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    if downmix == "reference_mono_mean":
        x = x.mean(dim=1, keepdim=True)
    return block_cell_energies(x, sample_rate)[0]


def momentary_loudness(x, sample_rate, downmix="bs1770"):
    """400 ms momentary loudness series (one value per 100 ms step)."""
    return _sliding_loudness(_cells(x, sample_rate, downmix), 4)


def shortterm_loudness(x, sample_rate, downmix="bs1770"):
    """3 s short-term loudness series (one value per 100 ms step)."""
    return _sliding_loudness(_cells(x, sample_rate, downmix), 30)


def loudness_range(x, sample_rate):
    """EBU R128 loudness range (LU), from gated short-term percentiles."""
    return lra_from_shortterm(shortterm_loudness(x, sample_rate))


def lra_from_shortterm(st):
    """LRA from a short-term loudness series (the streamed runner's comes
    from its accumulated 100 ms cells, no second pass over the signal).
    Masked percentiles by sorting, gated-out entries pushed to +inf."""
    if st.shape[0] == 0:
        return torch.tensor(float("nan"))
    abs_mask = st > -70.0
    n_abs = abs_mask.sum()
    mean_power = (torch.where(abs_mask, 10.0 ** (st / 10.0), 0.0).sum()
                  / torch.clamp_min(n_abs, 1))
    rel_gate = 10.0 * torch.log10(torch.clamp_min(mean_power, 1e-30)) - 20.0
    mask = abs_mask & (st >= rel_gate)
    svals = torch.sort(torch.where(mask, st, float("inf"))).values
    cnt = mask.sum()

    def pct(p):
        idx = (p * (cnt - 1).to(torch.float64)).to(torch.int64)
        return svals[torch.clamp(idx, 0, st.shape[0] - 1)]

    lra = pct(0.95) - pct(0.10)
    return torch.where(cnt > 1, lra, torch.zeros_like(lra))


@functools.lru_cache(maxsize=8)
def _oversample_taps(factor=4, taps_per_phase=32):
    """Kaiser-windowed-sinc polyphase interpolator, float64 ``(factor ·
    taps_per_phase,)``: longer and flatter than the BS.1770 Annex 2 example
    filter."""
    n = factor * taps_per_phase
    t = (np.arange(n) - (n - 1) / 2.0) / factor
    h = np.sinc(t) * np.kaiser(n, 9.0)
    return (h * factor / h.sum()).astype(np.float64)


@functools.lru_cache(maxsize=8)
def _interp_operator(factor):
    """The banded operator ``(_ROW + k − 1, _ROW · factor)``: column
    ``q · factor + p`` holds phase ``p``'s taps reversed from row ``q``."""
    phases = _oversample_taps(factor).reshape(-1, factor).T   # (factor, k)
    k = phases.shape[1]
    a = np.zeros((_ROW + k - 1, _ROW, factor))
    for q in range(_ROW):
        a[q:q + k, q, :] = phases[:, ::-1].T
    return a.reshape(_ROW + k - 1, _ROW * factor)


@functools.lru_cache(maxsize=16)
def _interp_operator_on(factor, dtype, device):
    return torch.as_tensor(_interp_operator(factor), dtype=dtype,
                           device=device)


def _interpolate(x, factor, pad):
    """The interpolator's phase outputs over ``(N, C)`` audio zero-padded
    by ``pad`` samples at each end: ``(C, J, factor)`` with ``J = N +
    2·pad − k + 1`` and ``out[c, j, p] = Σ_i h[i·factor + p] · xp[j + k − 1
    − i]`` (``k`` taps a phase), the JAX package's shifted sums."""
    op = _interp_operator_on(factor, x.dtype, x.device)
    width = op.shape[0]
    k = width - _ROW + 1
    n, c = x.shape
    j = n + 2 * pad - k + 1
    rows = -(-j // _ROW)
    xp = F.pad(x.T, (pad, pad + rows * _ROW - j))    # rows·_ROW + k − 1
    out = xp.unfold(-1, width, _ROW) @ op             # (C, rows, _ROW·factor)
    return out.reshape(c, rows * _ROW, factor)[:, :j]


def true_peak_linear(x, sample_rate=None, factor: int = 4,
                     exclude_pad=(False, False)):
    """Max inter-sample (true) peak magnitude, linear scale, a 0-d tensor.

    ``sample_rate`` is accepted for API symmetry (the estimate does not
    depend on it).  ``exclude_pad=(head, tail)``: where a side is True,
    interpolation windows that touch that side's zero padding are left out
    of the max (the sample peak still covers every sample): the streamed
    meter evaluates those positions again with their real neighbours in
    the adjacent chunk (``parallel.streaming._tp_chunk``).
    """
    x = torch.as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    k = _oversample_taps(factor).shape[0] // factor   # taps a phase = pad
    acc = _interpolate(x, factor, pad=k)     # (C, n + k + 1, factor)
    # acc[j] reads xp[j .. j+k-1]: j < k touches the head pad, j >= n + 1
    # the tail pad
    lo = k if exclude_pad[0] else 0
    hi = (n + 1) if exclude_pad[1] else acc.shape[1]
    return torch.maximum(acc[:, lo:hi].abs().amax(), x.abs().amax())


def true_peak_db(x, sample_rate=None, factor: int = 4):
    """True peak in dBTP."""
    tp = true_peak_linear(x, sample_rate, factor)
    return 20.0 * torch.log10(torch.clamp_min(tp, 1e-12))
