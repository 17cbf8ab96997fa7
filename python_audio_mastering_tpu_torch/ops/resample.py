"""Rational polyphase sample-rate conversion.

Counterpart of ``python_audio_mastering_tpu.ops.resample``:

* the taps are ``scipy.signal.resample_poly``'s default design (a
  Kaiser-windowed sinc, β = 5, cutoff ``1/max(up, down)``, unit DC gain,
  scaled by ``up``), built in float64 on the host and cached;
* the ``up`` phase filters form one bank ``G (up, W)`` and every output
  superframe ``m`` reads the same input window ``x[m·down + v_lo : … +
  W]``, so the conversion is one matrix product of the strided windows
  (``unfold`` with step ``down``) with ``Gᵀ``: no sample of the up-sampled
  grid exists, and no convolution (cuDNN, TF32 by default) is involved.
  On the card it is a float32 product, which needs TF32 matmuls off, as
  the entry points check (``models.chain``).  Where ``down < W`` the
  windows overlap and the product copies them (``W/down`` times the
  signal);
* the output has scipy's length ``ceil(N·up/down)`` and its phase
  alignment; :func:`resample` reduces the ratio by the gcd (44.1 k → 48 k
  runs as up 160 / down 147).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["design_resample_taps", "resample_poly", "resample"]


@functools.lru_cache(maxsize=64)
def design_resample_taps(up: int, down: int, half_len_mult: int = 10,
                         beta: float = 5.0):
    """Kaiser-windowed sinc anti-aliasing taps for an up/down converter:
    ``2·10·max(up, down) + 1`` taps, float64 numpy."""
    if up < 1 or down < 1:
        raise ValueError("up/down must be positive integers")
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = half_len_mult * max_rate
    n = 2 * half_len + 1
    k = np.arange(n) - half_len
    h = f_c * np.sinc(f_c * k) * np.kaiser(n, beta)
    h /= h.sum()
    return h * up


@functools.lru_cache(maxsize=64)
def _polyphase_bank(taps_bytes: bytes, k_len: int, up: int, down: int):
    """Phase-filter bank ``G (up, W)`` and input offset ``v_lo``: row ``r``
    holds ``h[r·down + half − up·v]`` over the window of ``v`` every phase
    shares (zero outside the row's own support)."""
    h = np.frombuffer(taps_bytes, dtype=np.float64)
    half = (k_len - 1) // 2
    bases = np.arange(up) * down + half
    v_lo = int(np.ceil((bases - k_len + 1) / up).min())
    v_hi = int((bases // up).max())
    w_len = v_hi - v_lo + 1
    g = np.zeros((up, w_len))
    for r in range(up):
        idx = bases[r] - up * (v_lo + np.arange(w_len))
        valid = (idx >= 0) & (idx < k_len)
        g[r, valid] = h[idx[valid]]
    return g, v_lo


@functools.lru_cache(maxsize=16)
def _bank_on(taps_bytes: bytes, k_len: int, up: int, down: int, dtype,
             device):
    """``(Gᵀ (W, up) on device, v_lo)``."""
    g, v_lo = _polyphase_bank(taps_bytes, k_len, up, down)
    return torch.as_tensor(g.T.copy(), dtype=dtype, device=device), v_lo


def resample_poly(x, up: int, down: int, taps=None):
    """Polyphase resampling of ``(N,)`` or ``(N, C)`` audio by ``up/down``.

    ``x``: a tensor (or array) on the device to run on.  ``taps``: an
    optional odd-length centred FIR already scaled by ``up``; by default
    :func:`design_resample_taps`.  Returns ``ceil(N·up/down)`` frames, or
    ``x`` itself when ``up == down``.
    """
    up, down = int(up), int(down)
    if up == down:
        return x
    x = torch.as_tensor(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, c = x.shape
    h = (design_resample_taps(up, down) if taps is None
         else np.asarray(taps, np.float64))
    if h.shape[0] % 2 != 1:
        raise ValueError("taps must have odd length (centered FIR)")
    gt, v_lo = _bank_on(h.tobytes(), h.shape[0], up, down, x.dtype, x.device)
    w_len = gt.shape[0]
    n_out = -(-n * up // down)
    m = -(-n_out // up)   # output superframes of `up` samples each
    # xp[i] = x[i + v_lo]; superframe m reads xp[m·down : m·down + W]
    pad_l = max(0, -v_lo)
    pad_r = max(0, (m - 1) * down + v_lo + w_len - n)
    xp = F.pad(x.T, (pad_l, pad_r))                    # (C, Np)
    y = xp.unfold(-1, w_len, down)[:, :m] @ gt         # (C, m, up)
    y = y.permute(1, 2, 0).reshape(m * up, c)[:n_out]
    return y[:, 0] if squeeze else y


def resample(x, sr_in: int, sr_out: int, taps=None):
    """Resample audio from ``sr_in`` to ``sr_out`` Hz (the ratio reduced by
    the gcd: 44100 → 48000 runs as up=160, down=147)."""
    sr_in, sr_out = int(sr_in), int(sr_out)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError("sample rates must be positive")
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g, taps=taps)
