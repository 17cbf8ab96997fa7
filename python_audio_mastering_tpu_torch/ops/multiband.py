"""3-band multiband compressor over the rows form (the worker split).

Counterpart of the rows path of ``python_audio_mastering_tpu.ops.
multiband`` (``multiband_compress_rows`` through its fused-kernel body
``_multiband_rows_pallas``).  Crossovers at 250 Hz / 4 kHz are 4th-order
Butterworth filters designed on the host in float64;
``low = LP4(x)``, ``high = HP4(x)``, ``mid = x − low − high``.  Each band
runs pydub's compressor with the reference's fixed ballistics (low
10/200 ms, mid 5/150 ms, high 1/50 ms attack/release), and the bands sum
back as ``y = x·g_mid + low·(g_low − g_mid) + high·(g_high − g_mid)``.

The data path, in order:

1. crossover states: ``iir.sosfilt_states_multi_rows`` (plain torch,
   float64) — every block's incoming state of both filters;
2. ``band_energies`` (kernel K2) — the bands recomputed per block from
   those states, squared, channel-averaged, bucketed to the control rate;
3. the detector (plain torch, :func:`_fused_stats_from_ctrl`): windowed
   means from a float64 running sum, then the dB gain computer;
4. the exact ballistics (``ops.ballistics``, kernels K5–K7);
5. ``band_gain_apply`` (kernel K3) — the bands recomputed again, the
   control-rate gains repeated to the sample rate, recombined (plus the
   loudness meter's mono downmix).

The band signals never reach memory.  On a CUDA tensor the kernels
launch; on a CPU tensor their plain versions run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops.ballistics import ballistics_rates_bt
from python_audio_mastering_tpu_torch.ops.biquad import butter_sos
from python_audio_mastering_tpu_torch.ops.compressor import (
    cumsum_mxu,
    gain_computer_stats_bt,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import (
    band_energies,
    band_gain_apply,
)

__all__ = ["multiband_compress_rows", "BAND_BALLISTICS_MS",
           "detector_lookpad", "crossover_ops"]

# (attack_ms, release_ms) per band, fixed in the reference.
BAND_BALLISTICS_MS = ((10.0, 200.0), (5.0, 150.0), (1.0, 50.0))


@functools.lru_cache(maxsize=None)
def _crossover_sos(sample_rate, low_crossover, high_crossover):
    lp = butter_sos(4, low_crossover, "lowpass", fs=sample_rate)
    hp = butter_sos(4, high_crossover, "highpass", fs=sample_rate)
    return np.asarray(lp), np.asarray(hp)


@functools.lru_cache(maxsize=None)
def _bucket_matrix(blk, hop):
    """(blk, blk//hop) 0/1 matrix: column k sums lanes [k·hop, (k+1)·hop)."""
    s = np.zeros((blk, blk // hop), np.float32)
    for k in range(blk // hop):
        s[hop * k:hop * (k + 1), k] = 1.0
    return s


def detector_lookpad(sample_rate, hop=1):
    """Carried detector-tail length: max band lookback, rounded up to hop."""
    look_max = max(int(a * sample_rate / 1000.0) for a, _ in BAND_BALLISTICS_MS)
    return -(-look_max // hop) * hop


def crossover_ops(sample_rate, block_size, device="cpu",
                  low_crossover=250.0, high_crossover=4000.0):
    """The crossover pair's :func:`iir.blocked_ops` ``(lp, hp)`` on
    ``device``, for callers that keep them between calls."""
    return tuple(iir.blocked_ops(s, block_size, device)
                 for s in _crossover_sos(sample_rate, low_crossover,
                                         high_crossover))


def _band_rows(values, tracks):
    """Per-band values (each a scalar or ``tracks`` of them) as the
    ``3·tracks`` band-major rows' values (row ``b·tracks + i``)."""
    return [float(v) for band in values
            for v in np.broadcast_to(np.asarray(band, np.float64), (tracks,))]


def _fused_stats_from_ctrl(xb, t, sample_rate, thresholds_db, ratios, hop,
                           ctrl_tail, look_ctrl):
    """The detector from hop-bucketed band energies, band-major.

    ``xb``: ``(3, t)`` hop-bucket x² sums per band (low, mid, high), or
    ``(3·T, t)`` for an album of T tracks (row ``b·T + i``: band ``b`` of
    track ``i``).  ``thresholds_db``/``ratios``: three values, each a
    scalar or T of them.  ``ctrl_tail``: the previous chunk's last
    ``look_ctrl`` buckets ``(3·T, look_ctrl)``, or None at the start of the
    signal.  The windowed means are differences of a running sum
    (:func:`cumsum_mxu`) taken in float64: over ~1M control steps a
    float32 sum loses the short windows to cancellation.  The gain
    computer then runs in ``xb``'s dtype.

    Returns ``(stats dict of (3·T, t) tensors, new_ctrl_tail (3·T,
    look_ctrl))``.
    """
    attacks = tuple(a for a, _ in BAND_BALLISTICS_MS)
    releases = tuple(r for _, r in BAND_BALLISTICS_MS)
    dt, dev = xb.dtype, xb.device
    tracks = xb.shape[0] // 3
    offset = 0
    ext = xb
    if ctrl_tail is not None:
        offset = ctrl_tail.shape[1]
        ext = torch.cat([ctrl_tail.to(dt), xb], dim=1)
    ext64 = ext.to(torch.float64).reshape(3, tracks, -1)
    csum = torch.cat([torch.zeros((3, tracks, 1), dtype=torch.float64,
                                  device=dev),
                      cumsum_mxu(ext64, dim=2)], dim=2)
    steps = torch.arange(t, dtype=torch.float64, device=dev) * hop

    ms_rows, att_f, rel_f = [], [], []
    for i in range(3):
        look = max(0, int(attacks[i] * sample_rate / 1000.0))
        look_eff = look if hop == 1 else max(hop, -(-look // hop) * hop)
        wb = min(look if hop == 1 else look_eff // hop, t + offset)
        hi = csum[i, :, offset:offset + t]
        if offset >= wb:
            lo = csum[i, :, offset - wb:offset - wb + t]
            cnt = float(max(look_eff, 1))
        else:
            lo = torch.cat([torch.zeros((tracks, wb), dtype=hi.dtype,
                                        device=dev), hi[:, :t - wb]], dim=1)
            cnt = steps.clamp(1, max(look_eff, 1))
        ms_rows.append((hi - lo) / cnt)
        att_f += [max(attacks[i] * sample_rate / 1000.0, 1.0)] * tracks
        rel_f += [max(releases[i] * sample_rate / 1000.0, 1.0)] * tracks
    ms = torch.cat(ms_rows).to(dt)
    stats = gain_computer_stats_bt(ms, _band_rows(thresholds_db, tracks),
                                   _band_rows(ratios, tracks), att_f, rel_f,
                                   hop)
    if look_ctrl > 0:
        pad = max(0, look_ctrl - ext.shape[1])
        new_tail = torch.nn.functional.pad(ext, (pad, 0))[:, -look_ctrl:]
    else:
        new_tail = ext[:, :0]
    return stats, new_tail


def _run_ballistics_bt(stacked_bt, sample_rate, hop, ballistics, att0):
    """Band-major ``(3·T, t)`` ballistics (T tracks, row ``b·T + i``): the
    exact kernel route, every row its own timeline, all in one run.

    ``"auto"`` runs ``ops.ballistics`` on every device; the approximate
    ``"blocked"`` and the ``"scan"`` executions are not ported.  Returns
    ``(att (3·T, t), att_final (3·T,))``.
    """
    if ballistics != "auto":
        raise NotImplementedError(
            f"comp_ballistics={ballistics!r}: the port runs the exact "
            "kernel route ('auto'); the blocked and scan ballistics are "
            "ROADMAP queue 1 item 4")
    m = stacked_bt["max_att"]
    tracks = m.shape[0] // 3
    ca = [hop / max(a * sample_rate / 1000.0, 1.0)
          for a, _ in BAND_BALLISTICS_MS for _ in range(tracks)]
    cr = [hop / max(r * sample_rate / 1000.0, 1.0)
          for _, r in BAND_BALLISTICS_MS for _ in range(tracks)]
    return ballistics_rates_bt(m, ca, cr, att0)


def multiband_compress_rows(xrows, sample_rate, thresholds_db, ratios,
                            low_crossover=250.0, high_crossover=4000.0,
                            hop=1, ballistics="auto", state=None,
                            return_state=False, emit_mono=False, ops=None):
    """Worker-variant 3-band compressor over rows ``(C, nb, L)``, or over
    an album's ``(C, T, nb, L)``: T tracks, each its own signal with its
    own sliders, state and detector, in one launch of each kernel.

    The band kernels compute every block from that block and its incoming
    states alone, and their buckets lie inside a block, so the tracks fold
    into their block axis (``(C, T·nb, L)``, channel pairs intact); the
    states pass runs the ``C·T`` signals as independent sequences, and the
    detector and the ballistics take the ``3·T`` band-major rows.

    Args:
      thresholds_db / ratios: length-3 (low, mid, high), each value a
        scalar or, for an album, T of them.
      hop: control decimation of the detector (a divisor of ``L``).
      ballistics: ``"auto"`` (exact; see :func:`_run_ballistics_bt`).
      state: the carried ``{"crossover": {"lp", "hp"}, "att",
        "ctrl_tail"}`` of the previous chunk (None at the start): zi
        ``(K, 2, C·T)``, ``att (3·T,)``, ``ctrl_tail (3·T, look)``.
      emit_mono: also return the output's channel mean ``(nb, L)``
        (``(T, nb, L)`` for an album).
      ops: the crossover pair's blocked operators (:func:`crossover_ops`),
        looked up when not given.

    Returns ``y``, then ``mono`` with ``emit_mono``, then the new state
    with ``return_state``.
    """
    x4 = xrows if xrows.ndim == 4 else xrows[:, None]
    c, tracks, nb, L = x4.shape
    state = state or {}
    lp_sos, hp_sos = _crossover_sos(sample_rate, low_crossover,
                                    high_crossover)
    zi = state.get("crossover") or {}
    (s_in_lp, s_in_hp), (z_lp, z_hp) = iir.sosfilt_states_multi_rows(
        (lp_sos, hp_sos), x4.reshape(c * tracks, nb, L),
        (zi.get("lp"), zi.get("hp")), return_state=return_state,
        ops_list=ops)
    rows = x4.reshape(c, tracks * nb, L)
    s_in_lp, s_in_hp = (s.reshape(c, tracks * nb, -1)
                        for s in (s_in_lp, s_in_hp))
    xb = band_energies(rows, s_in_lp, s_in_hp, lp_sos, hp_sos, hop=hop)
    t = xb.shape[1] // tracks
    look_ctrl = detector_lookpad(sample_rate, hop) // hop
    stacked, new_ctrl_tail = _fused_stats_from_ctrl(
        xb.reshape(3 * tracks, t), t, sample_rate, thresholds_db, ratios,
        hop, state.get("ctrl_tail"), look_ctrl)
    att, att_f = _run_ballistics_bt(stacked, sample_rate, hop, ballistics,
                                    state.get("att"))
    gains = (10.0 ** (-att / 20.0)).reshape(3, tracks * t)  # control rate
    cols = torch.stack([gains[1], gains[0] - gains[1], gains[2] - gains[1]])
    y = band_gain_apply(rows, s_in_lp, s_in_hp, cols.contiguous(), lp_sos,
                        hp_sos, hop=hop, emit_mono=emit_mono)
    if emit_mono:
        y = (y[0].reshape(xrows.shape),
             y[1].reshape(x4.shape[1:]) if xrows.ndim == 4 else y[1])
    else:
        y = y.reshape(xrows.shape)
    out = y if emit_mono else (y,)
    if return_state:
        st = {"crossover": {"lp": z_lp, "hp": z_hp}, "att": att_f,
              "ctrl_tail": new_ctrl_tail}
        out = (*out, st)
    return out if len(out) > 1 else out[0]
