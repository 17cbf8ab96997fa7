"""3-band multiband compressor over the rows form, both split variants.

Counterpart of ``python_audio_mastering_tpu.ops.multiband``.  Crossovers
at 250 Hz / 4 kHz are 4th-order Butterworth filters designed on the host
in float64; ``low = LP4(x)``, ``high = HP4(x)``, and the mid band is

* ``"worker"``: ``mid = x − low − high`` (the subtraction split);
* ``"legacy"``: ``mid = LP4_4k(HP4_250(x))``, a real band (the legacy
  chain of the monolith service, reference main.py:165-168).

Each band runs pydub's compressor with the reference's fixed ballistics
(low 10/200 ms, mid 5/150 ms, high 1/50 ms attack/release).

The worker data path, in order:

1. crossover states: ``iir.sosfilt_states_multi_rows`` (plain torch,
   float64) — every block's incoming state of both filters;
2. ``band_energies`` (kernel K2) — the bands recomputed per block from
   those states, squared, channel-averaged, bucketed to the control rate;
3. the detector (plain torch, ``compressor.stats_from_buckets``):
   windowed means from a float64 running sum, then the dB gain computer;
4. the ballistics (:func:`_run_ballistics_bt`, kernels K5–K7);
5. ``band_gain_apply`` (kernel K3) — the bands recomputed again, the
   control-rate gains repeated to the sample rate, recombined as
   ``y = x·g_mid + low·(g_low − g_mid) + high·(g_high − g_mid)`` (plus the
   loudness meter's mono downmix).

The band signals never reach memory.  The legacy split has no kernel of
its own (the JAX package runs it outside any Pallas kernel): its three
bands are blocked filters in plain torch (one float64 states pass for
all three, the mid band's two filters as one 4-section cascade, then
``rows @ T + s_in @ Wᵀ`` in float32), its detector the same as the
worker's over their squared channel means, the ballistics the same
kernels, and ``y = low·g_low + mid·g_mid + high·g_high``.

On the exact filter path (``scan``: the JAX package's row-major body with
its scanned crossovers) the bands are the scan kernel K8's output
(``ops.sos_scan``; one launch for the low and high pass, and the legacy
mid band's 4-section cascade in the same launch), materialised; the
detector is the same, from their squared channel means in plain torch,
the ballistics the same kernels, and the gain apply plain torch.

A ``hop`` that does not divide ``L``: ``band_energies`` runs at hop 1
(per-sample channel-mean energies) and the buckets are summed after it
by the JAX rows body's pad and reshape; the control-rate gains are
repeated to the sample rate and ``band_gain_apply`` runs at hop 1.

On a CUDA tensor the kernels launch; on a CPU tensor their plain versions
run.  :func:`multiband_compress` and :func:`crossover_split` take
``(N, C)`` audio.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops._kernels import (
    check_channel_major_arg,
    check_kernel_arg,
)
from python_audio_mastering_tpu_torch.ops.ballistics import ballistics_rates_bt
from python_audio_mastering_tpu_torch.ops.biquad import butter_sos
from python_audio_mastering_tpu_torch.ops.compressor import (
    _default_overlap,
    attenuation_blocked_bt,
    bucket_sums,
    stats_from_buckets,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import (
    band_energies,
    band_gain_apply,
)
from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan

__all__ = ["multiband_compress_rows", "multiband_compress", "crossover_split",
           "detector_stats_fused",
           "BAND_BALLISTICS_MS", "BALLISTICS", "VARIANTS", "detector_lookpad",
           "crossover_ops", "ctrl_tail_from_tail"]

# (attack_ms, release_ms) per band, fixed in the reference.
BAND_BALLISTICS_MS = ((10.0, 200.0), (5.0, 150.0), (1.0, 50.0))
BALLISTICS = ("auto", "pallas", "scan", "blocked")
VARIANTS = ("worker", "legacy")


@functools.lru_cache(maxsize=None)
def _crossover_sos(sample_rate, low_crossover, high_crossover):
    lp = butter_sos(4, low_crossover, "lowpass", fs=sample_rate)
    hp = butter_sos(4, high_crossover, "highpass", fs=sample_rate)
    return np.asarray(lp), np.asarray(hp)


@functools.lru_cache(maxsize=None)
def _mid_sos(sample_rate, low_crossover, high_crossover):
    """The legacy mid band's two filters, ``HP4 @ low`` then ``LP4 @
    high``, as one 4-section cascade: its state is the two filters'
    states stacked (scipy layout), ``mid_hp`` then ``mid_lp``."""
    return np.concatenate([
        butter_sos(4, low_crossover, "highpass", fs=sample_rate),
        butter_sos(4, high_crossover, "lowpass", fs=sample_rate)])


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
                  low_crossover=250.0, high_crossover=4000.0,
                  variant="worker", dtype=torch.float32):
    """The crossovers' :func:`iir.blocked_ops` on ``device``, for callers
    that keep them between calls: ``(lp, hp)``, and the legacy mid
    cascade's third."""
    sos = _crossover_sos(sample_rate, low_crossover, high_crossover)
    if variant == "legacy":
        sos = sos + (_mid_sos(sample_rate, low_crossover, high_crossover),)
    return tuple(iir.blocked_ops(s, block_size, device, dtype) for s in sos)


def ctrl_tail_from_tail(tail, hop):
    """The control-rate detector tail ``(3, look_pad // hop)`` (the port's
    carried state) of the JAX general path's sample-rate tail ``(3,
    look_pad, C)``: hop-bucket sums of the channel-mean squared bands."""
    tail = torch.as_tensor(tail)
    return bucket_sums((tail * tail).mean(dim=2), hop)


def _fused_stats_from_ctrl(xb, t, sample_rate, thresholds_db, ratios, hop,
                           ctrl_tail, look_ctrl, valid_ctrl=None,
                           global_ctrl_pos0=None):
    """The multiband detector from hop-bucketed band energies ``(3·T, t)``
    (row ``b·T + i``: band ``b`` of track ``i``), with the reference's band
    ballistics (``compressor.stats_from_buckets``; ``global_ctrl_pos0``:
    a shard's first control step in its track)."""
    return stats_from_buckets(
        xb, t, sample_rate, thresholds_db, ratios,
        tuple(a for a, _ in BAND_BALLISTICS_MS),
        tuple(r for _, r in BAND_BALLISTICS_MS), hop, ctrl_tail, look_ctrl,
        valid_ctrl, global_ctrl_pos0)


def detector_stats_fused(x, low, high, sample_rate, thresholds_db, ratios,
                         hop=1, ctrl_tail=None, channel_major=False):
    """The worker split's detector from ``(N, C)`` audio and its low and
    high bands (``(C, N)`` with ``channel_major``), ``mid = x − low −
    high`` formed only inside the squared energies, the state carried at
    the control rate: ``ctrl_tail`` ``(3, look_ctrl)`` is the previous
    chunk's last hop-bucket sums per band.  Returns ``(stats dict of (t,
    3) tensors: max_att, above, inc, dec; new_ctrl_tail (3,
    look_ctrl))``."""
    time_ax = 1 if channel_major else 0
    rows = [(b * b).mean(dim=1 - time_ax) for b in (low, x - low - high,
                                                      high)]
    xb = bucket_sums(torch.stack(rows), hop)
    stats, tail = _fused_stats_from_ctrl(
        xb, xb.shape[1], sample_rate, thresholds_db, ratios, hop,
        ctrl_tail, detector_lookpad(sample_rate, hop) // hop)
    return ({k: stats[k].T for k in ("max_att", "above", "inc", "dec")},
            tail)


def _run_ballistics_bt(stacked_bt, sample_rate, hop, ballistics, att0,
                       block_ctrl=None, overlap_ctrl=None):
    """Band-major ``(3·T, t)`` ballistics (T tracks, row ``b·T + i``),
    every row its own timeline, all in one run, dispatched as the JAX
    package's ``_run_ballistics``:

    * ``"auto"``, ``"pallas"`` → exact, collapse mode (K7, K5, K6);
    * ``"scan"`` → exact, serial mode (K5, K6): the same bits;
    * ``"blocked"`` → the block-parallel approximation on K5 and K6
      (``compressor.attenuation_blocked_bt``), or exact serial when no
      ``block_ctrl`` is set.

    Returns ``(att (3·T, t), att_final (3·T,))``.
    """
    if ballistics not in BALLISTICS:
        raise ValueError(f"unknown comp_ballistics {ballistics!r}: one of "
                         f"{BALLISTICS}")
    m, ca, cr = stacked_bt["max_att"], stacked_bt["ca"], stacked_bt["cr"]
    if att0 is not None:
        att0 = torch.as_tensor(att0, dtype=m.dtype, device=m.device)
    if ballistics in ("auto", "pallas"):
        return ballistics_rates_bt(m, ca, cr, att0, mode="collapse")
    if ballistics == "blocked" and block_ctrl is not None:
        if overlap_ctrl is None:
            overlap_ctrl = _default_overlap(sample_rate, 200.0, hop)
        return attenuation_blocked_bt(m, ca, cr, block_ctrl, overlap_ctrl,
                                      att0)
    return ballistics_rates_bt(m, ca, cr, att0, mode="serial")


def _legacy_bands(x4, zi, ops, return_state, n_valid):
    """The legacy split of ``(C, T, nb, L)`` rows: ``(low, mid, high)``
    rows and the final states ``{lp, hp, mid_hp, mid_lp}``."""
    c, tracks, nb, L = x4.shape
    rows = x4.reshape(c * tracks, nb, L)
    mid_zi = None
    if zi.get("mid_hp") is not None:
        mid_zi = torch.cat([torch.as_tensor(zi["mid_hp"]),
                            torch.as_tensor(zi["mid_lp"])])
    s_ins, (z_lp, z_hp, z_mid) = iir.sosfilt_states_multi_rows(
        None, rows, (zi.get("lp"), zi.get("hp"), mid_zi),
        return_state=return_state, ops_list=ops, n_valid=n_valid)
    low, high, mid = (iir.recompute_rows(rows, s, o).reshape(x4.shape)
                      for s, o in zip(s_ins, ops))
    zf = {"lp": z_lp, "hp": z_hp}
    if z_mid is not None:
        k = ops[0].k
        zf.update(mid_hp=z_mid[:k], mid_lp=z_mid[k:])
    return (low, mid, high), zf


def _scan_bands(x4, zi, sample_rate, low_crossover, high_crossover,
                variant, n_valid):
    """The crossover bands of ``(C, T, nb, L)`` rows by the scan kernel,
    every filter in one launch over the ``C·T`` runs of ``nb·L`` samples:
    ``((low, mid, high) each (C, T, nb·L), zf)``, the worker's mid ``x −
    low − high``, the legacy one ``LP4(HP4(x))`` (one 4-section cascade,
    the same operations as the two filters in turn)."""
    c, tracks, nb, L = x4.shape
    cols = x4.reshape(c * tracks, nb * L)
    sos = list(_crossover_sos(sample_rate, low_crossover, high_crossover))
    zis = [zi.get("lp"), zi.get("hp")]
    if variant == "legacy":
        sos.append(_mid_sos(sample_rate, low_crossover, high_crossover))
        zis.append(None if zi.get("mid_hp") is None else torch.cat(
            [torch.as_tensor(zi["mid_hp"]), torch.as_tensor(zi["mid_lp"])]))
    ys, zfs = sos_scan(cols, sos, zis, n_valid=n_valid)
    shape = (c, tracks, nb * L)
    low, high = ys[0].reshape(shape), ys[1].reshape(shape)
    zf = {"lp": zfs[0], "hp": zfs[1]}
    if variant == "legacy":
        mid = ys[2].reshape(shape)
        k = sos[0].shape[0]
        zf.update(mid_hp=zfs[2][:k], mid_lp=zfs[2][k:])
    else:
        mid = cols.reshape(shape) - low - high
    return (low, mid, high), zf


def _upsample(gains, tracks, t, hop, n):
    """Control-rate ``(3, T·t)`` gains repeated ``hop`` times, cut to the
    ``n`` samples of each track: ``(3, T, n)``."""
    return gains.reshape(3, tracks, t).repeat_interleave(hop, dim=2)[
        :, :, :n]


def multiband_compress_rows(xrows, sample_rate, thresholds_db, ratios,
                            low_crossover=250.0, high_crossover=4000.0,
                            hop=1, block_ctrl=None, overlap_ctrl=None,
                            ballistics="auto", state=None,
                            return_state=False, kernel="auto",
                            emit_mono=False, ops=None, variant="worker",
                            valid_frames=None, scan=False):
    """3-band compressor over rows ``(C, nb, L)``, or over an album's
    ``(C, T, nb, L)``: T tracks, each its own signal with its own
    sliders, state and detector, in one launch of each kernel.

    The band kernels compute every block from that block and its incoming
    states alone, and their buckets lie inside a block, so the tracks fold
    into their block axis (``(C, T·nb, L)``, channel pairs intact); the
    states pass runs the ``C·T`` signals as independent sequences, and the
    detector and the ballistics take the ``3·T`` band-major rows.

    Args:
      thresholds_db / ratios: length-3 (low, mid, high), each value a
        scalar or, for an album, T of them.
      hop: control decimation of the detector (the band kernels take it
        where it divides ``L``, else run at hop 1, see the module
        docstring).
      ballistics: one of :data:`BALLISTICS` (see :func:`_run_ballistics_bt`);
        ``block_ctrl`` / ``overlap_ctrl`` set the blocked execution.
      kernel: the JAX package's switch, ``"auto"`` only (the device picks
        the route).
      state: the carried state of the previous chunk (None at the start):
        ``{"crossover": {"lp", "hp"} (+ "mid_hp", "mid_lp" for the legacy
        split), "att", "ctrl_tail"}``: zi ``(K, 2, C·T)``, ``att (3·T,)``,
        ``ctrl_tail (3·T, look)``.
      emit_mono: also return the output's channel mean ``(nb, L)``
        (``(T, nb, L)`` for an album).
      ops: the crossovers' blocked operators (:func:`crossover_ops` of the
        variant), looked up when not given.
      variant: ``"worker"`` or ``"legacy"`` (the split).
      valid_frames: the samples of each track before its zero padding; the
        returned state is the one after them (all samples when None).
      scan: the exact crossovers (the scan kernel, see the module
        docstring) instead of the band kernels.

    Returns ``y``, then ``mono`` with ``emit_mono``, then the new state
    with ``return_state``.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    check_kernel_arg(kernel)
    x4 = xrows if xrows.ndim == 4 else xrows[:, None]
    c, tracks, nb, L = x4.shape
    n = nb * L
    state = state or {}
    zi = state.get("crossover") or {}
    # the band kernels' buckets: hop where it divides L, else 1
    k_hop = hop if L % hop == 0 else 1
    valid_ctrl = None if valid_frames is None else -(-int(valid_frames)
                                                     // hop)
    if scan:
        bands, zf = _scan_bands(x4, zi, sample_rate, low_crossover,
                                high_crossover, variant, valid_frames)
        xb = bucket_sums(torch.stack([(b * b).mean(dim=0) for b in bands]),
                         hop)
    elif variant == "legacy":
        if ops is None:
            ops = crossover_ops(sample_rate, L, x4.device, low_crossover,
                                high_crossover, variant, x4.dtype)
        bands, zf = _legacy_bands(x4, zi, ops, return_state, valid_frames)
        xb = bucket_sums(torch.stack([(b * b).mean(dim=0).reshape(tracks, n)
                                      for b in bands]), hop)
    else:
        if ops is None:
            ops = crossover_ops(sample_rate, L, x4.device, low_crossover,
                                high_crossover, variant, x4.dtype)
        lp_sos, hp_sos = _crossover_sos(sample_rate, low_crossover,
                                        high_crossover)
        (s_in_lp, s_in_hp), (z_lp, z_hp) = iir.sosfilt_states_multi_rows(
            (lp_sos, hp_sos), x4.reshape(c * tracks, nb, L),
            (zi.get("lp"), zi.get("hp")), n_valid=valid_frames,
            return_state=return_state, ops_list=ops)
        zf = {"lp": z_lp, "hp": z_hp}
        rows = x4.reshape(c, tracks * nb, L)
        s_in_lp, s_in_hp = (s.reshape(c, tracks * nb, -1)
                            for s in (s_in_lp, s_in_hp))
        xb = band_energies(rows, s_in_lp, s_in_hp, lp_sos, hp_sos,
                           hop=k_hop).reshape(3, tracks, -1)
        if k_hop != hop:
            xb = bucket_sums(xb, hop)
    t = xb.shape[-1]
    look_ctrl = detector_lookpad(sample_rate, hop) // hop
    stacked, new_ctrl_tail = _fused_stats_from_ctrl(
        xb.reshape(3 * tracks, t), t, sample_rate, thresholds_db, ratios,
        hop, state.get("ctrl_tail"), look_ctrl, valid_ctrl)
    att, att_f = _run_ballistics_bt(stacked, sample_rate, hop, ballistics,
                                    state.get("att"), block_ctrl,
                                    overlap_ctrl)
    if valid_ctrl is not None:
        att_f = att[:, valid_ctrl - 1]
    gains = (10.0 ** (-att / 20.0)).reshape(3, tracks * t)  # control rate
    ym = None
    if scan or variant == "legacy":
        low, mid, high = (b.reshape(c, tracks, n) for b in bands)
        g = _upsample(gains, tracks, t, hop, n)
        if variant == "legacy":
            y = low * g[0] + mid * g[1] + high * g[2]
        else:
            x3 = x4.reshape(c, tracks, n)
            y = x3 * g[1] + low * (g[0] - g[1]) + high * (g[2] - g[1])
        if emit_mono:
            ym = y.mean(dim=0).reshape(x4.shape[1:])
    else:
        cols = torch.stack([gains[1], gains[0] - gains[1],
                            gains[2] - gains[1]])
        if k_hop != hop:
            cols = _upsample(cols, tracks, t, hop, n).reshape(3, tracks * n)
        y = band_gain_apply(rows, s_in_lp, s_in_hp, cols.contiguous(), lp_sos,
                            hp_sos, hop=k_hop, emit_mono=emit_mono)
        if emit_mono:
            y, ym = y
            ym = ym.reshape(x4.shape[1:])
    y = y.reshape(xrows.shape)
    out = (y,)
    if emit_mono:
        out += (ym if xrows.ndim == 4 else ym[0],)
    if return_state:
        out += ({"crossover": zf, "att": att_f, "ctrl_tail": new_ctrl_tail},)
    return out if len(out) > 1 else out[0]


def _audio(x):
    squeeze = x.ndim == 1
    return (x[:, None] if squeeze else x), squeeze


def multiband_compress(x, sample_rate, thresholds_db, ratios,
                       variant="worker", low_crossover=250.0,
                       high_crossover=4000.0, filter_method="auto", hop=1,
                       block_ctrl=None, overlap_ctrl=None, state=None,
                       return_state=False, ballistics="auto",
                       channel_major=False):
    """The 3-band compressor of ``(N, C)`` or ``(N,)`` audio (the JAX
    package's ``multiband_compress``), through the rows body
    (:func:`multiband_compress_rows`) at blocks of 384 samples.

    ``filter_method``: the crossovers take the exact scan where JAX's do
    (``"scan"``, or ``"auto"`` below ``4 · 512`` frames).
    ``state``: the carried ``{"crossover", "att", "ctrl_tail"}`` of a
    previous chunk, or the JAX general path's ``{"crossover", "att",
    "tail"}`` (its sample-rate tail becomes the control-rate one).
    ``channel_major``: JAX's ``(C, N)`` input, not ported (only False).
    Returns ``y``, or ``(y, new_state)`` with ``return_state`` (the state
    after exactly N samples; a chunk that goes on should hold whole
    control steps).
    """
    check_channel_major_arg(channel_major)
    x2, squeeze = _audio(x)
    n = x2.shape[0]
    if state is not None and state.get("tail") is not None:
        state = {**state, "ctrl_tail": ctrl_tail_from_tail(
            state["tail"], hop).to(device=x2.device, dtype=x2.dtype)}
        del state["tail"]
    out = multiband_compress_rows(
        iir.to_rows(x2), sample_rate, thresholds_db, ratios,
        low_crossover, high_crossover, hop=hop, block_ctrl=block_ctrl,
        overlap_ctrl=overlap_ctrl, ballistics=ballistics, state=state,
        return_state=return_state, variant=variant, valid_frames=n,
        scan=iir.uses_scan(filter_method, n, iir.DEFAULT_BLOCK))
    y, st = out if return_state else (out, None)
    y = iir.from_rows(y, n)
    y = y[:, 0] if squeeze else y
    return (y, st) if return_state else y


def crossover_split(x, sample_rate, variant="worker", low_crossover=250.0,
                    high_crossover=4000.0, filter_method="auto", zi=None):
    """Split ``(N, C)`` audio into ``(low, mid, high)`` stacked as ``(3, N,
    C)`` (the JAX package's ``crossover_split``), through the rows form,
    or through the scan kernel where ``filter_method`` picks the scan
    (``"scan"``, or ``"auto"`` below ``4 · 512`` frames).  ``zi``: the
    carried crossover states.  Returns ``(bands, zf)``, ``zf`` after
    exactly N samples."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    x2, _ = _audio(x)
    n = x2.shape[0]
    x4 = iir.to_rows(x2)[:, None]
    zi = zi or {}
    if iir.uses_scan(filter_method, n, iir.DEFAULT_BLOCK):
        bands, zf = _scan_bands(x4, zi, sample_rate, low_crossover,
                                high_crossover, variant, n)
        return torch.stack([b[:, 0, :n].T for b in bands]), zf
    ops = crossover_ops(sample_rate, iir.NC_BLOCK, x2.device, low_crossover,
                        high_crossover, variant, x2.dtype)
    if variant == "legacy":
        bands, zf = _legacy_bands(x4, zi, ops, True, n)
    else:
        rows = x4[:, 0]
        s_ins, (z_lp, z_hp) = iir.sosfilt_states_multi_rows(
            None, rows, (zi.get("lp"), zi.get("hp")), ops_list=ops,
            n_valid=n)
        low, high = (iir.recompute_rows(rows, s, o)
                     for s, o in zip(s_ins, ops))
        bands = (low, rows - low - high, high)
        zf = {"lp": z_lp, "hp": z_hp}
    return torch.stack([iir.from_rows(b.reshape(x4.shape[0], -1, iir.NC_BLOCK), n)
                        for b in bands]), zf
