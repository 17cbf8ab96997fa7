"""Sequence parallelism: one long track sharded over the ranks of a mesh.

Counterpart of ``python_audio_mastering_tpu.parallel.sequence``.  The
waveform is cut into D equal shards along the mesh's ``seq`` axis, one a
rank (``parallel.mesh``: a process driving one device).  Every rank calls
the entry point with the same audio and params (SPMD), uploads only its
own frames, runs the chain on its shard with every carried state replaced
by a cross-shard summary, and returns the full result:

* IIR cascades (EQ, crossovers, K-weighting): each shard's zero-state end
  state is all-gathered (a few hundred bytes) and folded through the
  float64 shard transition ``A^n`` into its true incoming state
  (:func:`_rows_shard_states`, ``ops.iir.sosfilt_sharded``), exact;
* the detector takes the previous shard's control-rate tail and counts
  its partial windows from the shard's global position, exact;
* the ballistics (``sp_ballistics``): ``"approx"`` warm-starts each shard
  from a coarse pre-scan of the gathered, decimated targets (every 64th
  step, rates ×64), then runs the shard: exact from that warm start on the
  card (K5–K7), the block-parallel approximation on the CPU, as the JAX
  package runs its exact Pallas kernel on a TPU and its blocked scan
  elsewhere; ``"exact"`` walks the shards in turn, each from the
  previous one's final attenuation (D rounds), exact;
* loudness cells are gathered and gated globally; the gain is replicated;
* the lookahead limiter exchanges halos and composes its release across
  shards (:func:`_sharded_lookahead`), exact.

Two bodies, chosen as the JAX package chooses them.  The worker chain with
the reference limiter takes the rows body (:func:`_chain_shard_rows`),
the one-shot rows chain with its kernels: ``front_chain`` (K1),
``band_energies`` (K2), the ballistics (K5–K7), ``band_gain_apply`` (K3)
and ``kweight_cells`` (K4), fed with shard-corrected states.  The legacy
variant and the lookahead limiter take the row-major body
(:func:`_chain_shard`), which reproduces the JAX package's: the worker
EQ cascade after the variant's saturation and the worker crossovers
(``mid = x − low − high``) for both variants, filtered by
``ops.iir.sosfilt_sharded``.  For the legacy variant that is an
approximation of the one-shot legacy chain (ROADMAP queue 3).

An album (:func:`master_album_sharded`) runs on a 2-D (tracks × frames)
mesh: each rank takes the shards of its group of tracks, folded into the
kernels' block axis as the album runner folds them, so K2–K7 launch once
a rank for all its tracks and K1 once per group of equal front settings.

One card shared by D ranks (the launcher's gloo route) shows that the
kernels and the cross-shard algebra are right and what the machinery
costs; it cannot show a speed-up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import (
    MasteringChain,
    check_fp32_matmul,
    check_supported,
    eq_sos,
    require_device,
)
from python_audio_mastering_tpu_torch.ops import meters as met
from python_audio_mastering_tpu_torch.ops._kernels import upload
from python_audio_mastering_tpu_torch.ops.ballistics import ballistics_rates_bt
from python_audio_mastering_tpu_torch.ops.compressor import (
    COARSE_FACTOR,
    _default_overlap,
    attenuation_blocked_bt,
    bucket_sums,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import (
    band_energies,
    band_gain_apply,
)
from python_audio_mastering_tpu_torch.ops.iir import (
    _a_pow,
    _affine_prefix_static,
    _fold_shard_states,
    sosfilt_sharded,
    state_to_zi,
)
from python_audio_mastering_tpu_torch.ops.limiter import (
    _peak_env,
    _release_scan,
    _rho,
    _tp_khalf,
    _windowed_min_forward,
)
from python_audio_mastering_tpu_torch.ops.loudness import (
    block_cell_energies_rows,
    gain_for_target,
    kweight_sos,
    loudness_from_cells,
)
from python_audio_mastering_tpu_torch.ops.multiband import (
    _crossover_sos,
    _fused_stats_from_ctrl,
    detector_lookpad,
)
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    exciter,
    exciter_coefs,
    saturate,
    saturate_legacy,
    soft_limiter,
    soft_limiter_legacy,
)
from python_audio_mastering_tpu_torch.parallel.batch import (
    pad_tracks,
    stack_params,
)
from python_audio_mastering_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    mesh_device,
)

__all__ = ["master_track_sharded", "master_album_sharded"]

SP_BALLISTICS = ("approx", "exact")


def _rows_body(config: ChainConfig) -> bool:
    """The rows body runs the worker chain with the reference limiter."""
    return config.variant == "worker" and config.limiter_mode == "reference"


def _align(config: ChainConfig, shards: int, rows: bool) -> int:
    """The padded length's multiple: whole cells and control steps (and
    blocks, for the rows body) in every one of ``shards`` shards."""
    cell = int(round(0.1 * config.sample_rate))
    a = np.lcm(cell, max(config.comp_hop, 1))
    return int(np.lcm(a, config.block_size if rows else 1)) * shards


def _sliders(tracks_params, *names):
    return tuple([float(getattr(p, k)) for p in tracks_params] for k in names)


# ---------------------------------------------------------------------------
# Cross-shard states, detector and ballistics
# ---------------------------------------------------------------------------


def _rows_shard_states(mesh, axis, ops_list, xrows, block_states=True):
    """True incoming states of F cascades over a blocks-sharded rows
    signal ``(C', nb, L)`` (C' sequences: channels × local tracks).

    One float64 ``rows @ [G_1 | … | G_F]`` read gives every filter's block
    summaries; the zero-state boundary prefix gives each sequence's end
    state, which is all-gathered (one collective for all F filters) and
    folded through ``A^{nb·L}`` into the shard's incoming state; the
    prefix then runs again from it.  The coefficients are static (the
    port's sliders are numbers here: the JAX package's traced-coefficient
    branch, for in-graph EQs, has no caller in the port).

    Returns ``(s_ins, zis)``: per filter the per-block states ``(C', nb,
    S)`` in the signal's dtype (None unless ``block_states``) and the
    shard's incoming scipy-layout state ``(K, 2, C')`` in float64.
    """
    c, nb, L = xrows.shape
    rows64 = xrows.reshape(c * nb, L).to(torch.float64)
    tv_cat = rows64 @ torch.cat([o.g for o in ops_list], dim=1)
    t_vecs, ends, col = [], [], 0
    for ops in ops_list:
        s_dim = ops.g.shape[1]
        t_vec = tv_cat[:, col:col + s_dim].reshape(c, nb, s_dim)
        col += s_dim
        s_loc = _affine_prefix_static(t_vec, t_vec.new_zeros((c, s_dim)),
                                      ops.al64, cache=ops.prefix)
        t_vecs.append(t_vec)
        ends.append(s_loc[:, -1] @ ops.al.T + t_vec[:, -1])
    t_all = mesh.all_gather(torch.cat(ends, dim=1), axis)   # (D, C', ΣS)
    s_ins, zis, col = [], [], 0
    for ops, t_vec in zip(ops_list, t_vecs):
        s_dim = t_vec.shape[2]
        s_in, _ = _fold_shard_states(
            t_all[:, :, col:col + s_dim], mesh.index(axis),
            _a_pow(ops.al64, nb, xrows.device), t_vec.new_zeros((c, s_dim)))
        col += s_dim
        zis.append(state_to_zi(s_in.T, ops.k))
        s_ins.append(_affine_prefix_static(
            t_vec, s_in, ops.al64, cache=ops.prefix).to(xrows.dtype)
            .contiguous() if block_states else None)
    return s_ins, zis


def _sharded_detector(mesh, axis, xb, sample_rate, thresholds_db, ratios,
                      hop):
    """The multiband detector of a shard's band energies ``(3·T, t)``
    (hop-bucket sums, row ``b·T + i``): the previous shard's control-rate
    tail, and partial windows counted from the shard's global position,
    so that every shard's stats are the unsharded track's.  JAX's
    ``_sharded_detector`` (the row-major body's) takes the same windows
    and counts from a sample-rate running sum; the rows body's fused
    detector from bucket sums, as here for both bodies."""
    t = xb.shape[1]
    look_ctrl = detector_lookpad(sample_rate, hop) // hop
    tail = mesh.from_prev(xb[:, -look_ctrl:], axis)
    stats, _ = _fused_stats_from_ctrl(
        xb, t, sample_rate, thresholds_db, ratios, hop, tail, look_ctrl,
        global_ctrl_pos0=mesh.index(axis) * t)
    return stats


def _sharded_ballistics_exact(mesh, axis, stats):
    """The ballistics walked shard after shard: in round ``r`` shard ``r``
    runs the exact ballistics from the final attenuation of shard ``r −
    1``, which the round's all-gather hands forward.  After D rounds every
    shard holds the unsharded result; the walk itself is serial, as JAX's
    D rounds make it.  The exact execution is ``ballistics_rates_bt``:
    K5–K7 on the card, their plain twins (bitwise the serial walk) on the
    CPU."""
    m, ca, cr = stats["max_att"], stats["ca"], stats["cr"]
    idx = mesh.index(axis)
    att0 = final = m.new_zeros((m.shape[0],))
    att = None
    for r in range(mesh.size(axis)):
        if r == idx:
            att, final = ballistics_rates_bt(m, ca, cr, att0)
        finals = mesh.all_gather(final, axis)
        if idx == r + 1:
            att0 = finals[r].contiguous()
    return att


def _sharded_ballistics(mesh, axis, stats, block_ctrl, overlap_ctrl,
                        exact_per_shard, coarse=COARSE_FACTOR):
    """Coarse global pre-scan, then each shard from its warm start.

    The every-``coarse``-th targets of all shards are gathered and walked
    exactly with the rates times ``coarse`` (pydub's below-threshold
    freeze is exact at any rate); shard ``i`` starts from the coarse state
    before its first step.  ``exact_per_shard``: the shard runs the exact
    ballistics from there (K5–K7 on the card); otherwise the
    block-parallel approximation (``attenuation_blocked_bt``, on K5 and
    K6 on the card).  Returns ``att (B, t)``."""
    m, ca, cr = stats["max_att"], stats["ca"], stats["cr"]
    b, t = m.shape
    idx = mesh.index(axis)
    sub = mesh.all_gather(m[:, ::coarse].contiguous(), axis)  # (D, B, ts)
    att_c, _ = ballistics_rates_bt(sub.permute(1, 0, 2).reshape(b, -1),
                                   ca * coarse, cr * coarse)
    att0 = (m.new_zeros((b,)) if idx == 0
            else att_c[:, max(idx * (t // coarse) - 1, 0)].contiguous())
    if exact_per_shard:
        att, _ = ballistics_rates_bt(m, ca, cr, att0)
    else:
        att, _ = attenuation_blocked_bt(m, ca, cr, block_ctrl, overlap_ctrl,
                                        att0, coarse_factor=coarse)
    return att


def _ballistics(mesh, axis, stats, config, sp_ballistics, exact_per_shard):
    if sp_ballistics == "exact":
        return _sharded_ballistics_exact(mesh, axis, stats)
    fs, hop = config.sample_rate, config.comp_hop
    return _sharded_ballistics(
        mesh, axis, stats, config.comp_block_ctrl or 2048,
        config.comp_overlap_ctrl or _default_overlap(fs, 200.0, hop),
        exact_per_shard)


# ---------------------------------------------------------------------------
# Loudness, true peak, lookahead limiter
# ---------------------------------------------------------------------------


def _gated_gain(mesh, axis, cells, tracks_params, n_valid, sample_rate):
    """Gather the shards' cells ``(T, n_cells, C)`` into each track's
    ``(T, D·n_cells, C)``, gate them globally (each track masked to its
    valid cells) and derive the replicated gain.  Returns ``(all_cells,
    measured (T,), gain (T,), gain_db (T,))``."""
    tracks, n_cells, c = cells.shape
    all_cells = mesh.all_gather(cells, axis).permute(1, 0, 2, 3).reshape(
        tracks, -1, c)
    dt, dev = cells.dtype, cells.device
    if not tracks_params[0].lufs_enabled:
        return (all_cells, torch.full((tracks,), math.nan, dtype=dt,
                                      device=dev),
                torch.ones((tracks,), dtype=dt, device=dev),
                torch.zeros((tracks,), dtype=dt, device=dev))
    cell = int(round(0.1 * sample_rate))
    valid = upload([n // cell for n in n_valid], torch.int64, dev)
    mask = torch.arange(all_cells.shape[1], device=dev)[None] < valid[:, None]
    measured = loudness_from_cells(all_cells, cell_mask=mask)
    gain = gain_for_target(measured, upload(
        [float(p.lufs) for p in tracks_params], dt, dev))
    return all_cells, measured, gain, 20.0 * torch.log10(gain)


def _tp_sharded(mesh, axis, x, n_valid):
    """True peak of a frames-sharded ``(n_loc, C)`` finished signal: the
    samples past ``n_valid`` (alignment padding, which holds chain
    ring-out) zeroed, the previous shard's last 32 samples as the
    interpolator's left context, windows touching the zero padding left
    out except at the track's end (the streamed meter's rule), and the
    max over the shards."""
    idx, n_loc = mesh.index(axis), x.shape[0]
    gpos = idx * n_loc + torch.arange(n_loc, device=x.device)
    x_tp = torch.where(gpos[:, None] < n_valid, x, 0.0)
    ext = torch.cat([mesh.from_prev(x_tp[-32:], axis), x_tp])
    last = idx == mesh.size(axis) - 1
    tp = met.true_peak_linear(ext, exclude_pad=(True, not last))
    return mesh.pmax(tp.reshape(1), axis)[0]


def _sharded_lookahead(mesh, axis, x, n_valid, sample_rate, ceiling_db=-1.0,
                       lookahead_ms=1.5, release_ms=60.0, true_peak=True):
    """The lookahead true-peak limiter of a frames-sharded ``(n_loc, C)``
    signal, equal to ``ops.limiter.lookahead_limiter`` on the unpadded
    track (JAX ``_sharded_lookahead``).

    Every stage but the release has finite support: a backward halo of
    ``look + khalf`` and a forward halo of ``2·look + khalf`` samples
    cover the interpolator (±khalf), the erosion (±look) and the moving
    average (+look).  Zero halos at the track's edges are the one-shot's
    zero padding; the one-shot's end replication of the attack gain is
    emulated from the gain at ``n_valid − 1`` (one ``psum``).  The release
    ``g[i] = min(t[i], ρ·g[i−1] + 1 − ρ)`` is clamp-affine: a shard maps
    its incoming gain ``g`` to ``min(C, ρ^n·g + 1 − ρ^n)``, ``C`` its
    release from ``g = 1``; the shards' ``C`` are gathered and composed
    into each shard's incoming gain, all in float64.
    """
    idx, n_loc = mesh.index(axis), x.shape[0]
    dev = x.device
    f64 = torch.float64
    look = max(1, int(lookahead_ms * sample_rate / 1000.0))
    khalf = _tp_khalf(true_peak)
    back, fwd = look + khalf, 2 * look + khalf
    ext = torch.cat([mesh.from_prev(x[-back:], axis), x,
                     mesh.from_next(x[:fwd], axis)])
    peak = _peak_env(ext, true_peak)
    raw = torch.clamp(10.0 ** (ceiling_db / 20.0)
                      / torch.clamp_min(peak, 1e-9), max=1.0)
    # att[j] = min(raw[j − look .. j + look]), local j in [0, n_loc + look)
    att = _windowed_min_forward(raw[back - look:], 2 * look + 1)[
        :n_loc + look].to(f64)
    if look > 1:
        gpos = idx * n_loc + torch.arange(n_loc + look, device=dev)
        own = torch.arange(n_loc + look, device=dev) < n_loc
        att_last = mesh.psum(torch.where(
            (gpos == n_valid - 1) & own, att, 0.0).sum().reshape(1), axis)
        csum = torch.nn.functional.pad(
            torch.cumsum(torch.where(gpos < n_valid, att, 0.0), dim=0), (1, 0))
        win_sum = csum[look:n_loc + look] - csum[:n_loc]
        in_valid = torch.clamp(n_valid - gpos[:n_loc], 0, look).to(f64)
        att_gain = (win_sum + (look - in_valid) * att_last) / look
    else:
        att_gain = att[:n_loc]
    rho = _rho(sample_rate, release_ms)
    g_loc = _release_scan(att_gain, rho)             # from g = 1, float64
    caps = mesh.all_gather(g_loc[-1:], axis)[:, 0]
    rho_n = rho ** n_loc
    g_in = torch.ones((), dtype=f64, device=dev)
    for j in range(idx):
        g_in = torch.minimum(caps[j], rho_n * g_in + (1.0 - rho_n))
    decay = torch.exp(torch.arange(1, n_loc + 1, dtype=f64, device=dev)
                      * math.log(rho))
    gains = torch.minimum(g_loc, 1.0 - (1.0 - g_in) * decay)
    return x * gains.to(x.dtype)[:, None]


# ---------------------------------------------------------------------------
# The two shard bodies
# ---------------------------------------------------------------------------


def _front_rows(mesh, axis, chain, x4, tracks_params, emit):
    """saturate → EQ → width of ``(C, T, nb, L)`` shards:
    ``MasteringChain.front`` (one ``front_chain`` launch per group of equal
    front settings) from each group's shard-incoming EQ state, in place of
    a stream's carried one.  Returns ``(y, mono (T, nb, L) or None)``."""
    c, tracks, nb, L = x4.shape
    groups = chain.front_groups(tracks_params)
    zi = None
    for p, idx, ops in groups:
        sel = upload(idx, torch.int64, x4.device)
        xs = exciter(x4[:, sel], exciter_coefs(
            p.saturation, chain.config.variant, chain.config.torch_dtype()))
        _, (z,) = _rows_shard_states(mesh, axis, (ops,),
                                     xs.reshape(c * len(idx), nb, L),
                                     block_states=False)
        if zi is None:
            zi = z.new_zeros((ops.k, 2, c, tracks))
        zi[:, :, :, sel] = z.reshape(ops.k, 2, c, len(idx))
    out = chain.front(x4, tracks_params, state=zi.reshape(-1, 2, c * tracks),
                      emit_mono=emit, groups=groups)
    return out if emit else (out, None)


def _multiband_rows(mesh, axis, chain, x4, tracks_params, sp_ballistics,
                    emit):
    """The 3-band compressor of ``(C, T, nb, L)`` shards: crossover states
    shard-corrected into ``band_energies``, the detector across shards,
    the ballistics, then ``band_gain_apply``, each kernel one launch for
    every local track.  Returns ``(y, mono (T, nb, L) or None)``."""
    cfg = chain.config
    fs, hop = cfg.sample_rate, cfg.comp_hop
    c, tracks, nb, L = x4.shape
    lp_sos, hp_sos = _crossover_sos(fs, 250.0, 4000.0)
    s_lp, s_hp = _rows_shard_states(mesh, axis, chain.crossover_ops(),
                                    x4.reshape(c * tracks, nb, L))[0]
    rows = x4.reshape(c, tracks * nb, L)
    s_lp, s_hp = (s.reshape(c, tracks * nb, -1) for s in (s_lp, s_hp))
    xb = band_energies(rows, s_lp, s_hp, lp_sos, hp_sos, hop=hop)
    t = xb.shape[1] // tracks
    stats = _sharded_detector(
        mesh, axis, xb.reshape(3 * tracks, t), fs,
        _sliders(tracks_params, "low_thresh", "mid_thresh", "high_thresh"),
        _sliders(tracks_params, "low_ratio", "mid_ratio", "high_ratio"), hop)
    att = _ballistics(mesh, axis, stats, cfg, sp_ballistics,
                      exact_per_shard=x4.device.type == "cuda")
    gains = (10.0 ** (-att / 20.0)).reshape(3, tracks * t)
    cols = torch.stack([gains[1], gains[0] - gains[1], gains[2] - gains[1]])
    out = band_gain_apply(rows, s_lp, s_hp, cols.contiguous(), lp_sos,
                          hp_sos, hop=hop, emit_mono=emit)
    y, ym = out if emit else (out, None)
    return y.reshape(x4.shape), (None if ym is None
                                 else ym.reshape(tracks, nb, L))


def _chain_shard_rows(mesh, axis, chain, x4, tracks_params, n_valid,
                      sp_ballistics="approx", want_meters=False):
    """The rows body: ``(C, T, nb, L)`` shards of T tracks (their sliders
    ``tracks_params``, valid lengths ``n_valid``) through the one-shot rows
    chain with cross-shard states (see the module docstring).

    Returns ``(y (C, T, nb, L), measured (T,), gain_db (T,))``, then with
    ``want_meters`` the gathered cells scaled by gain² ``(T, cells, C')``
    and the true peak ``(T,)``.
    """
    cfg = chain.config
    c, tracks, nb, L = x4.shape
    p0 = tracks_params[0]
    need_cells = p0.lufs_enabled or want_meters
    mono = (need_cells and c > 1
            and cfg.measure_downmix == "reference_mono_mean")
    y, ym = _front_rows(mesh, axis, chain, x4, tracks_params,
                        mono and not p0.multiband)
    if p0.multiband:
        y, ym = _multiband_rows(mesh, axis, chain, y, tracks_params,
                                sp_ballistics, mono)
    measured = torch.full((tracks,), math.nan, dtype=y.dtype,
                          device=y.device)
    gain = torch.ones_like(measured)
    gain_db = torch.zeros_like(measured)
    all_cells = None
    if need_cells:
        meter = (ym[None] if ym is not None
                 else y.mean(dim=0, keepdim=True) if mono else y)
        cm = meter.shape[0]
        kw = chain.kweight_ops()
        _, (zi_k,) = _rows_shard_states(mesh, axis, (kw,),
                                        meter.reshape(cm * tracks, nb, L),
                                        block_states=False)
        cells, _, _ = block_cell_energies_rows(meter, cfg.sample_rate,
                                               zi=zi_k, ops=kw)
        all_cells, measured, gain, gain_db = _gated_gain(
            mesh, axis, cells, tracks_params, n_valid, cfg.sample_rate)
        if p0.lufs_enabled:
            y = y * gain[None, :, None, None]
    y = soft_limiter(y, threshold=cfg.limiter_threshold)
    if not want_meters:
        return y, measured, gain_db
    tp = torch.stack([_tp_sharded(mesh, axis, y[:, i].reshape(c, -1).T,
                                  n_valid[i]) for i in range(tracks)])
    return y, measured, gain_db, all_cells * (gain ** 2)[:, None, None], tp


def _chain_shard(mesh, axis, chain, x, params, n_valid,
                 sp_ballistics="approx", want_meters=False):
    """The row-major body (JAX ``_chain_shard``): one track's ``(n_loc, C)``
    shard, for the legacy variant and the lookahead limiter.  The variant's
    saturation, then the worker EQ cascade and, with multiband, the
    worker crossovers (``mid = x − low − high``), every filter through
    ``ops.iir.sosfilt_sharded``; the ballistics blocked in ``"approx"``
    on both devices, as in JAX.

    Returns ``(y, measured, gain_db)`` (0-d), then with ``want_meters``
    the gathered cells scaled by gain² ``(cells, C')`` and the true peak.
    """
    cfg = chain.config
    fs, hop = cfg.sample_rate, cfg.comp_hop
    n_loc = x.shape[0]

    def run(sos, sig):
        return sosfilt_sharded(sos, sig, mesh, axis,
                               block_size=cfg.block_size)[0]

    sat = saturate if cfg.variant == "worker" else saturate_legacy
    x = sat(x, params.saturation)
    x = stereo_width(run(eq_sos(params, fs).astype(cfg.dtype), x),
                     params.width)
    if params.multiband:
        lp_sos, hp_sos = _crossover_sos(fs, 250.0, 4000.0)
        low, high = run(lp_sos, x), run(hp_sos, x)
        bands = (low, x - low - high, high)
        xb = bucket_sums(torch.stack([(b * b).mean(dim=1) for b in bands]),
                         hop)
        stats = _sharded_detector(
            mesh, axis, xb, fs,
            _sliders([params], "low_thresh", "mid_thresh", "high_thresh"),
            _sliders([params], "low_ratio", "mid_ratio", "high_ratio"), hop)
        att = _ballistics(mesh, axis, stats, cfg, sp_ballistics,
                          exact_per_shard=False)
        gains = (10.0 ** (-att / 20.0)).repeat_interleave(hop, dim=1)[
            :, :n_loc]
        x = (bands[0] * gains[0, :, None] + bands[1] * gains[1, :, None]
             + bands[2] * gains[2, :, None])
    measured = torch.tensor(math.nan, dtype=x.dtype, device=x.device)
    gain = torch.ones_like(measured)
    gain_db = torch.zeros_like(measured)
    all_cells = None
    if params.lufs_enabled or want_meters:
        meter = (x.mean(dim=1, keepdim=True)
                 if cfg.measure_downmix == "reference_mono_mean" else x)
        kx = run(kweight_sos(fs), meter)
        cell = int(round(0.1 * fs))
        n_cells = n_loc // cell
        cells = (kx[:n_cells * cell] ** 2).reshape(n_cells, cell, -1).mean(
            dim=1)
        all_cells, m_t, g_t, gdb_t = _gated_gain(
            mesh, axis, cells[None], [params], [n_valid], fs)
        all_cells = all_cells[0]
        if params.lufs_enabled:
            measured, gain, gain_db = m_t[0], g_t[0], gdb_t[0]
            x = x * gain
    if cfg.limiter_mode == "lookahead_truepeak":
        x = _sharded_lookahead(mesh, axis, x, n_valid, fs)
    elif cfg.variant == "worker":
        x = soft_limiter(x, threshold=cfg.limiter_threshold)
    else:
        x = soft_limiter_legacy(x, threshold=cfg.limiter_threshold)
    if not want_meters:
        return x, measured, gain_db
    return (x, measured, gain_db, all_cells * gain ** 2,
            _tp_sharded(mesh, axis, x, n_valid))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _prepare(params, config, sp_ballistics, device, what):
    dev = require_device(device, what)
    check_supported(params, config)
    if sp_ballistics not in SP_BALLISTICS:
        raise ValueError(f"unknown sp_ballistics {sp_ballistics!r}: one of "
                         f"{SP_BALLISTICS}")
    return dev


def _meters_dict(cells, measured, gain_db, tp, n, cell):
    """The R128 meter family of ``master_streamed(return_meters=True)``
    from the gathered cells (scaled by gain²) and the true peak."""
    valid = cells[: n // cell]
    st = met._sliding_loudness(valid, 30)
    return {
        "momentary_lufs": met._sliding_loudness(valid, 4).cpu().numpy(),
        "short_term_lufs": st.cpu().numpy(),
        "lra_lu": float(met.lra_from_shortterm(st)),
        "true_peak_dbtp": float(20.0 * np.log10(max(float(tp), 1e-12))),
        "integrated_lufs": float(measured) + float(gain_db),
    }


def master_track_sharded(audio, params: MasteringParams, config: ChainConfig,
                         mesh=None, axis: str = "seq",
                         sp_ballistics: str = "approx",
                         return_meters: bool = False, device="cuda"):
    """Master one long track sharded over the ranks of ``mesh`` (a 1-D
    ``parallel.mesh.make_mesh(axis)`` over the default group when None).

    SPMD: every rank calls with the same ``audio`` ``(N, C)`` or ``(N,)``
    and params; each uploads only its shard and every rank returns the
    full result.  The track is zero-padded to a multiple of ``lcm(cell,
    hop[, block_size]) · D`` (the block size for the rows body), as in
    the JAX package.

    ``sp_ballistics``: ``"approx"`` (the default; the coarse warm start,
    then the shard run exactly on the card and block-parallel on the CPU)
    or ``"exact"`` (the shards walked in turn; exact at any config).
    ``return_meters``: also the R128 meter family of
    ``master_streamed(return_meters=True)``.  ``device``: the card (the
    mesh's) unless the caller passes ``device="cpu"``; raises when no card
    is there.

    Returns ``(audio_out numpy (N, C) or (N,), measured_lufs, gain_db)``,
    and the meters dict with ``return_meters``.
    """
    dev = _prepare(params, config, sp_ballistics, device,
                   "master_track_sharded")
    if mesh is None:
        mesh = make_mesh(axis)
    else:
        axis = mesh.axis_names[0]
    dev = mesh_device(dev, mesh)
    check_fp32_matmul(dev)
    d, idx = mesh.size(axis), mesh.index(axis)
    audio = np.asarray(audio)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[:, None]
    n, c = audio.shape
    rows = _rows_body(config)
    n_pad = -(-n // _align(config, d, rows)) * _align(config, d, rows)
    n_loc = n_pad // d
    mine = audio[idx * n_loc: (idx + 1) * n_loc]
    x = torch.nn.functional.pad(
        torch.as_tensor(np.ascontiguousarray(mine)).to(
            dev, config.torch_dtype()), (0, 0, 0, n_loc - mine.shape[0]))
    chain = MasteringChain(config).to(dev)
    if rows:
        L = config.block_size
        res = _chain_shard_rows(mesh, axis, chain,
                                x.T.contiguous().reshape(c, 1, n_loc // L, L),
                                [params],
                                [n], sp_ballistics, return_meters)
        y = res[0][:, 0].reshape(c, n_loc)
        res = (y.T,) + tuple(r[0] for r in res[1:])
    else:
        res = _chain_shard(mesh, axis, chain, x, params, n, sp_ballistics,
                           return_meters)
    out = mesh.all_gather(res[0], axis).reshape(n_pad, c)[:n].cpu().numpy()
    if squeeze:
        out = out[:, 0]
    measured, gain_db = float(res[1]), float(res[2])
    if not return_meters:
        return out, measured, gain_db
    cell = int(round(0.1 * config.sample_rate))
    return out, measured, gain_db, _meters_dict(res[3], measured, gain_db,
                                                res[4], n, cell)


def master_album_sharded(tracks, params, config: ChainConfig, mesh=None,
                         sp_ballistics: str = "approx", device="cuda"):
    """Album mastering on a 2-D (tracks × frames) mesh
    (``parallel.mesh.make_mesh_2d()`` when None): the tracks, padded to a
    multiple of the tracks axis with silent ones, are split into groups
    along it, and each group's tracks are sharded along ``seq``.  Each
    rank runs its group's shards at once (the rows body folds them into
    the kernels' block axis; the row-major body runs them in turn), and
    each track's loudness gates over its own length.

    ``params``: one ``MasteringParams`` or one per track (the multiband
    and LUFS switches shared).  SPMD as :func:`master_track_sharded`.
    Returns ``(list of (N_i, C) numpy arrays, measured_lufs (T,))``.
    """
    if isinstance(params, MasteringParams):
        params = [params] * len(tracks)
    params = stack_params(params)
    dev = _prepare(params[0], config, sp_ballistics, device,
                   "master_album_sharded")
    if mesh is None:
        mesh = make_mesh_2d()
    taxis, saxis = mesh.axis_names
    dt_m, ds_m = mesh.shape
    dev = mesh_device(dev, mesh)
    check_fp32_matmul(dev)
    batch, lengths = pad_tracks(tracks)
    t0, n, c = batch.shape
    t_pad = -(-t0 // dt_m) * dt_m
    params = params + [params[-1]] * (t_pad - t0)
    lengths = [int(v) for v in lengths] + [0] * (t_pad - t0)
    rows = _rows_body(config)
    n_pad = -(-n // _align(config, ds_m, rows)) * _align(config, ds_m, rows)
    n_loc = n_pad // ds_m
    tl, ti, si = t_pad // dt_m, mesh.index(taxis), mesh.index(saxis)
    mine = list(range(ti * tl, (ti + 1) * tl))
    x = torch.zeros((tl, n_loc, c), dtype=config.torch_dtype())
    for k, i in enumerate(mine):
        if i < t0:
            part = batch[i, si * n_loc: (si + 1) * n_loc]
            x[k, :part.shape[0]] = torch.as_tensor(part)
    x = x.to(dev)
    chain = MasteringChain(config).to(dev)
    local_p = [params[i] for i in mine]
    local_n = [lengths[i] for i in mine]
    if rows:
        L = config.block_size
        y, measured, _ = _chain_shard_rows(
            mesh, saxis, chain,
            x.permute(2, 0, 1).contiguous().reshape(c, tl, -1, L),
            local_p, local_n, sp_ballistics)
        y = y.reshape(c, tl, n_loc).permute(1, 2, 0)
    else:
        res = [_chain_shard(mesh, saxis, chain, x[k], local_p[k], local_n[k],
                            sp_ballistics) for k in range(tl)]
        y = torch.stack([r[0] for r in res])
        measured = torch.stack([r[1] for r in res])
    out = mesh.all_gather(y).reshape(dt_m, ds_m, tl, n_loc, c).permute(
        0, 2, 1, 3, 4).reshape(t_pad, n_pad, c).cpu().numpy()
    measured = mesh.all_gather(measured).reshape(dt_m, ds_m, tl)[:, 0]
    measured = measured.reshape(-1).cpu().numpy()
    return ([out[i, :lengths[i]] for i in range(t0)], measured[:t0])
