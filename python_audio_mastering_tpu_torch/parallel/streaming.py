"""Chunked streaming execution with carried state, for one track or an
album.

Counterpart of ``python_audio_mastering_tpu.parallel.streaming`` (the
rows-form chunk body) and of the chunk loop of its ``parallel.batch``.
The audio is cut into chunks of :func:`default_chunk_frames`; each chunk
runs the chain front (and the multiband compressor) with the EQ (and
multiband) state carried from the last one (pass A) and adds its 100 ms
loudness cells, measured with the K-weighting state carried too.  The
gated loudness of all cells sets one gain, and pass B applies gain and
limiter chunk by chunk: the soft limiter, or in quality mode the
lookahead true-peak limiter with its delay line and release gain carried
(``ops.limiter``).  The streamed result matches the one-shot
:func:`master` up to float reassociation, except for the legacy variant,
whose streamed body runs the worker EQ behind the legacy saturation, as
the JAX streamed runner does (``models.chain``).  ``return_meters`` adds the
R128 meter family, from the same cells and a true-peak meter run over
pass B's output with a carried boundary tail.

:func:`run_tracks` is the loop for T tracks at once (T = 1 for
:func:`master_streamed`): a chunk is ``(C, T, nb, L)``, and every kernel
launches once per chunk for all tracks (``models.chain``).  Each track has
its own length, state, loudness gain and limiter, and comes out as its
own :func:`master_streamed` would master it.

The host↔device wire is float32 or int16 PCM (``transfer="pcm16"``:
:func:`quantize_pcm16` on the host, dequantized on the device; pass B's
output requantized on the device, :func:`requantize_pcm16`, and
dequantized on the host).  Device memory follows
``ChainConfig.device_budget_bytes``: while the input, the retained pass-A
chunks and the outputs fit, everything stays on the device; otherwise the
input is uploaded a chunk at a time, pass-A chunks past half the budget
spill to the host (in float, never through the pcm16 quantizer: they are
pre-gain and may exceed ±1), and finalized chunks read back at once.
``checkpoint_dir`` keeps chunk-granular progress (:func:`_save_checkpoint`)
from which an interrupted run resumes.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import (
    MasteringChain,
    check_fp32_matmul,
    check_supported,
    require_device,
)
from python_audio_mastering_tpu_torch.ops import limiter as lim
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.ops import meters as met
from python_audio_mastering_tpu_torch.ops._kernels import upload

__all__ = ["master_streamed", "run_tracks", "StreamState",
           "default_chunk_frames", "quantize_pcm16", "dequantize_pcm16_host",
           "requantize_pcm16", "PCM16_SCALE"]

PCM16_SCALE = 32767.0  # symmetric round-trip scale of the pcm16 wire
_CKPT_GLOB = "chunk_*.npz"


@dataclasses.dataclass
class StreamState:
    """Carried state across chunks: scipy-layout ``(K, 2, C·T)`` filter
    states of the EQ and of the K-weighting (loudness) filter, and the
    multiband compressor's ``{"crossover": {"lp", "hp"} (+ "mid_hp",
    "mid_lp" for the legacy split), "att", "ctrl_tail"}`` dict."""

    eq_zi: Any = None
    mb: Any = None
    kw_zi: Any = None


def default_chunk_frames(config: ChainConfig, seconds: float = 30.0) -> int:
    """A chunk length aligned to the 100 ms loudness cell, the compressor
    control hop and the IIR block size, so per-chunk grids concatenate
    into exactly the one-shot grids and every chunk is whole rows.

    The JAX package falls back to cell/hop alignment (and a channel-major
    body) when the request is shorter than that alignment; the port rounds
    up to one aligned chunk instead (1128960 frames for 30 s at 44.1 kHz
    and L = 384).
    """
    align = _chunk_align(config)
    frames = int(seconds * config.sample_rate)
    return max(1, frames // align) * align


def _chunk_align(config: ChainConfig) -> int:
    cell = int(round(0.1 * config.sample_rate))
    return math.lcm(cell, max(config.comp_hop, 1), config.block_size)


# ---------------------------------------------------------------------------
# The pcm16 wire: one definition of each leg, for every runner
# ---------------------------------------------------------------------------


def quantize_pcm16(x: np.ndarray) -> np.ndarray:
    """Host-side float → int16 for the device link: ``round(clip(x, −1,
    1)·32767)`` in ``x``'s dtype (round half to even).  The runner calls it
    once per track and chunk, the tracks spread over its pool."""
    return np.round(np.clip(np.asarray(x), -1.0, 1.0)
                    * PCM16_SCALE).astype(np.int16)


def dequantize_pcm16_host(y: np.ndarray) -> np.ndarray:
    """Host-side int16 → float32 for the readback leg: one float32
    division by 32767.  The runner calls it once per track, the tracks
    spread over its pool."""
    return np.divide(np.asarray(y), PCM16_SCALE, dtype=np.float32)


def requantize_pcm16(y):
    """Device-side float → int16 for the readback leg: clipped in the
    integer domain to the full ``[−32768, 32767]`` (the limiter bounds
    ``|y|`` near 1; the asymmetric LSB matters only for overs)."""
    return torch.clamp(torch.round(y * PCM16_SCALE), -32768.0,
                       32767.0).to(torch.int16)


def _dequantize(x, dtype):
    """Device-side int16 → ``dtype`` (one division, bitwise the host's
    :func:`dequantize_pcm16_host` in float32); float chunks pass."""
    if x.dtype == torch.int16:
        return x.to(dtype) / PCM16_SCALE
    return x


def _fill_wire(w, tracks, start, pcm16, pool):
    """Frames ``[start, start + F)`` of every track into the wire slot
    ``w (C, T, F)`` (int16 or float), zeros past a track's end, one pool
    task per track, quantized by :func:`quantize_pcm16` for ``pcm16``."""
    frames = w.shape[2]

    def fill(i):
        seg = tracks[i][start:start + frames]
        k = seg.shape[0]
        w[:, i, :k] = (quantize_pcm16(seg) if pcm16 else seg).T
        w[:, i, k:] = 0

    list(pool.map(fill, range(len(tracks))))


# ---------------------------------------------------------------------------
# The chunk body
# ---------------------------------------------------------------------------


def _fx_chunk(chunk, tracks_params, config: ChainConfig, state: StreamState,
              chain: MasteringChain, need_cells: bool = True, groups=None,
              legacy_eq: bool = False):
    """Chain front (and multiband) on one ``(C, T, nb, L)`` chunk of T
    tracks with carried state, plus the chunk's loudness cells.  The
    meter's mono downmix comes from the last stage of the chunk, as in the
    one-shot chain.  ``legacy_eq``: the one-shot legacy front (a chunk that
    is the whole signal).  Returns ``(y, new_state, cells (T, n_cells, C')
    or None)``."""
    want_mono = (need_cells and chunk.shape[0] > 1
                 and config.measure_downmix == "reference_mono_mean")
    multiband = tracks_params[0].multiband
    mb_state = state.mb
    meter_rows = None
    if want_mono and not multiband:
        y, meter_rows, eq_zi = chain.front(
            chunk, tracks_params, state=state.eq_zi, return_state=True,
            emit_mono=True, groups=groups, legacy_eq=legacy_eq)
    else:
        y, eq_zi = chain.front(chunk, tracks_params, state=state.eq_zi,
                               return_state=True, groups=groups,
                               legacy_eq=legacy_eq)
    if multiband:
        out = chain.multiband(y, tracks_params, state=mb_state,
                              return_state=True, emit_mono=want_mono)
        if want_mono:
            y, meter_rows, mb_state = out
        else:
            y, mb_state = out
    if not need_cells:
        return y, StreamState(eq_zi=eq_zi, mb=mb_state), None
    meter_sig = y if meter_rows is None else meter_rows[None]
    cells, _, kw_zi = loud.block_cell_energies_rows(
        meter_sig, config.sample_rate, zi=state.kw_zi, return_state=True,
        ops=chain.kweight_ops())
    return y, StreamState(eq_zi=eq_zi, mb=mb_state, kw_zi=kw_zi), cells


def _rebuild_cells(processed, cell_list, state, config: ChainConfig,
                   chain: MasteringChain, to_dev):
    """Cells for chunks replayed from a checkpoint that holds none (one
    written by a run that needed no loudness): the whole replayed prefix
    is measured again from its processed audio, the K-filter state carried
    from zero as the original pass would have, and ``state.kw_zi`` is
    patched so the chunks after the resume point continue it."""
    if not processed or all(c is not None for c in cell_list):
        return cell_list, state
    kw_zi, rebuilt = None, []
    for y in processed:
        y = to_dev(y)
        meter = (y.mean(dim=0, keepdim=True)
                 if (config.measure_downmix == "reference_mono_mean"
                     and y.shape[0] > 1) else y)
        cells, _, kw_zi = loud.block_cell_energies_rows(
            meter, config.sample_rate, zi=kw_zi, return_state=True,
            ops=chain.kweight_ops())
        rebuilt.append(cells)
    return rebuilt, dataclasses.replace(state, kw_zi=kw_zi)


def _tp_chunk(tail, x, last: bool = False):
    """Streaming true-peak step: ``(M, C)`` output ``x`` after the carried
    ``tail`` (its last samples before) → ``(max true peak, next tail)``.
    Interpolation windows touching the zero padding are left out
    (``exclude_pad``): an edge evaluated against zeros here is evaluated
    again with its real neighbours in the next call.  The head exclusion
    holds on the first chunk too, whose zero tail is the signal's leading
    silence; ``last`` keeps the windows of the signal's real end."""
    ext = torch.cat([tail, x])
    return (met.true_peak_linear(ext, exclude_pad=(True, not last)),
            ext[-tail.shape[0]:])


# ---------------------------------------------------------------------------
# Checkpoints: numpy arrays under flat names, no class of any package
# ---------------------------------------------------------------------------


def _ckpt_path(checkpoint_dir, i):
    return os.path.join(checkpoint_dir, f"chunk_{i:05d}.npz")


def _flatten(prefix, obj, out):
    """Nested dicts of tensors → ``{"prefix.key.key": numpy}``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}", v, out)
    elif obj is not None:
        out[prefix] = (obj.cpu().numpy() if torch.is_tensor(obj)
                       else np.asarray(obj))


def _nest(flat, prefix, device):
    """The inverse of :func:`_flatten` for one prefix (None if absent),
    arrays as tensors on ``device``."""
    out = None
    for key, v in flat.items():
        if key != prefix and not key.startswith(prefix + "."):
            continue
        t = torch.from_numpy(v).to(device)
        if key == prefix:
            return t
        parts = key[len(prefix) + 1:].split(".")
        node = out = {} if out is None else out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def _save_checkpoint(checkpoint_dir, i, ys, state: StreamState, cells):
    """Durable progress: the segment of processed chunks ending at chunk
    ``i`` (their ``(C, T, nb, L)`` pass-A audio and cells) and the carried
    state after it, written to a ``.tmp`` file and renamed into place (a
    reader never sees a partial file).  The file is keyed by its last
    chunk index and records its first (``start``)."""
    arrays = {"start": np.asarray(i - len(ys) + 1), "count":
              np.asarray(len(ys))}
    for k, (y, c) in enumerate(zip(ys, cells)):
        _flatten(f"y{k}", y, arrays)
        _flatten(f"cells{k}", c, arrays)
    for name in ("eq_zi", "mb", "kw_zi"):
        _flatten(f"state.{name}", getattr(state, name), arrays)
    path = _ckpt_path(checkpoint_dir, i)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load_checkpoints(checkpoint_dir, num_chunks, chunk_shape, device):
    """Replay the contiguous prefix of saved segments: ``(chunks done,
    state, processed (host numpy), cells (device tensors or None))``.
    Files of another geometry (another job or settings) raise."""
    processed, cell_list = [], []
    state = StreamState()
    i = 0
    for path in sorted(glob.glob(os.path.join(checkpoint_dir, _CKPT_GLOB))):
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        start, count = int(flat["start"]), int(flat["count"])
        if start != i:  # a gap: stop at the contiguous prefix
            break
        for k in range(count):
            y = flat[f"y{k}"]
            if y.shape != chunk_shape:
                raise ValueError(f"checkpoint {path}: chunk of shape "
                                 f"{y.shape}, this run's is {chunk_shape}")
            processed.append(y)
            cell_list.append(_nest(flat, f"cells{k}", device))
        state = StreamState(**{n: _nest(flat, f"state.{n}", device)
                               for n in ("eq_zi", "mb", "kw_zi")})
        i = start + count
        if i >= num_chunks:
            break
    return min(i, num_chunks), state, processed[:num_chunks], \
        cell_list[:num_chunks]


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


def _meters(all_cells, gains, gains_np, measured, tp_max, lengths,
            cell_len):
    """Per-track R128 meter dicts, every number read back in one copy.
    The series are those of the *normalized* signal (cell energies scale
    by gain², before the limiter: the usual metering point)."""
    pieces, sizes, lra_at = [], [], []
    for i, n_i in enumerate(lengths):
        valid = all_cells[i, : n_i // cell_len] * gains[i] ** 2
        mom = met._sliding_loudness(valid, 4)
        st = met._sliding_loudness(valid, 30)
        pieces += [mom, st]
        sizes += [mom.shape[0], st.shape[0]]
        if st.shape[0]:
            pieces.append(met.lra_from_shortterm(st).reshape(1))
        lra_at.append(bool(st.shape[0]))
    host = torch.cat(pieces + [tp_max]).cpu().numpy()
    out, pos = [], 0
    for i in range(len(lengths)):
        mom = host[pos:pos + sizes[2 * i]]
        pos += sizes[2 * i]
        st = host[pos:pos + sizes[2 * i + 1]]
        pos += sizes[2 * i + 1]
        lra = float("nan")
        if lra_at[i]:
            lra, pos = float(host[pos]), pos + 1
        out.append({"momentary_lufs": mom, "short_term_lufs": st,
                    "lra_lu": lra})
    tp = host[pos:]
    gain_db = 20.0 * np.log10(np.maximum(gains_np, 1e-12))
    for i, m in enumerate(out):
        m["true_peak_dbtp"] = 20.0 * math.log10(max(float(tp[i]), 1e-12))
        m["integrated_lufs"] = float(measured[i]) + float(gain_db[i])
    return out


def run_tracks(tracks, tracks_params, config: ChainConfig, chunk_frames: int,
               progress_cb=None, carry_state: bool = True,
               checkpoint_dir=None, checkpoint_every: int = 1,
               transfer: str = "float32", return_meters: bool = False,
               stats: dict | None = None, timings: dict | None = None,
               on_track_done=None, device="cuda", album: bool = False,
               legacy_eq: bool = False):
    """Master T tracks chunk by chunk on ``device`` (already resolved by
    the caller), every kernel launched once per chunk for all of them.

    ``tracks``: ``(N_i, C)`` arrays (numpy; ``np.memmap`` takes the
    bounded path).  ``tracks_params``: one ``MasteringParams`` per track,
    sharing the multiband and LUFS switches.  ``stats`` receives the
    residency telemetry; ``timings`` also the phase walls, with a device
    barrier between phases.  ``on_track_done(i, audio, meters_i)`` runs on
    a small pool as each track's readback lands.  ``album`` picks the
    progress messages' wording.  ``legacy_eq`` (a legacy config) runs the
    one-shot legacy front, as ``master()`` does, and needs the whole
    signal in one chunk; else a legacy chunk takes the worker EQ, as the
    JAX streamed runner's does.

    Returns ``(outs [(N_i, C) float32 numpy], measured (T,), gains_db (T,),
    meters list or None)``.
    """
    with ThreadPoolExecutor(max_workers=min(len(tracks), os.cpu_count() or 1,
                                            16)) as pool:
        return _run_tracks(
            pool, tracks, tracks_params, config, chunk_frames, progress_cb,
            carry_state, checkpoint_dir, checkpoint_every, transfer,
            return_meters, stats, timings, on_track_done, device, album,
            legacy_eq)


def _run_tracks(pool, tracks, tracks_params, config, chunk_frames,
                progress_cb, carry_state, checkpoint_dir, checkpoint_every,
                transfer, return_meters, stats, timings, on_track_done,
                device, album, legacy_eq):
    if transfer not in ("float32", "pcm16"):
        raise ValueError(f"unknown transfer format {transfer!r}")
    pcm16 = transfer == "pcm16"
    for p in tracks_params:
        check_supported(p, config)
    check_fp32_matmul(device)
    chain = MasteringChain(config).to(device)
    dtype = config.torch_dtype()
    first = tracks_params[0]
    c = tracks[0].shape[1]
    n_tracks = len(tracks)
    lengths = [int(t.shape[0]) for t in tracks]
    n = max(lengths)
    L = config.block_size
    cpb = chunk_frames // L
    num_chunks = max(1, -(-n // chunk_frames))
    if legacy_eq and (num_chunks > 1 or config.variant != "legacy"):
        raise ValueError("the one-shot legacy front takes a legacy config "
                         "and the whole signal in one chunk")
    chunk_shape = (c, n_tracks, cpb, L)
    barrier = (torch.cuda.synchronize if timings is not None
               and device.type == "cuda" else lambda: None)
    cb = progress_cb or (lambda msg: None)

    # the residency policy: input + retained pass-A chunks + outputs
    wire_dt = np.int16 if pcm16 else np.dtype(config.dtype)
    wire_bytes = n_tracks * num_chunks * chunk_frames * c * \
        np.dtype(wire_dt).itemsize
    chunk_dev_bytes = n_tracks * chunk_frames * c * \
        np.dtype(config.dtype).itemsize
    resident = (not any(isinstance(t, np.memmap) for t in tracks)
                and wire_bytes + 2 * num_chunks * chunk_dev_bytes
                <= config.device_budget_bytes)
    keep_dev = max(2, (config.device_budget_bytes // 2) // chunk_dev_bytes)
    mem = {"max_retained_bytes": 0, "spilled_chunks": 0,
           "device_resident": resident}
    if stats is not None:
        stats.update(mem)
        mem = stats

    def to_dev(y):
        return (y if torch.is_tensor(y)
                else torch.from_numpy(np.ascontiguousarray(y)).to(device))

    t0 = time.perf_counter()
    if resident:
        wire = np.empty((num_chunks, c, n_tracks, chunk_frames), wire_dt)
        for j in range(num_chunks):
            _fill_wire(wire[j], tracks, j * chunk_frames, pcm16, pool)
        x_dev = torch.from_numpy(wire).to(device)
        del wire

        def chunk_at(j):
            return _dequantize(x_dev[j].view(chunk_shape), dtype)
    else:
        def chunk_at(j):
            w = np.empty((c, n_tracks, chunk_frames), wire_dt)
            _fill_wire(w, tracks, j * chunk_frames, pcm16, pool)
            return _dequantize(torch.from_numpy(w).to(device).view(
                chunk_shape), dtype)
    barrier()
    if timings is not None:
        timings["wire_bytes_in"] = wire_bytes
        if resident:
            timings["h2d_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()

    need_cells = first.lufs_enabled or return_meters
    state = StreamState()
    processed, cell_list = [], []
    i0 = 0
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        i0, state, processed, cell_list = _load_checkpoints(
            checkpoint_dir, num_chunks, chunk_shape, device)
        if resident:
            processed = [to_dev(y) for y in processed]
        if need_cells:
            cell_list, state = _rebuild_cells(processed, cell_list, state,
                                              config, chain, to_dev)
        if i0:
            cb(f"Resuming from checkpoint: {i0}/{num_chunks} chunks already "
               "processed." if album
               else f"Resuming from chunk {i0 + 1}/{num_chunks}...")

    # pass A; checkpoint segments are written on one ordered background
    # thread (the file of chunk i exists only after those before it)
    groups = chain.front_groups(tracks_params, legacy_eq)
    every = max(1, int(checkpoint_every))
    writer = (ThreadPoolExecutor(max_workers=1) if checkpoint_dir else None)
    saves, seg_y, seg_c = [], [], []
    dev_start = len(processed)   # resumed chunks stay where they are
    try:
        for i in range(i0, num_chunks):
            y, new_state, cells = _fx_chunk(chunk_at(i), tracks_params,
                                            config, state, chain,
                                            need_cells=need_cells,
                                            groups=groups,
                                            legacy_eq=legacy_eq)
            state = new_state if carry_state else StreamState()
            processed.append(y)
            mem["max_retained_bytes"] = max(
                mem["max_retained_bytes"],
                (len(processed) - dev_start) * chunk_dev_bytes)
            if not resident and len(processed) - dev_start > keep_dev:
                processed[dev_start] = processed[dev_start].cpu().numpy()
                dev_start += 1
                mem["spilled_chunks"] += 1
            cell_list.append(cells)
            if writer is not None:
                seg_y.append(y)
                seg_c.append(cells)
                if len(seg_y) >= every or i == num_chunks - 1:
                    saves.append(writer.submit(_save_checkpoint,
                                               checkpoint_dir, i, seg_y,
                                               state, seg_c))
                    seg_y, seg_c = [], []
            cb(f"Processed chunk {i + 1}/{num_chunks} ({n_tracks} tracks)..."
               if album else f"Processed chunk {i + 1}/{num_chunks}...")
        for fut in saves:
            fut.result()
    finally:
        if writer is not None:
            # an interrupted run keeps the segments it already submitted
            writer.shutdown(wait=True)

    # the loudness gain of every track at once
    cell_len = loud._gating_geometry(config.sample_rate)[0]
    all_cells = (torch.cat([to_dev(x) for x in cell_list], dim=1)
                 if need_cells else None)
    if first.lufs_enabled:
        valid = upload([n_i // cell_len for n_i in lengths], torch.int64,
                       device)
        mask = (torch.arange(all_cells.shape[1], device=device)[None]
                < valid[:, None])
        measured = loud.loudness_from_cells(all_cells, cell_mask=mask)
        gains = loud.gain_for_target(
            measured, upload([p.lufs for p in tracks_params], dtype, device))
    else:
        measured = torch.full((n_tracks,), float("nan"), dtype=dtype,
                              device=device)
        gains = torch.ones((n_tracks,), dtype=dtype, device=device)

    # pass B: per-track output pieces (M, C), time-major
    pieces = [[] for _ in range(n_tracks)]
    k_tp = met._oversample_taps(4).shape[0] // 4   # the interpolator's taps
    tails = [torch.zeros((k_tp, c), dtype=dtype, device=device)
             for _ in range(n_tracks)]
    tp_max = [None] * n_tracks

    def meter(i, e, last):
        """The true peak of track ``i``'s output piece ``e`` (as read
        back: the quantized samples are the output)."""
        if return_meters:
            tp, tails[i] = _tp_chunk(tails[i], _dequantize(e, dtype), last)
            tp_max[i] = tp if tp_max[i] is None else torch.maximum(
                tp_max[i], tp)

    quality = config.limiter_mode == "lookahead_truepeak"
    lstates = [lim.lookahead_limiter_init(c, dtype, device)
               for _ in range(n_tracks)] if quality else None
    gb = gains.view(1, n_tracks, 1, 1)
    for j, y in enumerate(processed):
        y = to_dev(y)
        start = j * chunk_frames
        live = [i for i, n_i in enumerate(lengths) if start < n_i]

        def track(t, i):
            """Track ``i``'s samples of chunk ``t``, cut at its end, as
            ``(M, C)``."""
            return t[:, i].reshape(c, -1)[:, : lengths[i] - start].T

        if not quality:
            f = chain.limiter(y * gb)
            f = requantize_pcm16(f) if pcm16 else f
            for i in live:
                meter(i, track(f, i), start + chunk_frames >= lengths[i])
            f = f if resident else f.cpu()
            for i in live:
                pieces[i].append(track(f, i))
        else:
            for i in live:
                o, lstates[i] = lim.lookahead_limiter_chunk(
                    track(y, i) * gains[i], lstates[i], config.sample_rate)
                out = [o]
                final = start + chunk_frames >= lengths[i]
                if final:   # the last chunk: drain the pending samples
                    out.append(lim.lookahead_limiter_chunk(
                        None, lstates[i], config.sample_rate,
                        flush=True)[0])
                out = [e for e in out if e.shape[0]]
                for k, e in enumerate(out):
                    e = requantize_pcm16(e) if pcm16 else e
                    meter(i, e, final and k == len(out) - 1)
                    pieces[i].append(e if resident else e.cpu())
        cb(f"Finalizing chunk {j + 1}/{num_chunks}...")

    meters = None
    host = torch.stack([measured, gains]).cpu().numpy().astype(np.float64)
    measured_np, gains_np = host[0], host[1]
    if return_meters:
        meters = _meters(all_cells, gains, gains_np, measured_np,
                         torch.stack(tp_max), lengths, cell_len)
    barrier()
    if timings is not None:
        timings["compute_s" if resident else "h2d_plus_compute_s"] = \
            time.perf_counter() - t0
        timings.update(device_resident=resident,
                       spilled_chunks=mem["spilled_chunks"],
                       max_retained_bytes=mem["max_retained_bytes"])
        t0 = time.perf_counter()

    # readback: one asynchronous copy a track, finished on the pool
    outs = [None] * n_tracks
    wire_out = 0

    def finish(i, h, ready):
        if ready is not None:
            ready.synchronize()
        h = h.numpy() if torch.is_tensor(h) else h
        outs[i] = (dequantize_pcm16_host(h) if pcm16
                   else np.asarray(h, np.float32))
        if on_track_done is not None:
            on_track_done(i, outs[i], None if meters is None else meters[i])

    futs = []
    for i in range(n_tracks):
        h, ready = torch.cat(pieces[i]).contiguous(), None
        if h.device.type == "cuda":
            h = h.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        pieces[i] = None
        wire_out += h.numel() * h.element_size()
        futs.append(pool.submit(finish, i, h, ready))
    for fut in futs:
        fut.result()
    if timings is not None:
        timings["d2h_s"] = time.perf_counter() - t0
        timings["wire_bytes_out"] = wire_out
    gains_db = 20.0 * np.log10(np.maximum(gains_np, 1e-300))
    return outs, measured_np, gains_db, meters


def master_streamed(audio, params: MasteringParams, config: ChainConfig,
                    chunk_seconds: float = 30.0, progress_cb=None,
                    carry_state: bool = True, checkpoint_dir=None,
                    transfer: str = "float32", return_meters: bool = False,
                    stats: dict | None = None, device="cuda"):
    """Master ``(N, C)`` or ``(N,)`` float audio chunk by chunk on
    ``device``: the card unless the caller passes ``device="cpu"``; raises
    when no card is there.

    Args:
      audio: numpy array (``np.memmap`` works for larger-than-RAM files).
      progress_cb: optional ``cb(message: str)``.
      carry_state: True carries every filter, detector and ballistics
        state across chunks (streamed == one-shot); False resets them at
        each chunk, as the reference engine does.
      checkpoint_dir: chunk-granular resume: after each chunk its
        processed audio, cells and the carried state land in
        ``chunk_NNNNN.npz``; a run given the same directory resumes at
        the first missing chunk.
      transfer: ``"float32"`` or ``"pcm16"`` (int16 PCM over the host ↔
        device link, de/requantized on the device; half the bytes).
      return_meters: also return the R128 meter family: momentary and
        short-term series and LRA from the accumulated 100 ms cells, the
        output's true peak from pass B's chunks, and the integrated
        loudness after the gain (no second pass over the audio).
      stats: receives ``max_retained_bytes``, ``spilled_chunks`` and
        ``device_resident`` (the policy of ``config.device_budget_bytes``,
        see the module docstring).

    Returns ``(audio_out (N, C) float32 numpy, measured_lufs, gain_db)``,
    and the meters dict after them with ``return_meters``.
    """
    device = require_device(device, "master_streamed")
    squeeze = np.ndim(audio) == 1
    if squeeze:
        audio = audio[:, None]
    outs, measured, gains_db, meters = run_tracks(
        [audio], [params], config, default_chunk_frames(config, chunk_seconds),
        progress_cb=progress_cb, carry_state=carry_state,
        checkpoint_dir=checkpoint_dir, transfer=transfer,
        return_meters=return_meters, stats=stats, device=device)
    out = outs[0][:, 0] if squeeze else outs[0]
    res = (out, float(measured[0]), float(gains_db[0]))
    return res + (meters[0],) if return_meters else res
