"""Batched (album) mastering: every track of an album in one chunked run.

Counterpart of ``python_audio_mastering_tpu.parallel.batch``.  The JAX
package vmaps the chain over a padded tracks axis, which its sequential
Pallas ballistics kernel cannot take, so it masters albums on the
approximate block-parallel ballistics.  The port needs no vmap: each of
its kernels computes each block of 384 samples from that block and its
incoming state alone, so an album chunk ``(C, T, nb, L)`` folds its T
tracks into the kernels' block axis and every kernel launches once per
chunk for all tracks, on the exact ballistics
(``parallel.streaming.run_tracks``, ``models.chain``).  Each track comes
out as the port's own ``master_streamed`` masters it: its own length
(cells past it masked out of its loudness, samples past it out of its
true peak and its output), its own sliders, state, gain and limiter.

One card; sharding the tracks axis over cards is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import require_device
from python_audio_mastering_tpu_torch.parallel.streaming import (
    _chunk_align,
    default_chunk_frames,
    run_tracks,
)

__all__ = ["pad_tracks", "stack_params", "master_album",
           "master_album_streamed"]


def pad_tracks(tracks: Sequence[np.ndarray], multiple: int = 1):
    """Stack variable-length tracks into ``(T, N_max, C)`` + lengths.

    ``multiple`` rounds the padded length up to a multiple of it.
    """
    tracks = [t[:, None] if t.ndim == 1 else t for t in tracks]
    n_max = max(t.shape[0] for t in tracks)
    n_max = -(-n_max // multiple) * multiple
    c = tracks[0].shape[1]
    dt = np.result_type(*[t.dtype for t in tracks], np.float32)
    out = np.zeros((len(tracks), n_max, c), dtype=dt)
    lengths = np.zeros((len(tracks),), dtype=np.int64)
    for i, t in enumerate(tracks):
        out[i, : t.shape[0]] = t
        lengths[i] = t.shape[0]
    return out, lengths


def stack_params(params: Sequence[MasteringParams]) -> list:
    """The per-track params of an album, checked: the multiband and LUFS
    switches, which decide what the chain runs, must agree across it.
    The port keeps them as a list (the runner groups the tracks by their
    front settings and reads the detector's sliders per track)."""
    params = list(params)
    first = params[0]
    for p in params[1:]:
        if (p.multiband, p.lufs_enabled) != (first.multiband,
                                             first.lufs_enabled):
            raise ValueError("all tracks in a batch must share the static "
                             "multiband/lufs switches (split the album)")
    return params


def _album(tracks, params):
    tracks = [t[:, None] if np.ndim(t) == 1 else t for t in tracks]
    if not tracks:
        raise ValueError("an album needs at least one track")
    if len({t.shape[1] for t in tracks}) > 1:
        raise ValueError("album tracks must share their channel count "
                         "(engine.conform_album_tracks upmixes)")
    if isinstance(params, MasteringParams):
        params = [params] * len(tracks)
    if len(params) != len(tracks):
        raise ValueError(f"{len(params)} params for {len(tracks)} tracks")
    return tracks, stack_params(params)


def master_album_streamed(tracks: Sequence[np.ndarray], params,
                          config: ChainConfig, chunk_seconds: float = 30.0,
                          progress_cb=None, transfer: str = "float32",
                          timings: dict | None = None,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int = 1,
                          return_meters: bool = False, on_track_done=None,
                          device="cuda"):
    """Album mastering, batched over tracks and chunked over time, on
    ``device`` (the card unless the caller passes ``device="cpu"``; raises
    when no card is there).

    Args:
      tracks: ``(N_i, C)`` (or ``(N_i,)``) arrays of one rate and channel
        count, any lengths.
      params: one ``MasteringParams`` for every track, or one per track
        (sharing the multiband/LUFS switches, :func:`stack_params`).
      transfer: ``"float32"`` or ``"pcm16"`` (int16 over the host ↔ device
        link, half the bytes each way).
      timings: a dict that receives ``h2d_s``, ``compute_s`` (or
        ``h2d_plus_compute_s`` when the run is bounded), ``d2h_s``,
        ``wire_bytes_in``, ``wire_bytes_out``, ``device_resident``,
        ``spilled_chunks`` and ``max_retained_bytes``; a device barrier
        separates the phases (pass no dict to measure the overlapped
        wall).
      checkpoint_dir / checkpoint_every: chunk-granular checkpoints, one
        segment file every N chunks, written on one ordered background
        thread; a run given the same directory resumes after the last
        whole segment.
      return_meters: also return one R128 meter dict a track.
      on_track_done: ``cb(i, audio_i, meters_i or None)``, called once a
        track from a small pool as that track's readback lands.

    Device memory follows ``config.device_budget_bytes`` as in
    ``master_streamed``, counted over the whole album.

    Returns ``(outs [(N_i, C) float32], measured_lufs (T,))``, and the
    meters list after them with ``return_meters``.
    """
    device = require_device(device, "master_album_streamed")
    tracks, tracks_params = _album(tracks, params)
    outs, measured, _, meters = run_tracks(
        tracks, tracks_params, config,
        default_chunk_frames(config, chunk_seconds), progress_cb=progress_cb,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        transfer=transfer, return_meters=return_meters, timings=timings,
        on_track_done=on_track_done, device=device, album=True)
    return (outs, measured, meters) if return_meters else (outs, measured)


def master_album(tracks: Sequence[np.ndarray], params, config: ChainConfig,
                 pad_multiple: int = 1, device="cuda"):
    """Master an album in one batched pass on ``device`` (the card unless
    the caller passes ``device="cpu"``): the album is one chunk, its
    length padded to ``pad_multiple`` and to the chunk alignment.  Each
    track comes out as the one-shot ``master()`` masters it: for a legacy
    config, with the legacy EQ (the JAX package vmaps its one-shot
    ``master``), where ``master_album_streamed`` runs the streamed body.

    ``params``: one ``MasteringParams`` for every track, or one per track.
    Returns a list of ``(N_i, C)`` float32 arrays.
    """
    device = require_device(device, "master_album")
    tracks, tracks_params = _album(tracks, params)
    n_max = max(t.shape[0] for t in tracks)
    n_pad = -(-n_max // pad_multiple) * pad_multiple
    align = _chunk_align(config)
    outs, _, _, _ = run_tracks(tracks, tracks_params, config,
                               math.ceil(n_pad / align) * align,
                               device=device, album=True,
                               legacy_eq=config.variant == "legacy")
    return outs
