"""Batched (album) mastering: every track of an album in one chunked run,
its tracks sharded over the ranks of a mesh.

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

Data parallelism: given a ``parallel.mesh`` mesh (or, with ``mesh=None``,
``make_mesh()`` over every rank when a default process group exists),
the tracks axis is padded to a multiple of the mesh's size with silent
tracks that take the last track's params, as the JAX package pads it, and
each rank masters its own rows (``parallel.mesh.tracks_sharding``) on its
device through the same runner, its kernels launched once a chunk for
its tracks.  The ranks share nothing while they master: one
``all_gather`` of the outputs and one of the loudness results (and the
meters) at the end give every rank the whole album, in track order.
Without a group, the album runs on one device.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import (
    cached_chain,
    require_device,
)
from python_audio_mastering_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_device,
    tracks_sharding,
)
from python_audio_mastering_tpu_torch.parallel.streaming import (
    _chunk_align,
    default_chunk_frames,
    dequantize_pcm16_host,
    quantize_pcm16,
    run_tracks,
)

__all__ = ["pad_tracks", "stack_params", "master_album",
           "master_album_streamed", "make_album_fn"]

_MESH_FILE = "mesh.json"   # the mesh size a sharded checkpoint was written at


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


def _album_mesh(mesh):
    """The mesh an album shards over: ``mesh``, else ``make_mesh()`` over
    every rank of the default process group, else None (one device)."""
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = make_mesh()
    return mesh


@dataclasses.dataclass
class _Shard:
    """This rank's rows of an album padded to a multiple of the mesh's
    first axis: ``rows`` (album indices; those ≥ ``n_real`` are silent
    tracks), their tracks and params."""

    rows: range
    n_real: int
    tracks: list
    params: list


def _shard(tracks, params, mesh):
    """The album padded to a multiple of the mesh's first axis, and this
    rank's rows of it (ranks along a second axis hold the same rows)."""
    axis = mesh.axis_names[0]
    t0, d = len(tracks), mesh.size(axis)
    t_pad = -(-t0 // d) * d
    n_max = max(t.shape[0] for t in tracks)
    silent = np.zeros((n_max, tracks[0].shape[1]), np.float32)
    tracks = list(tracks) + [silent] * (t_pad - t0)
    params = list(params) + [params[-1]] * (t_pad - t0)
    sharding = tracks_sharding(mesh, axis)
    return _Shard(sharding.rows(t_pad), t0, sharding.shard(tracks),
                  sharding.shard(params))


def _gather_album(mesh, outs, lengths, pcm16, extra=None, timings=None):
    """Every rank's outputs in album order, real tracks only (``lengths``
    theirs): one ``all_gather`` along the mesh's first axis of the outputs
    padded to the longest (int16 on the pcm16 wire, which its dequantized
    samples round-trip exactly; float32 tracks come back as views of the
    gathered buffer), and one of ``extra`` (the loudness results and
    meters, a list a rank's track) when given."""
    t0 = time.perf_counter()
    axis = mesh.axis_names[0]
    if mesh.size(axis) == 1:
        return (outs[:len(lengths)],
                None if extra is None else extra[:len(lengths)])
    n_max, c = max(lengths), outs[0].shape[1]
    wire = np.zeros((len(outs), n_max, c), np.int16 if pcm16 else np.float32)
    for k, o in enumerate(outs):
        wire[k, :o.shape[0]] = quantize_pcm16(o) if pcm16 else o
    # the bytes (gloo moves no int16)
    got = mesh.all_gather(torch.from_numpy(wire.view(np.uint8)), axis)
    got = got.numpy().view(wire.dtype).reshape(-1, n_max, c)
    all_outs = [dequantize_pcm16_host(got[i, :n]) if pcm16 else got[i, :n]
                for i, n in enumerate(lengths)]
    if extra is not None:
        extra = [e for part in mesh.all_gather_object(extra, axis)
                 for e in part][:len(lengths)]
    if timings is not None:
        timings["gather_s"] = time.perf_counter() - t0
    return all_outs, extra


def _checkpoint_dir(checkpoint_dir, mesh):
    """This rank's checkpoint directory: ``checkpoint_dir`` itself on one
    device or a mesh of one rank, ``rank<r>`` under it (``r`` the rank)
    on a larger mesh, whose size ``mesh.json`` records.  A directory
    written at another mesh size raises ``ValueError`` naming both sizes
    (its shards hold other tracks)."""
    if not checkpoint_dir:
        return None
    d = 1 if mesh is None else mesh.size()
    meta = os.path.join(checkpoint_dir, _MESH_FILE)
    written = None
    if os.path.exists(meta):
        with open(meta) as f:
            written = int(json.load(f)["size"])
    elif glob.glob(os.path.join(checkpoint_dir, "chunk_*.npz")):
        written = 1
    if written is not None and written != d:
        raise ValueError(
            f"checkpoint_dir {checkpoint_dir!r} holds a run on a mesh of "
            f"{written} ranks; this run has {d}: resume it on {written} "
            f"ranks, or start in a fresh directory")
    if d == 1:
        return checkpoint_dir
    os.makedirs(checkpoint_dir, exist_ok=True)
    if written is None and dist.get_rank() == 0:
        tmp = f"{meta}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"size": d}, f)
        os.replace(tmp, meta)
    return os.path.join(checkpoint_dir, f"rank{dist.get_rank()}")


def master_album_streamed(tracks: Sequence[np.ndarray], params,
                          config: ChainConfig, mesh=None,
                          chunk_seconds: float = 30.0, progress_cb=None,
                          transfer: str = "float32",
                          timings: dict | None = None,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int = 1,
                          return_meters: bool = False, on_track_done=None,
                          device="cuda"):
    """Album mastering, batched over tracks and chunked over time, on
    ``device`` (the card unless the caller passes ``device="cpu"``; raises
    when no card is there), the tracks sharded over ``mesh``.

    Args:
      tracks: ``(N_i, C)`` (or ``(N_i,)``) arrays of one rate and channel
        count, any lengths.
      params: one ``MasteringParams`` for every track, or one per track
        (sharing the multiband/LUFS switches, :func:`stack_params`).
      mesh: a ``parallel.mesh`` mesh whose first axis the tracks shard
        over; None: ``make_mesh()`` over every rank when a default process
        group exists, else one device.  SPMD: every rank calls with the
        whole album and returns it whole.
      transfer: ``"float32"`` or ``"pcm16"`` (int16 over the host ↔ device
        link, half the bytes each way; the ranks' outputs are gathered as
        int16 too).
      timings: a dict that receives this rank's ``h2d_s``, ``compute_s``
        (or ``h2d_plus_compute_s`` when the run is bounded), ``d2h_s``,
        ``wire_bytes_in``, ``wire_bytes_out``, ``device_resident``,
        ``spilled_chunks`` and ``max_retained_bytes``, and on a mesh of
        several ranks ``gather_s``; a device barrier separates the phases (pass no dict
        to measure the overlapped wall).
      checkpoint_dir / checkpoint_every: chunk-granular checkpoints, one
        segment file every N chunks, written on one ordered background
        thread; a run given the same directory resumes after the last
        whole segment.  On a mesh each rank writes its own ``rank<i>``
        subdirectory, and a run resumes only at the mesh size that wrote
        it (another raises ``ValueError``).
      progress_cb: ``cb(message)`` for this rank's chunks.
      return_meters: also return one R128 meter dict a track.
      on_track_done: ``cb(i, audio_i, meters_i or None)``, called once a
        track (``i`` its index in the album) from a small pool as that
        track's readback lands, on the rank that mastered it.

    Device memory follows ``config.device_budget_bytes`` as in
    ``master_streamed``, counted over this rank's tracks.

    Returns ``(outs [(N_i, C) float32], measured_lufs (T,))``, and the
    meters list after them with ``return_meters``.
    """
    device = require_device(device, "master_album_streamed")
    tracks, tracks_params = _album(tracks, params)
    mesh = _album_mesh(mesh)
    frames = default_chunk_frames(config, chunk_seconds)
    kw = dict(progress_cb=progress_cb, checkpoint_every=checkpoint_every,
              transfer=transfer, return_meters=return_meters,
              timings=timings, album=True,
              checkpoint_dir=_checkpoint_dir(checkpoint_dir, mesh))
    if mesh is None:
        outs, measured, _, meters = run_tracks(
            tracks, tracks_params, config, frames,
            on_track_done=on_track_done, device=device, **kw)
        return (outs, measured, meters) if return_meters else (outs, measured)

    shard = _shard(tracks, tracks_params, mesh)

    def done(k, audio, meters_k):
        if on_track_done is not None and shard.rows[k] < shard.n_real:
            on_track_done(shard.rows[k], audio, meters_k)

    outs, measured, _, meters = run_tracks(
        shard.tracks, shard.params, config, frames, on_track_done=done,
        device=mesh_device(device, mesh), **kw)
    outs, extra = _gather_album(
        mesh, outs, [t.shape[0] for t in tracks], transfer == "pcm16",
        list(zip(measured.tolist(), meters or [None] * len(outs))), timings)
    measured = np.asarray([m for m, _ in extra])
    if return_meters:
        return outs, measured, [m for _, m in extra]
    return outs, measured


def master_album(tracks: Sequence[np.ndarray], params, config: ChainConfig,
                 mesh=None, pad_multiple: int = 1, device="cuda"):
    """Master an album in one batched pass on ``device`` (the card unless
    the caller passes ``device="cpu"``): the album is one chunk, its
    length padded to ``pad_multiple`` and to the chunk alignment, its
    tracks sharded over ``mesh`` (as in :func:`master_album_streamed`;
    every rank returns the whole album).  Each track comes out as the
    one-shot ``master()`` masters it: for a legacy config, with the
    legacy EQ (the JAX package vmaps its one-shot ``master``), where
    ``master_album_streamed`` runs the streamed body.

    ``params``: one ``MasteringParams`` for every track, or one per track.
    Returns a list of ``(N_i, C)`` float32 arrays.
    """
    device = require_device(device, "master_album")
    tracks, tracks_params = _album(tracks, params)
    mesh = _album_mesh(mesh)
    n_max = max(t.shape[0] for t in tracks)
    n_pad = -(-n_max // pad_multiple) * pad_multiple
    align = _chunk_align(config)
    kw = dict(album=True, legacy_eq=config.variant == "legacy")
    frames = math.ceil(n_pad / align) * align
    if mesh is None:
        return run_tracks(tracks, tracks_params, config, frames,
                          device=device, **kw)[0]
    shard = _shard(tracks, tracks_params, mesh)
    outs = run_tracks(shard.tracks, shard.params, config, frames,
                      device=mesh_device(device, mesh), **kw)[0]
    return _gather_album(mesh, outs, [t.shape[0] for t in tracks],
                         False)[0]


def make_album_fn(config: ChainConfig, mesh=None, device="cuda"):
    """``fn(batch (T, N, C), params, lengths (T,)) -> (T, N, C)``: each
    track mastered one-shot (``MasteringChain.forward_tracks``, its
    loudness over its first ``lengths[i]`` samples) over one cached
    ``MasteringChain`` per (config, device), the tracks axis sharded over
    ``mesh`` (as in :func:`master_album_streamed`; None: every rank of
    the default group, else one device).  ``params``: one
    ``MasteringParams`` or T of them.  As with the JAX package's sharded
    ``jit``, a T that does not split evenly over the mesh raises
    (:func:`master_album` pads, this function does not).  Every rank gets
    the whole ``(T, N, C)`` tensor on its device (``device``: the card
    unless the caller passes ``device="cpu"``).
    """
    device = require_device(device, "make_album_fn")
    mesh = _album_mesh(mesh)
    if mesh is not None:
        device = mesh_device(device, mesh)
        axis = mesh.axis_names[0]
        sharding = tracks_sharding(mesh, axis)
    chain = cached_chain(config, device)

    def fn(batch, params, lengths):
        if isinstance(params, MasteringParams):
            params = [params] * len(batch)
        params, lengths = stack_params(params), list(lengths)
        if mesh is not None:
            batch, params, lengths = (sharding.shard(v)
                                      for v in (batch, params, lengths))
        y = chain.forward_tracks(torch.as_tensor(batch), params, lengths)[0]
        if mesh is None:
            return y
        return mesh.all_gather(y.contiguous(), axis).reshape(-1,
                                                             *y.shape[1:])

    return fn
