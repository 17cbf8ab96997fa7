"""Engine entry points of the port.

Counterpart of ``python_audio_mastering_tpu.engine`` for the single-file
engines:

* ``process_audio(settings, callback)``, the desktop engine the GUI calls:
  reads ``settings["input_file"]``, masters it through the streamed chain,
  optionally resamples it (``output_sample_rate``), writes
  ``settings["output_file"]``, reports progress through ``callback(msg)``
  and ends with a message containing "complete" or "ERROR" (the GUI
  matches on those words);
* ``batch_process_audio(settings, input_dir, output_dir, callback)``, the
  GUI's folder loop over ``process_audio``;
* ``process_audio_from_uri(uri, settings)`` (and its reference name
  ``process_audio_from_gcs``), the cloud worker engine: download from a
  blob store, master, upload the WAV, an R128 meter summary
  ``{output}.meters.json`` and a ``.complete`` flag;
* ``automaster_audio(settings, callback)``, the GUI's automaster tab and
  the CLI's ``automaster`` verb: fit the saturation, EQ and width sliders
  to a reference track (``models.automaster``), then master the input
  with them;
* ``process_album_from_uris(uris, settings)``, the cloud album engine:
  every file of an album decoded (the native batch decoder when it can),
  conformed to one rate and channel count, mastered in one batched
  chunked run (``parallel.batch.master_album_streamed``), and each
  track's blob, sidecar and flag uploaded as its readback lands.

The settings keys beyond the chain's: ``quality`` (truthy: the lookahead
true-peak limiter), ``output_sample_rate`` and ``dither``.  Every entry
runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.models.chain import require_device
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS  # noqa: F401  (GUI re-export contract)
from python_audio_mastering_tpu_torch.ops import resample as rs
from python_audio_mastering_tpu_torch.parallel.batch import (
    master_album_streamed,
)
from python_audio_mastering_tpu_torch.parallel.streaming import master_streamed
from python_audio_mastering_tpu_torch.serving import store as store_mod

__all__ = ["EQ_PRESETS", "default_config", "process_audio",
           "batch_process_audio", "automaster_audio", "process_audio_from_gcs",
           "process_audio_from_uri", "process_album_from_uris",
           "conform_album_tracks", "meters_summary", "AUDIO_EXTENSIONS"]

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".aiff")


def default_config(sample_rate: int) -> ChainConfig:
    """Throughput defaults (:meth:`ChainConfig.gpu_default`)."""
    return ChainConfig.gpu_default(sample_rate=sample_rate)


def _config_for(settings: dict, sample_rate: int,
                config: ChainConfig | None) -> ChainConfig:
    """The chain config for a job: a truthy ``quality`` key selects the
    lookahead true-peak limiter instead of the soft knee."""
    cfg = config or default_config(sample_rate)
    if settings.get("quality") and cfg.limiter_mode == "reference":
        cfg = dataclasses.replace(cfg, limiter_mode="lookahead_truepeak")
    return cfg


def _run_chain(audio: np.ndarray, sample_rate: int, settings: dict,
               progress_cb=None, config: ChainConfig | None = None,
               return_meters: bool = False, transfer: str = "float32",
               device="cuda"):
    params = MasteringParams.from_settings(settings)
    cfg = _config_for(settings, sample_rate, config)
    res = master_streamed(audio, params, cfg, progress_cb=progress_cb,
                          return_meters=return_meters, transfer=transfer,
                          device=device)
    out, measured, gain_db = res[:3]
    if params.lufs_enabled and progress_cb:
        progress_cb(f"Current loudness: {measured:.2f} LUFS. "
                    f"Applying {gain_db:.2f} dB gain...")
    return (out, res[3]) if return_meters else out


def meters_summary(meters: dict | None) -> dict | None:
    """JSON-safe scalar summary of a meter dict (series → their maxima,
    rounded to 0.01): the sidecar and API payload.  Every non-finite value
    becomes null (silence gates to −inf LUFS, which ``json.dumps`` would
    write as the non-standard ``-Infinity``)."""
    if meters is None:
        return None

    def _f(v):
        v = None if v is None else float(v)
        return round(v, 2) if v is not None and math.isfinite(v) else None

    def _mx(series):
        if series is None or len(series) == 0:
            return None
        arr = np.asarray(series, dtype=np.float64)
        mx = np.nanmax(arr) if not np.all(np.isnan(arr)) else np.nan
        return round(float(mx), 2) if np.isfinite(mx) else None

    return {
        "integrated_lufs": _f(meters.get("integrated_lufs")),
        "lra_lu": _f(meters.get("lra_lu")),
        "true_peak_dbtp": _f(meters.get("true_peak_dbtp")),
        "max_momentary_lufs": _mx(meters.get("momentary_lufs")),
        "max_short_term_lufs": _mx(meters.get("short_term_lufs")),
    }


def _maybe_resample(out: np.ndarray, fs: int, settings: dict, cb,
                    device="cuda"):
    """Output-rate conversion on ``device`` when
    ``settings["output_sample_rate"]`` is set and differs from ``fs``."""
    target = settings.get("output_sample_rate")
    if not target or int(target) == fs:
        return out, fs
    target = int(target)
    cb(f"Resampling {fs} -> {target} Hz...")
    x = torch.from_numpy(np.ascontiguousarray(out)).to(device)
    return rs.resample(x, fs, target).cpu().numpy(), target


def process_audio(settings: dict, status_callback=None,
                  config: ChainConfig | None = None, device="cuda") -> bool:
    """Desktop single-file engine (GUI contract).  Returns success.

    ``device``: where the chain runs, the card unless the caller passes
    ``device="cpu"``.  Without a card the job fails with an ``ERROR:``
    message naming the missing device.
    """
    cb = status_callback or (lambda msg: None)
    try:
        in_path = settings.get("input_file")
        out_path = settings.get("output_file")
        if not in_path or not out_path:
            cb("ERROR: input_file and output_file must be set.")
            return False
        cb(f"Loading {os.path.basename(in_path)}...")
        audio, fs = wavio.read_audio(in_path)
        cb("Processing audio in chunks...")
        out = _run_chain(audio, fs, settings, progress_cb=cb, config=config,
                         device=device)
        out, fs = _maybe_resample(out, fs, settings, cb, device)
        cb("Exporting...")
        wavio.write_audio(out_path, out, fs,
                          dither=bool(settings.get("dither")))
        cb(f"Processing complete! Saved to {out_path}")
        return True
    except Exception as e:  # noqa: BLE001 — engine boundary: report, don't raise
        traceback.print_exc()
        cb(f"ERROR: {e}")
        return False


def automaster_audio(settings: dict, status_callback=None,
                     config: ChainConfig | None = None, steps: int = 40,
                     device="cuda"):
    """Desktop automaster engine (the GUI's automaster tab, the CLI's
    ``automaster`` verb): fit the chain's slider subspace to the spectral
    profile and loudness of ``settings["reference_file"]`` by gradient
    descent (``models.automaster``, ``steps`` Adam steps on ``device``),
    then master ``input_file`` with the fitted settings through the
    streamed chain into ``output_file`` (``output_sample_rate`` and
    ``dither`` honoured).

    The contract of :func:`process_audio` (progress through
    ``status_callback``, ``Fitting i/steps: loss …`` for each step, a final
    message containing "complete" or "ERROR"); it returns the fitted
    settings dict, or None on failure, so the GUI can show the solved
    sliders.  Without a card on ``device`` it fails with an ``ERROR:``
    line naming it.
    """
    cb = status_callback or (lambda msg: None)
    try:
        in_path = settings.get("input_file")
        ref_path = settings.get("reference_file")
        out_path = settings.get("output_file")
        if not in_path or not ref_path or not out_path:
            cb("ERROR: input_file, reference_file and output_file "
               "must be set.")
            return None
        device = require_device(device, "automaster_audio")
        cb(f"Loading {os.path.basename(in_path)}...")
        audio, fs = wavio.read_audio(in_path)
        cb(f"Analyzing reference {os.path.basename(ref_path)}...")
        ref, ref_fs = wavio.read_audio(ref_path)

        from python_audio_mastering_tpu_torch.models import automaster

        cfg = _config_for(settings, fs, config)
        target_lufs = settings.get("lufs", -14.0)
        model = automaster.AutoMasterModel(
            config=cfg,
            target_lufs=-14.0 if target_lufs is None else float(target_lufs),
            device=device)
        target = automaster.spectral_profile(model.as_audio(ref), ref_fs)
        audio = np.asarray(audio, np.float32)
        params, _ = automaster.fit(
            model, audio, target, steps=steps,
            callback=lambda i, l: cb(f"Fitting {i + 1}/{steps}: "
                                     f"loss {l:.5f}"))
        fitted = params.to_settings()
        cb("Mastering with fitted settings...")
        out, _, _ = master_streamed(audio, MasteringParams.from_settings(fitted),
                                    cfg, progress_cb=cb, device=device)
        out, fs_out = _maybe_resample(out, fs, settings, cb, device)
        wavio.write_audio(out_path, out, fs_out,
                          dither=bool(settings.get("dither")))
        cb(f"Processing complete! Saved to {out_path}")
        return fitted
    except Exception as e:  # noqa: BLE001 — engine boundary: report, don't raise
        traceback.print_exc()
        cb(f"ERROR: {e}")
        return None


def batch_process_audio(settings: dict, input_folder: str, output_folder: str,
                        status_callback=None,
                        config: ChainConfig | None = None,
                        device="cuda") -> int:
    """Folder batch engine (GUI contract): every audio file of
    ``input_folder`` through :func:`process_audio` into
    ``{output_folder}/{base}_mastered{ext}``.  Returns the number of files
    mastered; a file that fails is reported with an ``ERROR:`` line and
    the loop goes on."""
    cb = status_callback or (lambda msg: None)
    try:
        files = sorted(
            f for f in os.listdir(input_folder)
            if os.path.splitext(f)[1].lower() in AUDIO_EXTENSIONS)
    except OSError as e:
        cb(f"ERROR: cannot read input folder: {e}")
        return 0
    if not files:
        cb("No audio files found in the input folder.")
        return 0
    os.makedirs(output_folder, exist_ok=True)
    done = 0
    for i, name in enumerate(files):
        cb(f"[{i + 1}/{len(files)}] {name}")
        base, ext = os.path.splitext(name)
        per_file = dict(settings)
        per_file["input_file"] = os.path.join(input_folder, name)
        per_file["output_file"] = os.path.join(output_folder,
                                               f"{base}_mastered{ext}")
        ok = process_audio(per_file, status_callback=lambda m: cb(f"  {m}"),
                           config=config, device=device)
        done += int(ok)
    cb(f"Batch processing complete! {done}/{len(files)} files mastered.")
    return done


def _upload_meters(store, output_key: str, meters: dict | None):
    """The sidecar ``{output}.meters.json``: the scalar R128 summary."""
    summary = meters_summary(meters)
    if summary is None:
        return
    store.upload(f"{output_key}.meters.json",
                 json.dumps(summary).encode("utf-8"),
                 content_type="application/json")


def process_audio_from_uri(uri: str, settings: dict,
                           store: store_mod.BlobStore | None = None,
                           config: ChainConfig | None = None,
                           progress_cb=None, transfer: str = "float32",
                           emit_meters: bool = True, device="cuda") -> str:
    """Cloud worker engine for any ``scheme://bucket/key`` URI.

    Returns the output key, ``processed/mastered_{basename}``.  Raises on
    failure (the worker layer owns the job-state policy), and before any
    download when ``device`` is a card that is not there.  ``emit_meters``
    uploads an R128 summary sidecar beside the audio.
    """
    device = require_device(device, "process_audio_from_uri")
    scheme, bucket, key = store_mod.parse_uri(uri)
    store = store or store_mod.get_store(f"{scheme}://{bucket}")
    print(f"Downloading file from {uri}...")
    audio, fs = wavio.decode_audio_bytes(store.download(key), name_hint=key)
    print("Processing audio in chunks...")
    res = _run_chain(audio, fs, settings, progress_cb=progress_cb or print,
                     config=config, return_meters=emit_meters,
                     transfer=transfer, device=device)
    out, meters = res if emit_meters else (res, None)
    out, fs = _maybe_resample(out, fs, settings, print, device)
    output_key = store_mod.output_key_for(uri)
    print(f"Exporting and uploading processed audio to {output_key}...")
    buf = io.BytesIO()
    wavio.write_wav(buf, out, fs, dither=bool(settings.get("dither")))
    store.upload(output_key, buf.getvalue(), content_type="audio/wav")
    _upload_meters(store, output_key, meters)
    store.upload(f"{output_key}.complete", b"")
    print(f"Completion flag created at {output_key}.complete")
    return output_key


def process_audio_from_gcs(gcs_uri: str, settings: dict, **kwargs) -> str:
    """The reference worker's name; takes ``local://`` URIs too."""
    return process_audio_from_uri(gcs_uri, settings, **kwargs)


def conform_album_tracks(loaded, names=None, progress_cb=None, device="cuda"):
    """Conform decoded tracks into one batchable album.

    ``loaded``: list of ``(audio (N, C), fs)``.  The album takes the
    highest rate present (a 48 kHz track is never downsampled because a
    lower-rate file sorted first); tracks at other rates are upsampled to
    it on ``device`` (``ops.resample``).  Mono tracks are upmixed by
    duplication to the album's channel count.  An explicit
    ``settings["output_sample_rate"]`` still converts each mastered output
    afterwards.  Returns ``(tracks, fs_album)``.
    """
    device = require_device(device, "conform_album_tracks")
    cb = progress_cb or print
    names = names or [f"track {i}" for i in range(len(loaded))]
    fs_album = max(fs for _, fs in loaded)
    channels = max(a.shape[1] if a.ndim == 2 else 1 for a, _ in loaded)
    tracks = []
    for (audio, fs), name in zip(loaded, names):
        if audio.ndim == 1:
            audio = audio[:, None]
        if fs != fs_album:
            cb(f"Resampling {name} {fs} -> {fs_album} Hz to batch the album")
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
            audio = rs.resample(x, fs, fs_album).cpu().numpy()
        if audio.shape[1] < channels:
            cb(f"Upmixing {name} {audio.shape[1]} -> {channels} channels")
            audio = np.concatenate(
                [audio] + [audio[:, -1:]] * (channels - audio.shape[1]),
                axis=1)
        tracks.append(audio)
    return tracks, fs_album


def _decode_album_blobs(blobs: list, keys: list, cb):
    """Decode album uploads, the multithreaded C++ loader first.

    * every blob a RIFF/WAVE of one (channels, rate): one
      ``io.native.decode_batch`` call;
    * every blob a RIFF/WAVE, formats mixed: per-track native decodes on
      a thread pool (``conform_album_tracks`` reconciles them);
    * anything else, or any native failure: ``wavio.decode_audio_bytes``
      per track (ffmpeg for non-WAV containers), threaded.

    Returns ``(loaded [(audio, fs)], used)``, ``used`` naming the path
    taken: ``"native_batch"``, ``"native"`` or ``"numpy"``.
    """
    from python_audio_mastering_tpu_torch.io import native

    workers = min(len(blobs), os.cpu_count() or 1)
    # RIFF alone is not WAV (AVI and WEBP share the container): gate on the
    # WAVE form type too
    is_wav = all(b[:4] == b"RIFF" and b[8:12] == b"WAVE" for b in blobs)
    if is_wav and native.available():
        try:
            infos = [native.probe(b) for b in blobs]
            if len({(i[0], i[1]) for i in infos}) == 1:
                cb(f"Decoding {len(blobs)} tracks via the native batch "
                   "decoder...")
                batch, lengths, rate = native.decode_batch(blobs)
                return [(batch[i, :int(lengths[i])], rate)
                        for i in range(len(blobs))], "native_batch"
            cb(f"Decoding {len(blobs)} mixed-format tracks via the native "
               "decoder (threaded)...")
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(native.decode_wav, blobs)), "native"
        except Exception as e:  # noqa: BLE001 — fall back per contract
            cb(f"Native decode failed ({e}); falling back to ffmpeg/numpy.")
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(
            lambda bk: wavio.decode_audio_bytes(bk[0], name_hint=bk[1]),
            zip(blobs, keys))), "numpy"


def process_album_from_uris(uris: list, settings: dict,
                            store: store_mod.BlobStore | None = None,
                            config: ChainConfig | None = None,
                            progress_cb=None, transfer: str = "float32",
                            checkpoint_dir: str | None = None,
                            checkpoint_every: int = 1,
                            emit_meters: bool = True, device="cuda") -> list:
    """Cloud album engine: every URI of one bucket mastered as one
    batched, chunked run on ``device`` (the card unless the caller passes
    ``device="cpu"``; raises before any download when that card is not
    there).

    Mixed-rate and mixed-channel uploads are conformed into one album
    (:func:`conform_album_tracks`).  ``transfer``: ``"float32"`` or
    ``"pcm16"``.  ``checkpoint_dir`` / ``checkpoint_every``: chunk-granular
    resume (``master_album_streamed``).  Each track's WAV, its
    ``.meters.json`` sidecar (``emit_meters``) and its ``.complete`` flag
    are uploaded from a pool as that track's readback lands.  Returns the
    output keys, in the order of ``uris``.
    """
    device = require_device(device, "process_album_from_uris")
    if not uris:
        raise ValueError("empty album job")
    cb = progress_cb or print
    buckets = {store_mod.parse_uri(u)[:2] for u in uris}
    if len(buckets) > 1:
        raise ValueError(f"album URIs span multiple buckets: {sorted(buckets)}")
    scheme, bucket = next(iter(buckets))
    store = store or store_mod.get_store(f"{scheme}://{bucket}")
    keys = [store_mod.parse_uri(uri)[2] for uri in uris]
    cb(f"Downloading {len(uris)} files from {scheme}://{bucket}...")
    with ThreadPoolExecutor(max_workers=min(len(keys), 8)) as ex:
        blobs = list(ex.map(store.download, keys))
    loaded, used = _decode_album_blobs(blobs, keys, cb)
    cb(f"Decoded {len(blobs)} files ({used}).")
    tracks, fs_album = conform_album_tracks(loaded, keys, cb, device)

    params = MasteringParams.from_settings(settings)
    cfg = _config_for(settings, fs_album, config)
    cb(f"Processing album of {len(tracks)} tracks in chunks...")

    def export(i, out, meters):
        out_arr, fs_out = _maybe_resample(out, fs_album, settings, cb, device)
        output_key = store_mod.output_key_for(uris[i])
        cb(f"Exporting and uploading processed audio to {output_key}...")
        buf = io.BytesIO()
        wavio.write_wav(buf, out_arr, fs_out,
                        dither=bool(settings.get("dither")))
        store.upload(output_key, buf.getvalue(), content_type="audio/wav")
        _upload_meters(store, output_key, meters)
        store.upload(f"{output_key}.complete", b"")
        return output_key

    with ThreadPoolExecutor(max_workers=min(len(uris), 8)) as export_pool:
        futs = {}

        def on_track_done(i, out, meters):
            futs[i] = export_pool.submit(export, i, out, meters)

        master_album_streamed(
            tracks, params, cfg, progress_cb=cb, transfer=transfer,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            return_meters=emit_meters, on_track_done=on_track_done,
            device=device)
        out_keys = [futs[i].result() for i in range(len(uris))]
    cb(f"Album complete: {len(out_keys)} files.")
    return out_keys
