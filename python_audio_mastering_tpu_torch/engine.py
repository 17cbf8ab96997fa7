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
  ``{output}.meters.json`` and a ``.complete`` flag.

The settings keys beyond the chain's: ``quality`` (truthy: the lookahead
true-peak limiter), ``output_sample_rate`` and ``dither``.  Every entry
runs on the card unless the caller passes ``device="cpu"``.  The album
and automaster engines are ROADMAP queue 1 items 5 and 6.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import traceback

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.models.chain import require_device
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS  # noqa: F401  (GUI re-export contract)
from python_audio_mastering_tpu_torch.ops import resample as rs
from python_audio_mastering_tpu_torch.parallel.streaming import master_streamed
from python_audio_mastering_tpu_torch.serving import store as store_mod

__all__ = ["EQ_PRESETS", "default_config", "process_audio",
           "batch_process_audio", "process_audio_from_gcs",
           "process_audio_from_uri", "meters_summary", "AUDIO_EXTENSIONS"]

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
