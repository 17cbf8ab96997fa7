"""Engine entry points of the port.

Counterpart of ``python_audio_mastering_tpu.engine`` for the desktop
single-file engine: ``process_audio(settings, callback)`` reads
``settings["input_file"]``, masters it through the streamed chain, writes
``settings["output_file"]``, reports progress through ``callback(msg)``
and ends with a message containing "complete" or "ERROR" (the GUI matches
on those words).  The batch, album, cloud-URI and automaster engines are
ROADMAP queue 1 items 4, 6 and 7.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS  # noqa: F401  (GUI re-export contract)
from python_audio_mastering_tpu_torch.parallel.streaming import master_streamed

__all__ = ["EQ_PRESETS", "default_config", "process_audio"]


def default_config(sample_rate: int) -> ChainConfig:
    """Throughput defaults (:meth:`ChainConfig.gpu_default`)."""
    return ChainConfig.gpu_default(sample_rate=sample_rate)


def _config_for(settings: dict, sample_rate: int,
                config: ChainConfig | None) -> ChainConfig:
    """The chain config for a job.  A truthy ``quality`` key asks for the
    lookahead true-peak limiter, which is not ported yet."""
    cfg = config or default_config(sample_rate)
    if settings.get("quality") and cfg.limiter_mode == "reference":
        cfg = dataclasses.replace(cfg, limiter_mode="lookahead_truepeak")
    return cfg


def _run_chain(audio: np.ndarray, sample_rate: int, settings: dict,
               progress_cb=None, config: ChainConfig | None = None,
               device="cuda"):
    params = MasteringParams.from_settings(settings)
    cfg = _config_for(settings, sample_rate, config)
    out, measured, gain_db = master_streamed(audio, params, cfg,
                                             progress_cb=progress_cb,
                                             device=device)
    if params.lufs_enabled and progress_cb:
        progress_cb(f"Current loudness: {measured:.2f} LUFS. "
                    f"Applying {gain_db:.2f} dB gain...")
    return out


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
        target_rate = settings.get("output_sample_rate")
        cb(f"Loading {os.path.basename(in_path)}...")
        audio, fs = wavio.read_audio(in_path)
        if target_rate and int(target_rate) != fs:
            raise NotImplementedError(
                "output_sample_rate: the resampler is ROADMAP queue 1 item 5")
        cb("Processing audio in chunks...")
        out = _run_chain(audio, fs, settings, progress_cb=cb, config=config,
                         device=device)
        cb("Exporting...")
        wavio.write_audio(out_path, out, fs,
                          dither=bool(settings.get("dither")))
        cb(f"Processing complete! Saved to {out_path}")
        return True
    except Exception as e:  # noqa: BLE001 — engine boundary: report, don't raise
        traceback.print_exc()
        cb(f"ERROR: {e}")
        return False
