"""The monolith service of the legacy chain (reference main.py:16-91), on
the port.

Counterpart of ``python_audio_mastering_tpu.serving.monolith``.  The
reference's older all-in-one cloud function has its own wire schema and
engine: the envelope payload is ``{bucket_name, file_name, settings}``,
files already under ``processed/`` are skipped (the self-trigger guard,
main.py:34-36), the output key is ``processed/{basename}``, the export
keeps the source's container (main.py:74-75), the ``.complete`` flag
holds ``done`` (main.py:84), and the DSP is the legacy chain
(``ChainConfig(variant="legacy")``), streamed.  Jobs run on the card
unless the app was made with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.parallel.streaming import master_streamed
from python_audio_mastering_tpu_torch.serving.http import App, text_response
from python_audio_mastering_tpu_torch.serving.jobqueue import decode_envelope
from python_audio_mastering_tpu_torch.serving.store import BlobStore

__all__ = ["make_monolith_app", "run_legacy_job", "legacy_config"]


def legacy_config(sample_rate: int) -> ChainConfig:
    """``ChainConfig.gpu_default`` with the legacy chain."""
    return dataclasses.replace(ChainConfig.gpu_default(sample_rate),
                               variant="legacy")


def run_legacy_job(store: BlobStore, file_name: str, settings: dict,
                   config: ChainConfig | None = None,
                   device="cuda") -> str:
    """Process one legacy-schema job on ``device``; returns the output
    key."""
    blob = store.download(file_name)
    audio, fs = wavio.decode_audio_bytes(blob, name_hint=file_name)
    params = MasteringParams.from_settings(settings)
    out, _, _ = master_streamed(audio, params, config or legacy_config(fs),
                                device=device)
    output_key = f"processed/{os.path.basename(file_name)}"
    fmt = os.path.splitext(file_name)[1].lstrip(".") or "wav"
    store.upload(output_key, wavio.encode_audio_bytes(out, fs, fmt),
                 content_type=wavio.audio_content_type(fmt))
    store.upload(f"{output_key}.complete", b"done")
    return output_key


def make_monolith_app(store: BlobStore, config: ChainConfig | None = None,
                      device="cuda") -> App:
    """The monolith's push endpoint (``POST /`` with the base64 Pub/Sub
    envelope of a ``{bucket_name, file_name, settings}`` payload)."""
    app = App("pam-monolith")

    @app.route("/", methods=["POST"])
    def process_mastering(req):
        try:
            data = decode_envelope(req.get_json())
        except (ValueError, KeyError, TypeError):
            return text_response("Bad Request: Invalid Pub/Sub message format",
                                 400)
        file_name = data.get("file_name")
        settings = data.get("settings", {})
        if not file_name or data.get("bucket_name") is None:
            return text_response("Bad Request: missing bucket/file", 400)
        if "processed/" in file_name:
            return text_response("OK", 200)   # the self-trigger guard
        run_legacy_job(store, file_name, settings, config=config,
                       device=device)
        return text_response("OK", 200)

    return app
