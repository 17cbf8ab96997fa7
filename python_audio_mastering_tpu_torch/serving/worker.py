"""The processing worker of the port: a queue consumer and a
Pub/Sub-push-compatible endpoint over the port's engine.

Counterpart of ``python_audio_mastering_tpu.serving.worker`` (which
imports the JAX engine).  Two ways to consume jobs:

* :func:`make_consumer` — a callback for ``serving.jobqueue.LocalQueue``;
* :func:`make_worker_app` — an HTTP push endpoint taking the base64
  Pub/Sub envelope as Eventarc delivers it.

Every job runs on the card unless the worker was made with
``device="cpu"``.  A job that fails after its bounded retries writes a
``{output}.failed`` flag blob with the error, so a client polling for it
sees the failure (the reference acknowledges and drops failed jobs).
Jobs are idempotent (deterministic output keys), so retrying is safe.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import traceback

from python_audio_mastering_tpu_torch import engine
from python_audio_mastering_tpu_torch.serving import store as store_mod
from python_audio_mastering_tpu_torch.serving.http import App, text_response
from python_audio_mastering_tpu_torch.serving.jobqueue import decode_envelope
from python_audio_mastering_tpu_torch.serving.store import BlobStore

__all__ = ["make_consumer", "make_worker_app", "run_job", "job_options"]


def job_options() -> dict:
    """The job path's deployment knobs, read per job from the environment:

    * ``PAM_TRANSFER`` = ``pcm16`` (default) | ``float32`` — the host ↔
      device wire (pcm16: half the bytes, at the 16-bit export's floor);
    * ``PAM_CHECKPOINT`` = ``off`` (default) | ``sync`` | ``every_n[:N]``
      — chunk-granular album checkpoints (``PAM_CHECKPOINT_N`` sets N
      when ``every_n`` has none, default 4); off, a failed album is
      retried from its start;
    * ``PAM_METERS`` = ``1`` (default) | ``0`` — upload the R128 summary
      sidecar ``{output}.meters.json`` per file.
    """
    transfer = os.environ.get("PAM_TRANSFER", "pcm16").strip().lower()
    if transfer not in ("pcm16", "float32"):
        transfer = "pcm16"
    ck = os.environ.get("PAM_CHECKPOINT", "off").strip().lower()
    if ck in ("on", "sync", "1", "true"):
        every = 1
    elif ck.startswith("every_n"):
        try:
            every = int(ck.split(":", 1)[1]) if ":" in ck else \
                int(os.environ.get("PAM_CHECKPOINT_N", "4"))
        except ValueError:
            every = 4
        every = max(1, every)
    else:
        every = 0
    meters = os.environ.get("PAM_METERS", "1").strip().lower() \
        not in ("0", "false", "off", "no")
    return {"transfer": transfer, "checkpoint_every": every,
            "emit_meters": meters}


def _album_job_id(uris, settings, store) -> str:
    """Checkpoint key of an album job: its URIs, settings and each blob's
    version (``store.stat``), so a resubmission with other sliders or
    re-uploaded audio never resumes chunks mastered from the old ones."""
    h = hashlib.sha1("\n".join(uris).encode())
    h.update(json.dumps(settings, sort_keys=True, default=str).encode())
    for u in uris:
        try:
            h.update(repr(store.stat(store_mod.parse_uri(u)[2])).encode())
        except Exception:  # noqa: BLE001 — stat is best-effort
            h.update(b"?")
    return h.hexdigest()[:16]


def run_job(payload: dict, store: BlobStore, max_retries: int = 1,
            config=None, device="cuda"):
    """Run one mastering job with bounded retries and a failure flag.

    Two payload shapes: ``{gcs_uri, settings}`` (the reference wire) or
    ``{gcs_uris: [...], settings}``, an album mastered as one batched
    chunked run with per-file outputs and ``.complete`` flags.  The
    transfer format, checkpoint cadence and meter sidecars come from
    :func:`job_options`.  Returns the output key (a list for an album);
    raises after writing the ``.failed`` flags when every attempt failed
    (without a card on ``device``, every attempt does)."""
    uris = payload.get("gcs_uris")
    gcs_uri = payload.get("gcs_uri")
    settings = payload.get("settings")
    if (not gcs_uri and not uris) or not settings:
        raise ValueError(f"Missing GCS URI or settings in job data: {payload}")
    # one malformed URI must not keep the others' .failed flags from
    # being written (their clients would poll forever)
    out_keys, bad_uri_err = [], None
    for u in (uris or [gcs_uri]):
        try:
            out_keys.append(store_mod.output_key_for(u))
        except Exception as e:  # noqa: BLE001 — malformed client input
            bad_uri_err = ValueError(f"malformed job URI {u!r}: {e}")
    if bad_uri_err is not None:
        for k in out_keys:
            store.upload(f"{k}.failed", str(bad_uri_err).encode("utf-8"))
        raise bad_uri_err
    opts = job_options()
    ckpt_dir = None
    if uris and opts["checkpoint_every"] > 0:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "pam_album_ckpt",
                                _album_job_id(uris, settings, store))
    last = None
    for attempt in range(max_retries + 1):
        try:
            if uris:
                engine.process_album_from_uris(
                    uris, settings, store=store, config=config,
                    transfer=opts["transfer"], checkpoint_dir=ckpt_dir,
                    checkpoint_every=max(1, opts["checkpoint_every"]),
                    emit_meters=opts["emit_meters"], device=device)
                if ckpt_dir:
                    shutil.rmtree(ckpt_dir, ignore_errors=True)
            else:
                engine.process_audio_from_uri(
                    gcs_uri, settings, store=store, config=config,
                    transfer=opts["transfer"],
                    emit_meters=opts["emit_meters"], device=device)
            for k in out_keys:
                store.delete(f"{k}.failed")
            return out_keys if uris else out_keys[0]
        except Exception as e:  # noqa: BLE001 — job isolation
            last = e
            print(f"Job attempt {attempt + 1} failed for "
                  f"{uris or gcs_uri}: {e}")
            traceback.print_exc()
    for k in out_keys:
        store.upload(f"{k}.failed", str(last).encode("utf-8"))
    raise last


def make_consumer(store: BlobStore, max_retries: int = 1, config=None,
                  device="cuda"):
    """A ``LocalQueue`` consumer running :func:`run_job` per payload."""
    def consume(payload: dict):
        run_job(payload, store, max_retries=max_retries, config=config,
                device=device)

    return consume


def make_worker_app(store: BlobStore, max_retries: int = 1, config=None,
                    device="cuda") -> App:
    """The Pub/Sub push endpoint (``POST /`` with the base64 envelope)."""
    app = App("pam-worker")

    @app.route("/", methods=["POST"])
    def process_mastering_job(req):
        try:
            payload = decode_envelope(req.get_json())
        except (ValueError, KeyError, TypeError):
            return text_response("Bad Request: invalid Pub/Sub message format",
                                 400)
        target = payload.get("gcs_uri") or payload.get("gcs_uris")
        if not target or not payload.get("settings"):
            return text_response("Bad Request: missing GCS URI or settings",
                                 400)
        try:
            run_job(payload, store, max_retries=max_retries, config=config,
                    device=device)
        except Exception:  # noqa: BLE001
            # acknowledge, so the queue does not redeliver a poison
            # message; the .failed flag keeps the job observable
            pass
        return text_response("", 204)

    return app
