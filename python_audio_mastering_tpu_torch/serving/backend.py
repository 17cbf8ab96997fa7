"""The public API server — wire-compatible with the reference backend.

Counterpart of ``python_audio_mastering_tpu_torch.serving.backend`` (pure
Python; the port keeps its own copy, and of ``frontend.html``, because
importing the JAX package imports jax).  Its jobs go to the port's
worker (``serving.worker``).

Endpoints (backend/app.py:36-135):

* ``GET  /``                    → health text
* ``POST /generate-upload-url`` → ``{url, gcs_uri}``
* ``POST /start-processing``    → ``{message, processed_filename}``
* ``GET  /status?filename=``    → ``{status: processing|done|error, ...}``

plus, in local mode, the blob routes that stand in for GCS signed URLs:

* ``PUT/GET /blob/<key>`` with ``token``/``expires`` query params.

Improvements over the reference (documented in DESIGN.md): a ``failed``
job state — the reference's workers swallow errors and the client polls
forever (worker/main.py:46-50, backend/app.py:114-117); here a worker
failure writes a ``.failed`` flag that /status surfaces as
``{"status": "error"}``.
"""

from __future__ import annotations

import os
import tempfile

from python_audio_mastering_tpu_torch.serving import store as store_mod
from python_audio_mastering_tpu_torch.serving.http import (
    App,
    json_response,
    text_response,
)
from python_audio_mastering_tpu_torch.serving.store import (
    BlobStore,
    LocalFSBlobStore,
)

__all__ = ["make_backend_app"]


def make_backend_app(store: BlobStore, publish, upload_expiry_s: int = 900,
                     download_expiry_s: int = 3600) -> App:
    """Build the WSGI app over a blob store and a ``publish(payload)`` fn."""
    app = App("pam-backend")
    local = isinstance(store, LocalFSBlobStore)

    @app.route("/")
    def health(req):
        return text_response("Audio Mastering Backend is running.")

    @app.route("/app")
    def frontend(req):
        page = os.path.join(os.path.dirname(__file__), "frontend.html")
        with open(page, "rb") as f:
            return text_response(f.read(), content_type="text/html")

    @app.route("/generate-upload-url", methods=["POST"])
    def generate_upload_url(req):
        data = req.get_json()
        if not data or "filename" not in data:
            return json_response({"error": "Filename not provided"}, 400)
        filename = data["filename"]
        url = store.signed_put_url(filename, expires_s=upload_expiry_s,
                                  content_type=data.get("contentType"))
        return json_response({"url": url, "gcs_uri": store.uri(filename)})

    @app.route("/start-processing", methods=["POST"])
    def start_processing(req):
        data = req.get_json()
        if not data or "settings" not in data or \
                ("gcs_uri" not in data and "gcs_uris" not in data):
            return json_response({"error": "Missing GCS URI or settings"}, 400)
        if "gcs_uris" in data:
            # album job (framework extension): one batched device call,
            # per-file outputs — clients poll each filename as usual.
            # Validate BEFORE publishing: a string (iterates per char) or
            # an empty list would otherwise become an unusable queued job
            # behind a misleading 200.
            uris = data["gcs_uris"]
            if (not isinstance(uris, (list, tuple)) or not uris
                    or not all(isinstance(u, str) and "://" in u
                               for u in uris)):
                return json_response(
                    {"error": "gcs_uris must be a non-empty list of URIs"},
                    400)
            # Output keys derive from basenames, so two same-named files in
            # one album would collide: the second would overwrite the
            # first's upload AND output blob, and the client would poll one
            # key twice.  Reject up front rather than corrupt silently.
            out_names = [store_mod.output_key_for(u) for u in uris]
            if len(set(out_names)) != len(out_names):
                dupes = sorted({n for n in out_names
                                if out_names.count(n) > 1})
                return json_response(
                    {"error": "duplicate filenames in album job: "
                              + ", ".join(dupes)}, 400)
            publish(data)
            return json_response({
                "message": "Processing job started.",
                "processed_filenames": out_names})
        publish(data)
        original = data["settings"].get("original_filename", "unknown.wav")
        processed = f"processed/mastered_{original}"
        return json_response({"message": "Processing job started.",
                              "processed_filename": processed})

    @app.route("/status")
    def get_status(req):
        filename = req.query.get("filename")
        if not filename:
            return json_response({"error": "Filename parameter is required"}, 400)
        if store.exists(f"{filename}.failed"):
            try:
                detail = store.download(f"{filename}.failed").decode("utf-8", "replace")
            except Exception:
                detail = "processing failed"
            return json_response({"status": "error", "message": detail})
        if not store.exists(f"{filename}.complete"):
            return json_response({"status": "processing"})
        if not store.exists(filename):
            return json_response(
                {"status": "error",
                 "message": "Processing complete but output file is missing."}, 404)
        url = store.signed_get_url(filename, expires_s=download_expiry_s)
        payload = {"status": "done", "download_url": url}
        # R128 telemetry sidecar uploaded by the worker (engine._upload_
        # meters): surfaced inline so clients get LUFS/LRA/true-peak with
        # the download link (the reference logs one LUFS line server-side
        # and discards it, engine:221)
        if store.exists(f"{filename}.meters.json"):
            try:
                import json as _json

                payload["meters"] = _json.loads(
                    store.download(f"{filename}.meters.json"))
            except Exception:  # noqa: BLE001 — telemetry must not block downloads
                pass
        return json_response(payload)

    if local:
        @app.route("/blob/<path:key>", methods=["PUT", "GET"])
        def blob(req, key):
            if not store.check_token(req.method, key, req.query.get("expires"),
                                     req.query.get("token")):
                return json_response({"error": "invalid or expired token"}, 403)
            if req.method == "PUT":
                store.upload(key, req.body,
                             content_type=req.headers.get("content-type",
                                                          "application/octet-stream"))
                return json_response({"ok": True})
            if not store.exists(key):
                return json_response({"error": "not found"}, 404)
            ctype = "audio/wav" if key.endswith(".wav") else "application/octet-stream"
            return text_response(store.download(key), content_type=ctype)

    return app


def main(device="cuda"):  # pragma: no cover — manual serving entry point
    """Serve the job API with a local queue whose worker masters on
    ``device`` (the card by default)."""
    from wsgiref.simple_server import make_server

    from python_audio_mastering_tpu_torch.serving.jobqueue import LocalQueue
    from python_audio_mastering_tpu_torch.serving.worker import make_consumer

    root = os.environ.get("PAM_BLOB_ROOT",
                          os.path.join(tempfile.gettempdir(), "pam_blobs"))
    bucket = os.environ.get("GCS_BUCKET_NAME", "audio-uploads")
    store = LocalFSBlobStore(root, bucket=bucket)
    q = LocalQueue(consumer=make_consumer(store, device=device))
    q.start()
    app = make_backend_app(store, q.publish)
    port = int(os.environ.get("PORT", 8080))
    print(f"pam backend listening on :{port} (blobs at {root}/{bucket})")
    make_server("0.0.0.0", port, app).serve_forever()


if __name__ == "__main__":
    main()
