"""Gunicorn entry points of the port: the backend, worker and monolith
WSGI apps, built from the environment (``wsgi:backend_app``,
``wsgi:worker_app``, ``wsgi:monolith_app``).

Counterpart of ``python_audio_mastering_tpu.serving.wsgi``, with every
app from the port (its jobs on the card).  Env vars (the reference's
names, backend/app.py:20-22, worker/main.py:54):

* ``GCS_BUCKET_NAME`` — bucket (default ``audio-uploads``)
* ``PAM_STORE`` — ``local`` (default; blobs under ``PAM_BLOB_ROOT``) or ``gs``
* ``GCP_PROJECT_ID`` / ``PUB_SUB_TOPIC`` — Pub/Sub publishing (gs mode)
* ``PAM_BLOB_ROOT`` — local blob root (default ``pam_blobs`` in the
  temporary directory)

``backend_app``: in local mode jobs are consumed in-process by a
``LocalQueue`` worker thread (a single-container deployment); in gs mode
they publish to Pub/Sub, for a separate worker deployment.  Each app is
built at its first lookup, so importing this module starts nothing.
"""

from __future__ import annotations

import os
import tempfile

from python_audio_mastering_tpu_torch.serving.store import (
    GCSBlobStore,
    LocalFSBlobStore,
)

_APPS = {}


def _mode():
    return os.environ.get("PAM_STORE", "local")


def _store():
    bucket = os.environ.get("GCS_BUCKET_NAME", "audio-uploads")
    if _mode() == "gs":
        return GCSBlobStore(
            bucket, project=os.environ.get("GCP_PROJECT_ID"),
            service_account_email=os.environ.get("SERVICE_ACCOUNT_EMAIL"))
    return LocalFSBlobStore(
        os.environ.get("PAM_BLOB_ROOT",
                       os.path.join(tempfile.gettempdir(), "pam_blobs")),
        bucket=bucket)


def _publisher(store):
    if _mode() == "gs":
        from python_audio_mastering_tpu_torch.serving.jobqueue import (
            PubSubQueue,
        )

        return PubSubQueue(os.environ["GCP_PROJECT_ID"],
                           os.environ.get("PUB_SUB_TOPIC",
                                          "mastering-jobs")).publish
    from python_audio_mastering_tpu_torch.serving.jobqueue import LocalQueue
    from python_audio_mastering_tpu_torch.serving.worker import make_consumer

    q = LocalQueue(consumer=make_consumer(store))
    q.start()
    return q.publish


def _backend_app():
    from python_audio_mastering_tpu_torch.serving.backend import (
        make_backend_app,
    )

    store = _store()
    return make_backend_app(store, _publisher(store))


def _worker_app():
    from python_audio_mastering_tpu_torch.serving.worker import (
        make_worker_app,
    )

    return make_worker_app(_store())


def _monolith_app():
    from python_audio_mastering_tpu_torch.serving.monolith import (
        make_monolith_app,
    )

    return make_monolith_app(_store())


_BUILDERS = {"backend_app": _backend_app, "worker_app": _worker_app,
             "monolith_app": _monolith_app}


def __getattr__(name):
    if name not in _BUILDERS:
        raise AttributeError(name)
    if name not in _APPS:
        _APPS[name] = _BUILDERS[name]()
    return _APPS[name]
