"""Serving layer of the port: the blob stores, the job queues, the backend
and worker WSGI apps of the cloud engine, and the monolith service."""

from python_audio_mastering_tpu_torch.serving.store import (
    BlobStore,
    GCSBlobStore,
    LocalFSBlobStore,
    get_store,
    parse_uri,
)
from python_audio_mastering_tpu_torch.serving.jobqueue import (
    LocalQueue,
    PubSubQueue,
    decode_envelope,
    encode_envelope,
)
from python_audio_mastering_tpu_torch.serving.backend import make_backend_app
from python_audio_mastering_tpu_torch.serving.worker import (
    make_consumer,
    make_worker_app,
    run_job,
)

__all__ = ["BlobStore", "LocalFSBlobStore", "GCSBlobStore", "parse_uri",
           "get_store", "LocalQueue", "PubSubQueue", "encode_envelope",
           "decode_envelope", "make_backend_app", "make_worker_app",
           "make_consumer", "run_job"]
