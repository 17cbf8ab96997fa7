"""Job queues: the control plane (reference: Pub/Sub + Eventarc push).

Counterpart of ``python_audio_mastering_tpu.serving.jobqueue`` (pure
Python; the port keeps its own copy because importing the JAX package
imports jax).

The reference publishes ``{gcs_uri, settings}`` JSON to a Pub/Sub topic
(backend/app.py:84-90) which Eventarc POSTs to the worker as a base64
envelope (worker/main.py:21-29).  Implementations here:

* :class:`LocalQueue` — in-process thread queue driving a worker callback;
  the single-machine serving stack and tests.
* :class:`PubSubQueue` — google-cloud-pubsub publisher adapter (cloud only).

Envelope helpers reproduce the Pub/Sub wire format exactly so the worker's
push endpoint is wire-compatible with Eventarc.
"""

from __future__ import annotations

import base64
import json
import queue
import threading

__all__ = ["LocalQueue", "PubSubQueue", "encode_envelope", "decode_envelope"]


def encode_envelope(payload: dict) -> dict:
    """Wrap a job payload as a Pub/Sub push envelope (worker/main.py:28)."""
    data = base64.b64encode(json.dumps(payload).encode("utf-8")).decode("ascii")
    return {"message": {"data": data}}


def decode_envelope(envelope: dict) -> dict:
    if not envelope or "message" not in envelope:
        raise ValueError("Invalid Pub/Sub message format")
    raw = base64.b64decode(envelope["message"]["data"]).decode("utf-8")
    return json.loads(raw)


class LocalQueue:
    """In-process queue + daemon consumer thread.

    ``consumer(payload)`` is invoked per job.  Mirrors the reference's
    poison-message policy deliberately *fixed*: the consumer's exceptions
    are caught and reported through ``on_error`` (the reference ACKs and
    silently drops failures, worker/main.py:46-50)."""

    def __init__(self, consumer=None, on_error=None):
        self._q = queue.Queue()
        self._consumer = consumer
        self._on_error = on_error
        self._thread = None
        self._stop = threading.Event()

    def publish(self, payload: dict):
        self._q.put(payload)

    def start(self):
        if self._thread:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    payload = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    self._consumer(payload)
                except Exception as e:  # noqa: BLE001 — job isolation
                    if self._on_error:
                        self._on_error(payload, e)
                finally:
                    self._q.task_done()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def join(self):
        self._q.join()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None


class PubSubQueue:
    """google-cloud-pubsub publisher (cloud only; consumption is push-based
    via the worker's HTTP endpoint, as in the reference)."""

    def __init__(self, project: str, topic: str):
        from google.cloud import pubsub_v1  # deferred: cloud-only dependency

        self._publisher = pubsub_v1.PublisherClient()
        self._topic_path = self._publisher.topic_path(project, topic)

    def publish(self, payload: dict):
        future = self._publisher.publish(
            self._topic_path, json.dumps(payload).encode("utf-8"))
        future.result()  # block like the reference (backend/app.py:90)
