"""Blob stores: the job data plane of the cloud engine.

Counterpart of ``python_audio_mastering_tpu.serving.store`` (pure Python;
the port keeps its own copy because importing the JAX package imports
jax).  Implementations:

* :class:`LocalFSBlobStore`: filesystem-backed, for tests, a local serving
  stack and the desktop engine.  Signed URLs are HMAC tokens with an
  expiry.
* :class:`GCSBlobStore`: a thin adapter over google-cloud-storage,
  available only where that package is installed.

URIs: ``local://bucket/key`` or ``gs://bucket/key``.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import tempfile
import time

__all__ = ["BlobStore", "LocalFSBlobStore", "GCSBlobStore", "parse_uri",
           "output_key_for", "get_store"]


def parse_uri(uri: str):
    """``scheme://bucket/key`` → (scheme, bucket, key)."""
    scheme, rest = uri.split("://", 1)
    bucket, key = rest.split("/", 1)
    return scheme, bucket, key


def output_key_for(uri: str) -> str:
    """The job-output naming contract: ``processed/mastered_{basename}``,
    one definition for the backend that answers polls and the worker that
    writes the blob."""
    _, _, key = parse_uri(uri)
    return f"processed/mastered_{os.path.basename(key)}"


class BlobStore:
    scheme = "abstract"

    def download(self, key: str) -> bytes:
        raise NotImplementedError

    def upload(self, key: str, data: bytes,
               content_type: str = "application/octet-stream"):
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError

    def uri(self, key: str) -> str:
        return f"{self.scheme}://{self.bucket}/{key}"

    def stat(self, key: str):
        """Cheap content-version fingerprint ``(size, version)`` or None
        (unknown): a re-uploaded blob must not match an old one."""
        return None

    def signed_put_url(self, key: str, expires_s: int = 900,
                       content_type=None) -> str:
        raise NotImplementedError

    def signed_get_url(self, key: str, expires_s: int = 3600) -> str:
        raise NotImplementedError


class LocalFSBlobStore(BlobStore):
    """Filesystem bucket with HMAC-"signed" URL tokens: the URLs are paths
    (``/blob/<key>?token=...&expires=...``) that the serving app itself
    answers, the local stand-in for GCS's signed PUT/GET URLs."""

    scheme = "local"

    def __init__(self, root: str, bucket: str = "audio-uploads", secret=None):
        self.root = root
        self.bucket = bucket
        self.secret = secret or os.environ.get("PAM_URL_SECRET", "dev-secret")
        os.makedirs(self._bucket_dir, exist_ok=True)

    @property
    def _bucket_dir(self):
        return os.path.join(self.root, self.bucket)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self._bucket_dir, key))
        if not path.startswith(os.path.abspath(self._bucket_dir) + os.sep) \
                and path != os.path.abspath(self._bucket_dir):
            path = os.path.join(self._bucket_dir, key.replace("/", "_"))
        return path

    def download(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def upload(self, key: str, data: bytes,
               content_type="application/octet-stream"):
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: .complete flags must never be partial

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str):
        if self.exists(key):
            os.remove(self._path(key))

    def stat(self, key: str):
        try:
            st = os.stat(self._path(key))
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)

    # -- signed URLs ------------------------------------------------------
    def _token(self, method: str, key: str, expires: int) -> str:
        msg = f"{method}:{self.bucket}:{key}:{expires}".encode()
        return hmac.new(self.secret.encode(), msg,
                        hashlib.sha256).hexdigest()[:32]

    def check_token(self, method: str, key: str, expires: str,
                    token: str) -> bool:
        try:
            exp = int(expires)
        except (TypeError, ValueError):
            return False
        if exp < time.time():
            return False
        return hmac.compare_digest(self._token(method, key, exp), token or "")

    def signed_put_url(self, key, expires_s=900, content_type=None):
        exp = int(time.time()) + expires_s
        return f"/blob/{key}?token={self._token('PUT', key, exp)}&expires={exp}"

    def signed_get_url(self, key, expires_s=3600):
        exp = int(time.time()) + expires_s
        return f"/blob/{key}?token={self._token('GET', key, exp)}&expires={exp}"


class GCSBlobStore(BlobStore):
    """google-cloud-storage adapter (cloud deployments only): a lazy
    client, V4 signed URLs, in-memory blob transfer."""

    scheme = "gs"

    def __init__(self, bucket: str, project=None, service_account_email=None):
        from google.cloud import storage  # deferred: cloud-only dependency

        self._client = storage.Client(project=project)
        self._bucket = self._client.bucket(bucket)
        self.bucket = bucket
        self.service_account_email = service_account_email

    def download(self, key):
        return self._bucket.blob(key).download_as_bytes()

    def upload(self, key, data, content_type="application/octet-stream"):
        self._bucket.blob(key).upload_from_string(data,
                                                  content_type=content_type)

    def exists(self, key):
        return self._bucket.blob(key).exists()

    def delete(self, key):
        self._bucket.blob(key).delete()

    def stat(self, key):
        blob = self._bucket.get_blob(key)
        if blob is None:
            return None
        return (blob.size, blob.generation)

    def signed_put_url(self, key, expires_s=900, content_type=None):
        import datetime

        return self._bucket.blob(key).generate_signed_url(
            version="v4", expiration=datetime.timedelta(seconds=expires_s),
            method="PUT", content_type=content_type,
            service_account_email=self.service_account_email)

    def signed_get_url(self, key, expires_s=3600):
        import datetime

        return self._bucket.blob(key).generate_signed_url(
            version="v4", expiration=datetime.timedelta(seconds=expires_s),
            method="GET", service_account_email=self.service_account_email)


def get_store(uri_or_scheme: str, **kwargs) -> BlobStore:
    """Factory from a URI scheme: ``local://`` or ``gs://``.  A local
    store's root is ``root=``, else ``$PAM_BLOB_ROOT``, else ``pam_blobs``
    in the temporary directory."""
    scheme = uri_or_scheme.split("://", 1)[0]
    probe = uri_or_scheme + ("/x" if uri_or_scheme.count("/") < 3 else "")
    if scheme == "local":
        _, bucket, _ = parse_uri(probe)
        root = kwargs.pop("root", os.environ.get(
            "PAM_BLOB_ROOT", os.path.join(tempfile.gettempdir(), "pam_blobs")))
        return LocalFSBlobStore(root, bucket=bucket, **kwargs)
    if scheme == "gs":
        _, bucket, _ = parse_uri(probe)
        return GCSBlobStore(bucket, **kwargs)
    raise ValueError(f"unknown blob scheme {scheme!r}")
