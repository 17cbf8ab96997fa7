"""The port's monolith service (``serving.monolith``: the legacy chain
behind the reference's all-in-one cloud function), its backend and its
WSGI entry points, on a local blob store with ``device="cpu"``.

The port's copies of tests/test_serving.py::test_monolith_legacy_contract
and tests/test_codecs.py::test_monolith_exports_original_container, the
monolith's output against the port's legacy ``master_streamed`` within
3.052e-5 (the 16-bit write: one LSB), and the serving modules imported
with jax unavailable (the card's machine has none).
"""

import io
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.parallel.streaming import (
    master_streamed,
)
from python_audio_mastering_tpu_torch.serving import monolith
from python_audio_mastering_tpu_torch.serving.jobqueue import encode_envelope
from python_audio_mastering_tpu_torch.serving.store import LocalFSBlobStore

from .conftest import make_signal
from .test_codecs import FAKE_FFMPEG

FS = 44100
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav_bytes(seconds=0.5):
    x = (make_signal(int(FS * seconds)) * 0.4).astype(np.float32)
    buf = io.BytesIO()
    wavio.write_wav(buf, x, FS, float_format=True)
    return buf.getvalue(), x


def _call(app, payload):
    """POST ``payload`` (bytes) to ``app`` at ``/``: ``(status, body)``."""
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])

    env = {"REQUEST_METHOD": "POST", "PATH_INFO": "/", "QUERY_STRING": "",
           "CONTENT_LENGTH": str(len(payload)),
           "CONTENT_TYPE": "application/json",
           "wsgi.input": io.BytesIO(payload)}
    body = b"".join(app(env, start_response))
    return out["status"], body


def test_monolith_legacy_contract(tmp_path):
    """The monolith's wire schema (main.py:16-91): bucket/file payload,
    the processed/ self-trigger guard, no mastered_ prefix, 'done' flag
    content."""
    store = LocalFSBlobStore(str(tmp_path), bucket="mono")
    store.upload("uploads/beat.wav", _wav_bytes(0.5)[0])
    app = monolith.make_monolith_app(
        store, config=ChainConfig(sample_rate=FS, variant="legacy"),
        device="cpu")
    envelope = encode_envelope({
        "bucket_name": "mono", "file_name": "uploads/beat.wav",
        "settings": {"saturation": 10, "lufs": -15.0,
                     "use_multiband": False}})
    status, _ = _call(app, json.dumps(envelope).encode())
    assert status == 200
    assert store.exists("processed/beat.wav")
    assert store.download("processed/beat.wav.complete") == b"done"

    envelope = encode_envelope({
        "bucket_name": "mono", "file_name": "processed/beat.wav",
        "settings": {}})
    status, _ = _call(app, json.dumps(envelope).encode())
    assert status == 200
    assert not store.exists("processed/processed/beat.wav")

    status, body = _call(app, b'{"x": 1}')
    assert status == 400 and b"Invalid Pub/Sub message format" in body


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    script = tmp_path / "fake_ffmpeg"
    script.write_text(FAKE_FFMPEG.format(python=sys.executable))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(wavio, "_ffmpeg", lambda: str(script))
    return script


def test_monolith_exports_original_container(fake_ffmpeg, tmp_path):
    """main.py:74-75: the output container is the input's extension, the
    key keeps the original basename (processed/x.mp3)."""
    store = LocalFSBlobStore(str(tmp_path / "blobs"), bucket="b")
    blob, _ = _wav_bytes()
    store.upload("x.mp3", b"FAKE" + blob, content_type="audio/mpeg")
    key = monolith.run_legacy_job(
        store, "x.mp3", {"saturation": 10, "lufs": -14.0},
        config=ChainConfig(sample_rate=FS, variant="legacy"), device="cpu")
    assert key == "processed/x.mp3"
    payload = store.download(key)
    assert payload.startswith(b"FAKE")
    out, fs = wavio.read_wav(payload[4:])
    assert fs == FS and np.isfinite(out).all()
    assert store.download(f"{key}.complete") == b"done"
    assert wavio.audio_content_type("mp3") == "audio/mpeg"


@pytest.mark.parametrize("multiband", [False, True])
def test_monolith_output_is_master_streamed(tmp_path, multiband):
    """Under its default ``legacy_config`` (``gpu_default``, legacy) the
    job's 16-bit WAV equals the port's legacy ``master_streamed`` of the
    decoded upload within one LSB."""
    store = LocalFSBlobStore(str(tmp_path), bucket="mono")
    blob, _ = _wav_bytes(1.0)
    store.upload("in/song.wav", blob)
    settings = {"saturation": 20, "preset": "techno", "width": 1.3,
                "lufs": -14.0, "use_multiband": multiband}
    key = monolith.run_legacy_job(store, "in/song.wav", settings,
                                  device="cpu")
    out, fs = wavio.read_wav(store.download(key))
    x, _ = wavio.read_wav(blob)
    cfg = monolith.legacy_config(fs)
    assert cfg.variant == "legacy" and cfg == ChainConfig(
        sample_rate=fs, variant="legacy", block_size=384, comp_hop=8,
        comp_block_ctrl=2048)
    ref, _, _ = master_streamed(x, MasteringParams.from_settings(settings),
                                cfg, device="cpu")
    assert np.abs(out - ref).max() <= 3.052e-5


def test_serving_imports_without_jax(tmp_path):
    """``serving.backend``, ``serving.wsgi`` and ``serving.monolith``
    import with jax unavailable, and the WSGI module builds its apps at
    their first lookup (the monolith's here, on a local store under
    ``PAM_BLOB_ROOT``), from the port."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from python_audio_mastering_tpu_torch.serving import backend, "
        "monolith, wsgi\n"
        "app = wsgi.monolith_app\n"
        "assert app is wsgi.monolith_app and app.name == 'pam-monolith'\n"
        "assert not any(m == 'python_audio_mastering_tpu' or "
        "m.startswith('python_audio_mastering_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    env = {**os.environ, "PAM_BLOB_ROOT": str(tmp_path), "PAM_STORE": "local",
           "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
