"""The port's album engine, job worker and their host I/O on a local blob
store (``engine.process_album_from_uris``, ``serving.worker``,
``io.native``, ``serving.http``/``jobqueue``).

Outputs are 16-bit WAVs: each equals the port's ``master_streamed`` of
its conformed track within 2e-4 (the JAX chain budget,
test_pallas_multiband.py:269, which covers the 16-bit truncation)."""

import io
import json
import os

import numpy as np
import pytest

from python_audio_mastering_tpu_torch import MasteringParams
from python_audio_mastering_tpu_torch import engine
from python_audio_mastering_tpu_torch.io import native, wavio
from python_audio_mastering_tpu_torch.parallel.streaming import (
    master_streamed,
)
from python_audio_mastering_tpu_torch.serving import worker
from python_audio_mastering_tpu_torch.serving.jobqueue import (
    LocalQueue,
    encode_envelope,
)
from python_audio_mastering_tpu_torch.serving.store import LocalFSBlobStore

from .conftest import make_signal

SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
# a 44.1 kHz stereo, a 48 kHz stereo, a mono and a 16-bit file
FILES = (("a.wav", 44100, 2, 1.3, True), ("b.wav", 48000, 2, 1.7, True),
         ("c.wav", 48000, 1, 1.1, True), ("d.wav", 48000, 2, 1.5, False))
PAM_ENV = ("PAM_TRANSFER", "PAM_CHECKPOINT", "PAM_CHECKPOINT_N",
           "PAM_METERS")


def _wav(x, fs, float_format):
    buf = io.BytesIO()
    wavio.write_wav(buf, x, fs, float_format=float_format)
    return buf.getvalue()


def _store(tmp_path, files=FILES):
    store = LocalFSBlobStore(str(tmp_path), bucket="jobs")
    for k, (name, fs, ch, sec, flt) in enumerate(files):
        x = make_signal(int(fs * sec), channels=ch, fs=fs, seed=50 + k) * 0.5
        store.upload(f"uploads/{name}", _wav(x.astype(np.float32), fs, flt))
    return store, [f"local://jobs/uploads/{f[0]}" for f in files]


def _conformed(store, uris):
    loaded = [wavio.read_wav(store.download(u.split("/", 3)[3]))
              for u in uris]
    return engine.conform_album_tracks(loaded, progress_cb=lambda m: None,
                                       device="cpu")


@pytest.fixture
def clean_env(monkeypatch):
    for k in PAM_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _check_outputs(store, uris, keys, settings, transfer):
    tracks, fs = _conformed(store, uris)
    assert fs == 48000 and all(t.shape[1] == 2 for t in tracks)
    params = MasteringParams.from_settings(settings)
    for uri, key, x in zip(uris, keys, tracks):
        assert key == f"processed/mastered_{os.path.basename(uri)}"
        assert store.exists(f"{key}.complete")
        assert not store.exists(f"{key}.failed")
        side = json.loads(store.download(f"{key}.meters.json"))
        assert abs(side["integrated_lufs"] - settings["lufs"]) <= 1e-2
        y, fs_out = wavio.read_wav(store.download(key))
        cfg = engine._config_for(settings, fs, None)
        ref, _, _ = master_streamed(x, params, cfg, transfer=transfer,
                                    device="cpu")
        assert fs_out == fs and y.shape == x.shape
        assert np.max(np.abs(y - ref)) <= 2e-4


def test_process_album_from_uris_local(tmp_path):
    """Mixed rates and channel counts conform to 48 kHz stereo (the
    44.1 kHz file resampled, the mono one upmixed), decoded by the native
    decoder when it builds, mastered in quality mode; per file a blob, a
    sidecar and a flag."""
    store, uris = _store(tmp_path)
    msgs = []
    settings = {**SETTINGS, "quality": True}
    keys = engine.process_album_from_uris(uris, settings, store=store,
                                          progress_cb=msgs.append,
                                          device="cpu")
    used = "native" if native.available() else "numpy"
    assert f"Decoded 4 files ({used})." in msgs
    assert "Resampling uploads/a.wav 44100 -> 48000 Hz to batch the album" \
        in msgs
    assert "Upmixing uploads/c.wav 1 -> 2 channels" in msgs
    assert msgs[-1] == "Album complete: 4 files."
    _check_outputs(store, uris, keys, settings, "float32")


def test_run_job_album_and_single_with_default_options(tmp_path, clean_env):
    """The default job options (pcm16 wire, meters, no checkpoints): an
    album payload and a single payload, each output as the port's pcm16
    ``master_streamed`` masters it; a checkpointed album job removes its
    checkpoint directory when it succeeds."""
    assert worker.job_options() == {"transfer": "pcm16",
                                    "checkpoint_every": 0,
                                    "emit_meters": True}
    store, uris = _store(tmp_path, FILES[1:2] + FILES[3:])
    keys = worker.run_job({"gcs_uris": uris, "settings": SETTINGS}, store,
                          device="cpu")
    _check_outputs(store, uris, keys, SETTINGS, "pcm16")
    key = worker.run_job({"gcs_uri": uris[0], "settings": SETTINGS}, store,
                         device="cpu")
    assert key == keys[0]
    _check_outputs(store, uris[:1], [key], SETTINGS, "pcm16")

    import tempfile

    clean_env.setenv("PAM_CHECKPOINT", "every_n:1")
    clean_env.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    worker.run_job({"gcs_uris": uris, "settings": SETTINGS}, store,
                   device="cpu")
    assert os.listdir(tmp_path / "pam_album_ckpt") == []


def test_run_job_failure_flags(tmp_path, clean_env):
    """A job that fails after its retries flags every output it owns with
    ``.failed`` and raises; a malformed URI flags the parseable ones; a
    payload without settings is refused."""
    store, uris = _store(tmp_path, FILES[1:2])
    bad = uris + ["local://jobs/uploads/missing.wav"]
    with pytest.raises(FileNotFoundError):
        worker.run_job({"gcs_uris": bad, "settings": SETTINGS}, store,
                       max_retries=0, device="cpu")
    for k in ("processed/mastered_b.wav", "processed/mastered_missing.wav"):
        assert store.exists(f"{k}.failed")
    with pytest.raises(ValueError, match="malformed job URI"):
        worker.run_job({"gcs_uris": uris + ["no-scheme"],
                        "settings": SETTINGS}, store, device="cpu")
    with pytest.raises(ValueError, match="Missing GCS URI or settings"):
        worker.run_job({"gcs_uri": uris[0]}, store, device="cpu")
    # a later success clears the flag
    worker.run_job({"gcs_uri": uris[0], "settings": SETTINGS}, store,
                   device="cpu")
    assert not store.exists("processed/mastered_b.wav.failed")


@pytest.mark.parametrize("env,want", [
    ({}, ("pcm16", 0, True)),
    ({"PAM_TRANSFER": "float32", "PAM_METERS": "0"}, ("float32", 0, False)),
    ({"PAM_TRANSFER": "bogus", "PAM_CHECKPOINT": "sync"}, ("pcm16", 1, True)),
    ({"PAM_CHECKPOINT": "every_n"}, ("pcm16", 4, True)),
    ({"PAM_CHECKPOINT": "every_n", "PAM_CHECKPOINT_N": "3"},
     ("pcm16", 3, True)),
    ({"PAM_CHECKPOINT": "every_n:0"}, ("pcm16", 1, True)),
    ({"PAM_CHECKPOINT": "off", "PAM_METERS": "no"}, ("pcm16", 0, False)),
])
def test_job_options_read_the_environment(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    opts = worker.job_options()
    assert (opts["transfer"], opts["checkpoint_every"],
            opts["emit_meters"]) == want


def _post(app, body):
    raw = json.dumps(body).encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/",
               "CONTENT_LENGTH": str(len(raw)),
               "CONTENT_TYPE": "application/json",
               "wsgi.input": io.BytesIO(raw)}
    status = []
    app(environ, lambda s, h: status.append(s))
    return status[0]


def test_worker_app_and_consumer(tmp_path, clean_env):
    """The push endpoint answers a Pub/Sub envelope with 204 (a failed
    job too: its ``.failed`` flag keeps it observable) and a malformed one
    with 400; the ``LocalQueue`` consumer runs the same job."""
    clean_env.setenv("PAM_METERS", "0")
    store, uris = _store(tmp_path, FILES[3:])
    app = worker.make_worker_app(store, device="cpu")
    assert _post(app, {"bad": 1}).startswith("400")
    assert _post(app, encode_envelope({"gcs_uri": uris[0]})).startswith("400")
    assert _post(app, encode_envelope(
        {"gcs_uri": uris[0], "settings": SETTINGS})).startswith("204")
    assert store.exists("processed/mastered_d.wav.complete")
    assert not store.exists("processed/mastered_d.wav.meters.json")
    assert _post(app, encode_envelope(
        {"gcs_uri": "local://jobs/uploads/none.wav", "settings": SETTINGS},
    )).startswith("204")
    assert store.exists("processed/mastered_none.wav.failed")
    errors = []
    q = LocalQueue(worker.make_consumer(store, max_retries=0, device="cpu"),
                   on_error=lambda p, e: errors.append(e))
    q.start()
    try:
        store.delete("processed/mastered_d.wav.complete")
        q.publish({"gcs_uris": uris, "settings": SETTINGS})
        q.join()
    finally:
        q.stop()
    assert errors == [] and store.exists("processed/mastered_d.wav.complete")


def test_run_job_defaults_to_the_card(tmp_path, clean_env):
    """Without ``device`` and without a card every attempt fails naming
    CUDA, and the job's outputs are flagged ``.failed``."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    store, uris = _store(tmp_path, FILES[3:])
    for payload in ({"gcs_uris": uris, "settings": SETTINGS},
                    {"gcs_uri": uris[0], "settings": SETTINGS}):
        with pytest.raises(RuntimeError, match="device 'cuda'.*CUDA"):
            worker.run_job(payload, store, max_retries=0)
        flag = store.download("processed/mastered_d.wav.failed").decode()
        assert "CUDA" in flag


@pytest.mark.parametrize("case", ["native_batch", "native", "numpy"])
def test_decode_album_blobs_paths(case, monkeypatch):
    """One format: one native batch decode; mixed formats: native per
    track; no native library: the numpy codec.  Every path decodes what
    ``wavio.read_wav`` does."""
    fmts = ((48000, 2, True), (48000, 2, False)) if case != "native" else \
        ((48000, 2, True), (44100, 1, False))
    blobs = [_wav((make_signal(int(fs * 0.3), channels=ch, fs=fs, seed=i)
                   * 0.5).astype(np.float32), fs, flt)
             for i, (fs, ch, flt) in enumerate(fmts)]
    if case == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ toolchain: the native decoder did not build")
    loaded, used = engine._decode_album_blobs(blobs, ["x.wav", "y.wav"],
                                              lambda m: None)
    assert used == case
    for (audio, fs), blob in zip(loaded, blobs):
        ref, fs_ref = wavio.read_wav(blob)
        assert fs == fs_ref
        np.testing.assert_array_equal(audio, ref)


def test_native_matches_jax_native():
    from python_audio_mastering_tpu.io import native as jnative

    if not native.available():
        pytest.skip("no C++ toolchain: the native library did not build")
    x = (make_signal(4000, channels=2, seed=7) * 0.7).astype(np.float32)
    blobs = [_wav(x, 48000, False), _wav(x[:3000], 48000, True)]
    for got, ref in zip(native.decode_batch(blobs), jnative.decode_batch(
            blobs)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(native.decode_wav(blobs[1])[0],
                                  jnative.decode_wav(blobs[1])[0])
    assert native.probe(blobs[0]) == jnative.probe(blobs[0])
    for width in (2, 3):
        assert native.encode_pcm(x, width) == jnative.encode_pcm(x, width)
