"""Chunk-granular checkpoint/resume and the per-chunk state reset of the
port's streamed and album runners.

An interrupted run (a ``progress_cb`` that raises) resumed from its
checkpoint directory equals the uninterrupted run bitwise; ``carry_state
=False`` equals the JAX runner's per-chunk reset within 2e-4 (its chain
budget, test_pallas_multiband.py:269)."""

import dataclasses
import os

import numpy as np
import pytest

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.parallel import batch, streaming

from .conftest import make_signal

FS = 48000
CFG = ChainConfig.gpu_default(FS)
SETTINGS = {"saturation": 10, "preset": "techno", "lufs": -14.0}


class Stop(Exception):
    pass


def _stop_after(chunk):
    def cb(msg):
        if msg.startswith(f"Processed chunk {chunk}/"):
            raise Stop()
    return cb


def _track(seconds=2.9, seed=40):
    return (make_signal(int(FS * seconds), channels=2, fs=FS, seed=seed)
            * 0.5).astype(np.float32)


def _streamed(x, settings, **kw):
    return streaming.master_streamed(
        x, MasteringParams.from_settings(settings),
        kw.pop("config", CFG), chunk_seconds=1.0, device="cpu", **kw)


@pytest.mark.parametrize("multiband", [False, True])
def test_streamed_resume_equals_uninterrupted(tmp_path, multiband):
    settings = {**SETTINGS, "multiband": multiband}
    x = _track()
    full, m_full, _ = _streamed(x, settings)
    ckpt = str(tmp_path / "job")
    with pytest.raises(Stop):
        _streamed(x, settings, checkpoint_dir=ckpt,
                  progress_cb=_stop_after(2))
    assert sorted(os.listdir(ckpt)) == ["chunk_00000.npz", "chunk_00001.npz"]
    msgs = []
    out, m, _ = _streamed(x, settings, checkpoint_dir=ckpt,
                          progress_cb=msgs.append)
    assert "Resuming from chunk 3/3..." in msgs
    assert sum(m_.startswith("Processed chunk") for m_ in msgs) == 1
    np.testing.assert_array_equal(out, full)
    assert m == m_full


def test_completed_checkpoints_skip_all_compute(tmp_path):
    x = _track(1.7)
    ckpt = str(tmp_path / "done")
    first, m1, _ = _streamed(x, SETTINGS, checkpoint_dir=ckpt)
    msgs = []
    again, m2, _ = _streamed(x, SETTINGS, checkpoint_dir=ckpt,
                             progress_cb=msgs.append)
    assert not any(m.startswith("Processed chunk") for m in msgs)
    np.testing.assert_array_equal(first, again)
    assert m1 == m2


def test_bounded_resume_equals_resident_uninterrupted(tmp_path):
    """A bounded run (pass-A chunks spilled, replayed chunks kept on the
    host) resumes from a checkpoint to the resident run's bits."""
    x = _track()
    full, _, _ = _streamed(x, SETTINGS)
    bounded = dataclasses.replace(CFG, device_budget_bytes=1)
    ckpt = str(tmp_path / "bounded")
    with pytest.raises(Stop):
        _streamed(x, SETTINGS, config=bounded, checkpoint_dir=ckpt,
                  progress_cb=_stop_after(1))
    stats = {}
    out, _, _ = _streamed(x, SETTINGS, config=bounded, checkpoint_dir=ckpt,
                          stats=stats)
    assert not stats["device_resident"]
    np.testing.assert_array_equal(out, full)


def test_lufs_run_resumes_a_no_lufs_checkpoint(tmp_path):
    """A checkpoint written without loudness holds no cells: the resume
    measures the replayed prefix again and equals a fresh LUFS run, meters
    included."""
    x = _track()
    ckpt = str(tmp_path / "nolufs")
    with pytest.raises(Stop):
        _streamed(x, {**SETTINGS, "lufs": None}, checkpoint_dir=ckpt,
                  progress_cb=_stop_after(2))
    fresh, m_fresh, _, met_fresh = _streamed(x, SETTINGS, return_meters=True)
    out, m, _, met = _streamed(x, SETTINGS, checkpoint_dir=ckpt,
                               return_meters=True)
    np.testing.assert_array_equal(out, fresh)
    assert m == m_fresh
    np.testing.assert_array_equal(met["momentary_lufs"],
                                  met_fresh["momentary_lufs"])


def test_album_segments_every_n_resume(tmp_path):
    """``checkpoint_every=2``: one segment file per two chunks (keyed by
    its last chunk, the last segment cut short); interrupted after chunk 3
    of 5, the durable prefix is chunks 0-1 and the resume equals the
    uninterrupted album bitwise."""
    tracks = [_track(4.5, 41), _track(1.3, 42), _track(2.1, 43)]
    params = MasteringParams.from_settings({**SETTINGS, "multiband": True})
    full, m_full = batch.master_album_streamed(tracks, params, CFG,
                                               chunk_seconds=1.0,
                                               device="cpu")
    ckpt = str(tmp_path / "album")
    with pytest.raises(Stop):
        batch.master_album_streamed(tracks, params, CFG, chunk_seconds=1.0,
                                    checkpoint_dir=ckpt, checkpoint_every=2,
                                    progress_cb=_stop_after(3),
                                    device="cpu")
    assert os.listdir(ckpt) == ["chunk_00001.npz"]
    msgs = []
    outs, measured = batch.master_album_streamed(
        tracks, params, CFG, chunk_seconds=1.0, checkpoint_dir=ckpt,
        checkpoint_every=2, progress_cb=msgs.append, device="cpu")
    assert "Resuming from checkpoint: 2/5 chunks already processed." in msgs
    assert sorted(os.listdir(ckpt)) == ["chunk_00001.npz", "chunk_00003.npz",
                                        "chunk_00004.npz"]
    for o, f in zip(outs, full):
        np.testing.assert_array_equal(o, f)
    np.testing.assert_array_equal(measured, m_full)


def test_album_lufs_resume_of_a_no_lufs_checkpoint(tmp_path):
    tracks = [_track(2.9, 44), _track(2.1, 45)]
    p_lufs = MasteringParams.from_settings(SETTINGS)
    p_none = MasteringParams.from_settings({**SETTINGS, "lufs": None})
    ckpt = str(tmp_path / "album_nolufs")
    with pytest.raises(Stop):
        batch.master_album_streamed(tracks, p_none, CFG, chunk_seconds=1.0,
                                    checkpoint_dir=ckpt, device="cpu",
                                    progress_cb=_stop_after(2))
    fresh, m_fresh = batch.master_album_streamed(tracks, p_lufs, CFG,
                                                 chunk_seconds=1.0,
                                                 device="cpu")
    outs, measured = batch.master_album_streamed(
        tracks, p_lufs, CFG, chunk_seconds=1.0, checkpoint_dir=ckpt,
        device="cpu")
    for o, f in zip(outs, fresh):
        np.testing.assert_array_equal(o, f)
    np.testing.assert_array_equal(measured, m_fresh)


def test_checkpoint_of_another_geometry_raises(tmp_path):
    ckpt = str(tmp_path / "other")
    _streamed(_track(1.7), SETTINGS, checkpoint_dir=ckpt)
    with pytest.raises(ValueError, match="chunk of shape"):
        batch.master_album_streamed([_track(1.7)] * 2,
                                    MasteringParams.from_settings(SETTINGS),
                                    CFG, chunk_seconds=1.0,
                                    checkpoint_dir=ckpt, device="cpu")


def test_carry_state_false_matches_jax_per_chunk_reset():
    """``carry_state=False`` resets every filter and the loudness meter at
    each chunk, as the reference engine does: equal to the JAX runner's
    reset within 2e-4, and audibly not the carried result."""
    x = _track()
    out, measured, _ = _streamed(x, SETTINGS, carry_state=False)
    ref, m_ref, _ = jstream.master_streamed(
        x, JParams.from_settings(SETTINGS), JConfig.tpu_default(FS),
        chunk_seconds=1.0, carry_state=False)
    assert np.max(np.abs(out - ref)) <= 2e-4
    assert abs(measured - m_ref) <= 1e-3
    carried, _, _ = _streamed(x, SETTINGS)
    assert np.max(np.abs(out - carried)) > 1e-3
