"""The port's album runner (``parallel.batch``) against the port's own
per-track runner and against the JAX package.

Three tracks of 1.3-2.9 s at 48 kHz in 1 s chunks (several chunks a
track, ragged ends).  Limits: the port album against the port's per-track
``master_streamed`` and against the JAX runners with exact ballistics,
2e-4 max abs and 1e-3 LU (the JAX kernels-vs-XLA chain budget,
test_pallas_multiband.py:269); against the JAX album, whose ballistics are
the approximate block-parallel ones, rms 1e-3 (DESIGN.md:347-348); the
pcm16 wire against float32, 3e-3 (JAX test_parallel.py:128)."""

import dataclasses

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.parallel import batch as jbatch
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, master
from python_audio_mastering_tpu_torch import convert
from python_audio_mastering_tpu_torch.parallel import batch
from python_audio_mastering_tpu_torch.parallel import streaming

from .conftest import make_signal

FS = 48000
SECONDS = (1.3, 2.9, 2.1)
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
# per-track sliders: two front groups and per-track detector thresholds
PER_TRACK = ({"preset": "techno", "width": 1.3, "lufs": -14.0},
             {"preset": "pop", "width": 1.0, "lufs": -12.0,
              "low_thresh": -30.0, "high_ratio": 6.0},
             {"preset": "techno", "width": 1.3, "lufs": -14.0})


def _tracks():
    return [(make_signal(int(FS * s), channels=2, fs=FS, seed=30 + i) * 0.5
             ).astype(np.float32) for i, s in enumerate(SECONDS)]


def _params(multiband, per_track=False):
    rows = PER_TRACK if per_track else (SETTINGS,) * len(SECONDS)
    return [{**SETTINGS, **r, "multiband": multiband} for r in rows]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references, built once: its album runner (multiband off;
    on, with its block-parallel ballistics) and its per-track streamed
    runner with the Pallas kernels in interpret mode (exact ballistics)."""
    tracks = _tracks()
    cfg = JConfig.tpu_default(FS)
    refs = {}
    for mb in (False, True):
        refs["album", mb] = jbatch.master_album_streamed(
            tracks, [JParams.from_settings(s) for s in _params(mb)], cfg,
            chunk_seconds=1.0)
    icfg = dataclasses.replace(cfg, mb_kernel="pallas_interpret")
    refs["streamed", True] = [
        jstream.master_streamed(x, JParams.from_settings(s), icfg,
                                chunk_seconds=1.0)[:2]
        for x, s in zip(tracks, _params(True))]
    return refs


def _album(multiband, per_track=False, **kwargs):
    params = [MasteringParams.from_settings(s)
              for s in _params(multiband, per_track)]
    return batch.master_album_streamed(
        _tracks(), params, kwargs.pop("config", ChainConfig.gpu_default(FS)),
        chunk_seconds=1.0, device="cpu", **kwargs)


@pytest.mark.parametrize("per_track", [False, True])
@pytest.mark.parametrize("multiband", [False, True])
def test_album_equals_per_track_master_streamed(multiband, per_track):
    outs, measured = _album(multiband, per_track)
    for i, (x, s) in enumerate(zip(_tracks(), _params(multiband, per_track))):
        ref, m_ref, _ = streaming.master_streamed(
            x, MasteringParams.from_settings(s), ChainConfig.gpu_default(FS),
            chunk_seconds=1.0, device="cpu")
        d = float(np.max(np.abs(outs[i] - ref)))
        print(f"track {i}: album vs master_streamed max abs {d:.3e}, "
              f"bitwise {np.array_equal(outs[i], ref)}")
        assert outs[i].shape == x.shape and d <= 2e-4
        assert abs(measured[i] - m_ref) <= 1e-3


def test_album_matches_jax_album_without_multiband(jax_refs):
    outs, measured = _album(False)
    ref, m_ref = jax_refs["album", False]
    for i in range(len(SECONDS)):
        d = float(np.max(np.abs(outs[i] - ref[i])))
        print(f"track {i}: vs JAX album max abs {d:.3e}")
        assert d <= 2e-4 and abs(measured[i] - m_ref[i]) <= 1e-3


def test_album_multiband_matches_jax_exact_per_track(jax_refs):
    """Multiband on: the port album (exact ballistics) against JAX's
    per-track streamed runner on its exact interpret-mode kernels within
    2e-4, and against the JAX album (approximate ballistics) within its
    documented rms 1e-3."""
    outs, measured = _album(True)
    ref_album, _ = jax_refs["album", True]
    for i, (ref, m_ref) in enumerate(jax_refs["streamed", True]):
        d = float(np.max(np.abs(outs[i] - ref)))
        rms = float(np.sqrt(np.mean((outs[i] - ref_album[i]) ** 2)))
        print(f"track {i}: vs JAX exact streamed max abs {d:.3e}; vs JAX "
              f"blocked album rms {rms:.3e}")
        assert d <= 2e-4 and abs(measured[i] - m_ref) <= 1e-3
        assert rms <= 1e-3


def test_album_params_from_jax():
    jparams = [JParams.from_settings(s) for s in _params(True, True)]
    assert convert.album_params_from_jax(jparams) == [
        MasteringParams.from_settings(s) for s in _params(True, True)]


def test_pcm16_wire_helpers_match_jax():
    """quantize/dequantize bitwise as the JAX host legs (a 2**20-frame
    array too), requantize as JAX's device leg, with overs and exact
    halves."""
    r = np.random.default_rng(0)
    for x in (r.uniform(-1.2, 1.2, (4096, 2)).astype(np.float32),
              r.uniform(-1.2, 1.2, (1 << 20, 2)).astype(np.float32),
              (np.arange(-40, 41) + 0.5).astype(np.float32) / 32767.0):
        q = streaming.quantize_pcm16(x)
        np.testing.assert_array_equal(q, jstream.quantize_pcm16(x))
        np.testing.assert_array_equal(streaming.dequantize_pcm16_host(q),
                                      jstream.dequantize_pcm16_host(q))
        y = x * np.float32(1.01)
        np.testing.assert_array_equal(
            streaming.requantize_pcm16(torch.from_numpy(y)).numpy(),
            np.asarray(jstream.requantize_pcm16(y)))


def test_album_wire_is_the_jax_quantizer():
    """The wire slot the album uploads, ``(C, T, F)`` int16 with zeros past
    each track's end: each track bitwise JAX's quantize_pcm16 of its
    frames (float32 and float64 tracks, overs and exact halves)."""
    from concurrent.futures import ThreadPoolExecutor

    r = np.random.default_rng(1)
    halves = (np.arange(-40, 41) + 0.5) / 32767.0
    tracks = [r.uniform(-1.2, 1.2, (700, 2)).astype(np.float32),
              np.stack([halves, -halves], axis=1),          # float64
              r.uniform(-1.2, 1.2, (1000, 2)).astype(np.float32)]
    start, frames = 40, 900
    w = np.full((2, len(tracks), frames), 7, np.int16)
    with ThreadPoolExecutor(max_workers=2) as pool:
        streaming._fill_wire(w, tracks, start, True, pool)
    for i, x in enumerate(tracks):
        seg = x[start:start + frames]
        k = seg.shape[0]
        np.testing.assert_array_equal(w[:, i, :k],
                                      jstream.quantize_pcm16(seg).T)
        assert not w[:, i, k:].any()


def test_pcm16_album_and_timings():
    f_outs, f_meas = _album(True)
    tm = {}
    p_outs, p_meas = _album(True, transfer="pcm16", timings=tm)
    for a, b in zip(f_outs, p_outs):
        assert 0 < np.max(np.abs(a - b)) < 3e-3
    np.testing.assert_allclose(p_meas, f_meas, atol=0.01)
    n_pad = -(-int(FS * max(SECONDS)) // FS) * FS
    assert tm["wire_bytes_in"] == len(SECONDS) * n_pad * 2 * 2
    assert tm["wire_bytes_out"] == sum(int(FS * s) for s in SECONDS) * 2 * 2
    for key in ("h2d_s", "compute_s", "d2h_s"):
        assert tm[key] >= 0.0
    assert tm["device_resident"] and tm["spilled_chunks"] == 0


def test_bounded_album_equals_resident(tmp_path):
    """A budget too small for residency streams the input, spills pass-A
    chunks (2 of 3 kept) and reads outputs back per chunk: bitwise the
    resident run; a memmap track always takes that path."""
    cfg = ChainConfig.gpu_default(FS)
    ref, _ = _album(True)
    tm = {}
    outs, _ = _album(True, config=dataclasses.replace(
        cfg, device_budget_bytes=1), timings=tm)
    assert not tm["device_resident"] and tm["spilled_chunks"] == 1
    assert "h2d_plus_compute_s" in tm and "compute_s" not in tm
    assert tm["max_retained_bytes"] == 3 * 3 * FS * 2 * 4
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    x = _tracks()[1]
    path = tmp_path / "track.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    stats = {}
    params = MasteringParams.from_settings({**SETTINGS, "multiband": True})
    out, _, _ = streaming.master_streamed(
        np.memmap(path, dtype=np.float32, mode="r", shape=x.shape), params,
        cfg, chunk_seconds=1.0, stats=stats, device="cpu")
    assert stats == {"max_retained_bytes": 3 * FS * 2 * 4,
                     "spilled_chunks": 0, "device_resident": False}
    resident, _, _ = streaming.master_streamed(x, params, cfg,
                                               chunk_seconds=1.0,
                                               device="cpu")
    np.testing.assert_array_equal(out, resident)


def test_on_track_done_once_per_track():
    got = {}

    def cb(i, audio, meters):
        assert i not in got
        got[i] = (audio, meters)

    outs, _, meters = _album(False, return_meters=True, on_track_done=cb)
    assert sorted(got) == [0, 1, 2]
    for i in range(3):
        assert got[i][0] is outs[i] and got[i][1] is meters[i]
        assert np.isfinite(meters[i]["integrated_lufs"])
    got.clear()
    _album(False, on_track_done=cb)
    assert all(got[i][1] is None for i in range(3))


def test_album_meters_equal_per_track_meters():
    outs, _, meters = _album(True, per_track=True, return_meters=True)
    for i, (x, s) in enumerate(zip(_tracks(), _params(True, True))):
        *_, ref = streaming.master_streamed(
            x, MasteringParams.from_settings(s), ChainConfig.gpu_default(FS),
            chunk_seconds=1.0, return_meters=True, device="cpu")
        for key in ("momentary_lufs", "short_term_lufs"):
            assert meters[i][key].shape == ref[key].shape
            np.testing.assert_allclose(meters[i][key], ref[key], atol=1e-4)
        for key in ("true_peak_dbtp", "integrated_lufs"):
            assert abs(meters[i][key] - ref[key]) <= 1e-4, key
        assert np.isnan(meters[i]["lra_lu"]) == np.isnan(ref["lra_lu"])


def test_quality_album_equals_per_track_quality_master():
    """Quality mode: each track's limiter stops at its own end, so every
    track equals its own one-shot quality master() (2e-4), under the
    ceiling."""
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS),
                              limiter_mode="lookahead_truepeak")
    tracks = [x * 1.8 for x in _tracks()]
    params = MasteringParams.from_settings({**SETTINGS, "lufs": -9.0})
    outs, _ = batch.master_album_streamed(tracks, params, cfg,
                                          chunk_seconds=1.0, device="cpu")
    for x, out in zip(tracks, outs):
        one = master(x, params, cfg, device="cpu").numpy()
        assert out.shape == x.shape
        assert np.max(np.abs(out - one)) <= 2e-4
        assert np.abs(out).max() <= 10 ** (-1 / 20) * (1 + 1e-6)


def test_master_album_equals_one_shot_master():
    params = [MasteringParams.from_settings(s) for s in _params(True, True)]
    cfg = ChainConfig.gpu_default(FS)
    outs = batch.master_album(_tracks(), params, cfg, pad_multiple=4800,
                              device="cpu")
    for x, p, out in zip(_tracks(), params, outs):
        one = master(x, p, cfg, device="cpu").numpy()
        assert out.shape == x.shape and np.max(np.abs(out - one)) <= 2e-4


def test_stack_params_rejects_mixed_switches():
    with pytest.raises(ValueError, match="multiband/lufs"):
        batch.stack_params([MasteringParams(multiband=True),
                            MasteringParams(multiband=False)])
    with pytest.raises(ValueError, match="multiband/lufs"):
        batch.stack_params([MasteringParams(),
                            MasteringParams(lufs_enabled=False)])
    assert batch.stack_params([MasteringParams()] * 2) == [
        MasteringParams()] * 2


def test_pad_tracks():
    out, lengths = batch.pad_tracks([np.ones((5, 2)), np.ones(3)[:, None]
                                     .repeat(2, 1)], multiple=4)
    assert out.shape == (2, 8, 2) and list(lengths) == [5, 3]
    assert out[1, 3:].sum() == 0
