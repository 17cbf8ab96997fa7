"""The port's streamed runner and engine entry point.

Streamed vs one-shot and vs the JAX streamed runner: atol 2e-4, the JAX
kernels-vs-XLA chain budget (test_pallas_multiband.py:117, 269)."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.parallel.streaming import (
    master_streamed as jax_master_streamed,
)
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, master
from python_audio_mastering_tpu_torch import engine
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.ops import meters as met
from python_audio_mastering_tpu_torch.parallel.streaming import (
    default_chunk_frames,
    master_streamed,
)
from python_audio_mastering_tpu_torch.serving.store import LocalFSBlobStore

from .conftest import make_signal

SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
CEILING = 10.0 ** (-1.0 / 20.0)
PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "python_audio_mastering_tpu_torch")


@pytest.mark.parametrize("fs,seconds,chunk_seconds,multiband", [
    # 3 chunks of 48000 frames, zero-padded tail
    pytest.param(48000, 2.9, 1.0, False, id="48000-2.9-1.0"),
    # one 1128960-frame chunk, mostly padding
    pytest.param(44100, 1.0, 30.0, False, id="44100-1.0-30.0"),
    # multiband state carried across 3 chunks
    pytest.param(48000, 2.9, 1.0, True, id="48000-2.9-1.0-multiband"),
])
def test_master_streamed_matches_one_shot_and_jax(fs, seconds,
                                                  chunk_seconds, multiband):
    x = (make_signal(int(fs * seconds), channels=2, fs=fs, seed=11) * 0.5
         ).astype(np.float32)
    settings = {**SETTINGS, "multiband": multiband}
    params = MasteringParams.from_settings(settings)
    cfg = ChainConfig.gpu_default(fs)
    out, measured, gain_db = master_streamed(x, params, cfg,
                                             chunk_seconds=chunk_seconds,
                                             device="cpu")
    one = master(x, params, cfg, return_result=True, device="cpu")
    assert out.shape == x.shape and out.dtype == np.float32
    assert np.max(np.abs(out - one.audio.numpy())) < 2e-4
    assert abs(measured - float(one.measured_lufs)) < 1e-3
    assert abs(gain_db - float(one.applied_gain_db)) < 1e-3

    jcfg = dataclasses.replace(JConfig.tpu_default(fs),
                               mb_kernel="pallas_interpret")
    ref, m_ref, g_ref = jax_master_streamed(
        x, JParams.from_settings(settings), jcfg, chunk_seconds=chunk_seconds)
    assert np.max(np.abs(out - ref)) < 2e-4
    assert abs(measured - m_ref) < 1e-3


def test_default_chunk_frames_is_block_aligned():
    cfg = ChainConfig.gpu_default(44100)
    assert default_chunk_frames(cfg) == 1128960
    assert default_chunk_frames(cfg, 1.0) == 282240   # one aligned unit
    assert default_chunk_frames(ChainConfig.gpu_default(48000), 1.0) == 48000


def test_process_audio_writes_wav(tmp_path):
    fs = 48000
    x = (make_signal(int(fs * 1.5), channels=2, fs=fs, seed=12) * 0.5
         ).astype(np.float32)
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    wavio.write_wav(src, x, fs, float_format=True)
    msgs = []
    ok = engine.process_audio({**SETTINGS, "input_file": str(src),
                               "output_file": str(dst)}, msgs.append,
                              device="cpu")
    assert ok, msgs
    assert "complete" in msgs[-1]
    y, fs_out = wavio.read_wav(dst)
    assert fs_out == fs and y.shape == x.shape
    one = master(x, MasteringParams.from_settings(SETTINGS),
                 ChainConfig.gpu_default(fs), device="cpu").numpy()
    # 16-bit output: truncation adds < 1/32768
    assert np.max(np.abs(y - one)) < 2e-4


@pytest.mark.parametrize("settings,match", [
    ({"quality": True, "lufs": -8.0}, "lookahead"),
    ({"output_sample_rate": 44100}, "resampler"),
])
def test_process_audio_reports_outside_the_slice(tmp_path, settings, match):
    """Jobs with the ``quality`` key (the lookahead limiter) or another
    ``output_sample_rate`` (the resampler) complete: a 48 kHz WAV mastered
    hot comes out under -0.8 dBTP in quality mode, and at 44.1 kHz with
    ``ceil(N·147/160)`` frames when resampled."""
    fs = 48000
    x = (make_signal(int(fs * 1.2), channels=2, fs=fs, seed=14) * 0.5
         ).astype(np.float32)
    src, dst = tmp_path / "in.wav", tmp_path / "o.wav"
    wavio.write_wav(src, x, fs, float_format=True)
    msgs = []
    ok = engine.process_audio({**settings, "input_file": str(src),
                               "output_file": str(dst)}, msgs.append,
                              device="cpu")
    assert ok, msgs
    assert "complete" in msgs[-1]
    y, fs_out = wavio.read_wav(dst)
    if match == "lookahead":
        assert fs_out == fs and y.shape == x.shape
        assert float(met.true_peak_db(torch.from_numpy(y))) <= -0.8
    else:
        assert any("Resampling 48000 -> 44100" in m for m in msgs)
        assert fs_out == 44100 and y.shape == (-(-x.shape[0] * 147 // 160), 2)


def test_process_audio_multiband_matches_jax_engine(tmp_path):
    """A multiband job through the port's engine equals the JAX engine's
    (its Pallas multiband kernels in interpret mode) within 2e-4 on the
    16-bit output, and the port's one-shot master()."""
    from python_audio_mastering_tpu import engine as jax_engine

    fs = 44100
    x = (make_signal(int(fs * 1.5), channels=2, fs=fs, seed=13) * 0.5
         ).astype(np.float32)
    src = tmp_path / "in.wav"
    wavio.write_wav(src, x, fs, float_format=True)
    settings = {**SETTINGS, "multiband": True, "input_file": str(src)}
    outs = {}
    for name, run, kwargs in (
            ("port", engine.process_audio, {"device": "cpu"}),
            ("jax", jax_engine.process_audio,
             {"config": dataclasses.replace(JConfig.tpu_default(fs),
                                            mb_kernel="pallas_interpret")})):
        dst = tmp_path / f"{name}.wav"
        msgs = []
        assert run({**settings, "output_file": str(dst)}, msgs.append,
                   **kwargs), msgs
        outs[name], fs_out = wavio.read_wav(dst)
        assert fs_out == fs and outs[name].shape == x.shape
    assert np.max(np.abs(outs["port"] - outs["jax"])) < 2e-4
    one = master(x, MasteringParams.from_settings(settings),
                 ChainConfig.gpu_default(fs), device="cpu").numpy()
    assert np.max(np.abs(outs["port"] - one)) < 2e-4


@pytest.mark.parametrize("kwargs", [
    pytest.param({"transfer": "pcm16"}, id="kwargs0"),
    pytest.param({"checkpoint_dir": "ckpt"}, id="kwargs1"),
    pytest.param({"return_meters": True}, id="kwargs2"),
])
def test_master_streamed_outside_the_slice_raises(kwargs, tmp_path):
    """The options that raised before this slice now run: the pcm16 wire
    equals the float32 one within its 16-bit floor (3e-3, JAX
    test_parallel.py:128), a checkpointed run writes its chunk file and
    equals the plain run bitwise; ``return_meters`` returns the JAX
    runner's meters dict."""
    x = (make_signal(28800, channels=2, fs=48000, seed=15) * 0.3
         ).astype(np.float32)
    if "checkpoint_dir" in kwargs:
        kwargs = {"checkpoint_dir": str(tmp_path / kwargs["checkpoint_dir"])}
    run = lambda **kw: master_streamed(  # noqa: E731
        x, MasteringParams(), ChainConfig.gpu_default(48000), device="cpu",
        **kw)
    if "return_meters" not in kwargs:
        plain, m_plain, _ = run()
        out, measured, _ = run(**kwargs)
        assert out.shape == x.shape and abs(measured - m_plain) < 1e-2
        if "transfer" in kwargs:
            assert 0 < np.max(np.abs(out - plain)) < 3e-3
        else:
            assert os.listdir(kwargs["checkpoint_dir"]) == ["chunk_00000.npz"]
            np.testing.assert_array_equal(out, plain)
        return
    out, measured, gain_db, meters = run(**kwargs)
    assert out.shape == x.shape and math.isfinite(measured)
    assert sorted(meters) == ["integrated_lufs", "lra_lu", "momentary_lufs",
                              "short_term_lufs", "true_peak_dbtp"]
    assert meters["momentary_lufs"].shape == (28800 // 4800 - 3,)
    assert meters["short_term_lufs"].shape == (0,)
    assert abs(meters["integrated_lufs"] - (measured + gain_db)) < 1e-9


@pytest.mark.parametrize("multiband", [False, True])
def test_master_streamed_quality_matches_one_shot(multiband):
    """Quality mode streams: 3 chunks with a ragged tail, the limiter's
    delay line and release gain carried, equal the one-shot quality
    master() within 2e-4 (the JAX chain budget), under the ceiling."""
    fs = 48000
    x = (make_signal(int(fs * 2.9), channels=2, fs=fs, seed=16) * 0.5
         ).astype(np.float32)
    params = MasteringParams.from_settings({**SETTINGS, "lufs": -8.0,
                                            "multiband": multiband})
    cfg = dataclasses.replace(ChainConfig.gpu_default(fs),
                              limiter_mode="lookahead_truepeak")
    out, measured, _ = master_streamed(x, params, cfg, chunk_seconds=1.0,
                                       device="cpu")
    one = master(x, params, cfg, return_result=True, device="cpu")
    assert out.shape == x.shape
    assert np.max(np.abs(out - one.audio.numpy())) < 2e-4
    assert abs(measured - float(one.measured_lufs)) < 1e-3
    assert np.abs(out).max() <= CEILING * (1 + 1e-6)


def test_return_meters_match_jax_and_the_output():
    """``return_meters`` against the JAX runner's (1e-3 LU, 1e-3 dB) and
    against the port's meters of its own output (1e-6; a quiet target, so
    the soft limiter does not touch the signal, and float64 chains, as in
    the JAX test_streaming.py:142-158)."""
    fs = 44100
    x = make_signal(int(fs * 5.0), channels=2, fs=fs, seed=17) * 0.4
    settings = {"preset": "pop", "lufs": -20.0}
    out, measured, gain_db, meters = master_streamed(
        x, MasteringParams.from_settings(settings),
        dataclasses.replace(ChainConfig.gpu_default(fs), dtype="float64"),
        chunk_seconds=1.0, return_meters=True, device="cpu")
    assert np.abs(out).max() < 0.98
    y = torch.from_numpy(out.astype(np.float64))
    for key, series in (("momentary_lufs", met.momentary_loudness),
                        ("short_term_lufs", met.shortterm_loudness)):
        own = series(y, fs, downmix="reference_mono_mean").numpy()
        np.testing.assert_allclose(meters[key], own, rtol=0, atol=1e-6)
    assert abs(meters["lra_lu"] - float(met.lra_from_shortterm(
        torch.from_numpy(meters["short_term_lufs"])))) < 1e-6
    assert abs(meters["true_peak_dbtp"] - float(met.true_peak_db(y))) < 1e-6
    assert abs(meters["integrated_lufs"] - (-20.0)) < 0.05

    jcfg = dataclasses.replace(JConfig.tpu_default(fs), dtype="float64",
                               mb_kernel="xla")
    *_, ref = jax_master_streamed(x, JParams.from_settings(settings), jcfg,
                                  chunk_seconds=1.0, return_meters=True)
    for key in ("momentary_lufs", "short_term_lufs"):
        assert meters[key].shape == ref[key].shape
        np.testing.assert_allclose(meters[key], ref[key], rtol=0, atol=1e-3)
    for key in ("lra_lu", "true_peak_dbtp", "integrated_lufs"):
        assert abs(meters[key] - ref[key]) < 1e-3, key


def test_process_audio_quality_resampled_matches_jax_engine(tmp_path):
    """A quality job resampled 44.1 -> 48 kHz through the port's engine
    equals the JAX engine's (float32; its attack sum's drift stays under
    ~6e-5 at 1.5 s) within 2e-4 on the 16-bit output, with
    ``ceil(N·160/147)`` frames at 48 kHz."""
    from python_audio_mastering_tpu import engine as jax_engine

    fs = 44100
    x = (make_signal(int(fs * 1.5), channels=2, fs=fs, seed=18) * 0.5
         ).astype(np.float32)
    src = tmp_path / "in.wav"
    wavio.write_wav(src, x, fs, float_format=True)
    settings = {**SETTINGS, "lufs": -9.0, "quality": True,
                "output_sample_rate": 48000, "input_file": str(src)}
    outs = {}
    for name, run, kwargs in (
            ("port", engine.process_audio, {"device": "cpu"}),
            ("jax", jax_engine.process_audio,
             {"config": dataclasses.replace(JConfig.tpu_default(fs),
                                            mb_kernel="pallas_interpret")})):
        dst = tmp_path / f"{name}.wav"
        msgs = []
        assert run({**settings, "output_file": str(dst)}, msgs.append,
                   **kwargs), msgs
        outs[name], fs_out = wavio.read_wav(dst)
        assert fs_out == 48000
        assert outs[name].shape == (-(-x.shape[0] * 160 // 147), 2)
    assert np.max(np.abs(outs["port"] - outs["jax"])) < 2e-4


def _two_wavs(folder):
    for name, fs in (("a.wav", 44100), ("b.wav", 48000)):
        wavio.write_wav(folder / name, (make_signal(
            int(fs * 0.8), channels=2, fs=fs, seed=fs) * 0.4
        ).astype(np.float32), fs, float_format=True)


def test_batch_process_audio_contract(tmp_path):
    """The GUI's folder contract: every audio file (not the others) into
    ``{base}_mastered{ext}``, the count returned; an empty folder and a
    missing one are reported, not raised."""
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    _two_wavs(src)
    (src / "notes.txt").write_text("not audio")
    msgs = []
    done = engine.batch_process_audio({**SETTINGS, "quality": True},
                                      str(src), str(dst), msgs.append,
                                      device="cpu")
    assert done == 2, msgs
    assert sorted(os.listdir(dst)) == ["a_mastered.wav", "b_mastered.wav"]
    for name, fs in (("a", 44100), ("b", 48000)):
        y, fs_out = wavio.read_wav(dst / f"{name}_mastered.wav")
        assert fs_out == fs and y.shape == (int(fs * 0.8), 2)
    assert msgs[0] == "[1/2] a.wav"
    assert msgs[-1] == "Batch processing complete! 2/2 files mastered."
    (tmp_path / "empty").mkdir()
    msgs = []
    assert engine.batch_process_audio(SETTINGS, str(tmp_path / "empty"),
                                      str(dst), msgs.append,
                                      device="cpu") == 0
    assert msgs == ["No audio files found in the input folder."]
    msgs = []
    assert engine.batch_process_audio(SETTINGS, str(tmp_path / "missing"),
                                      str(dst), msgs.append,
                                      device="cpu") == 0
    assert msgs[-1].startswith("ERROR: cannot read input folder")


def test_process_audio_from_uri_local(tmp_path):
    """The cloud contract on a ``local://`` store: the output blob, its
    ``.complete`` flag and the ``.meters.json`` sidecar, whose integrated
    loudness is the target (measured + gain) and whose true peak is the
    written audio's; a silent upload's -inf loudness is a null there."""
    store = LocalFSBlobStore(str(tmp_path), bucket="jobs")
    fs = 48000
    x = (make_signal(int(fs * 1.6), channels=2, fs=fs, seed=19) * 0.5
         ).astype(np.float32)
    for key, audio in (("uploads/song.wav", x),
                       ("uploads/silence.wav", np.zeros_like(x))):
        wavio.write_wav(tmp_path / "in.wav", audio, fs, float_format=True)
        store.upload(key, (tmp_path / "in.wav").read_bytes())
    settings = {**SETTINGS, "quality": True}
    out_key = engine.process_audio_from_uri("local://jobs/uploads/song.wav",
                                            settings, store=store,
                                            device="cpu")
    assert out_key == "processed/mastered_song.wav"
    assert store.exists(f"{out_key}.complete")
    y, fs_out = wavio.read_wav(store.download(out_key))
    assert fs_out == fs and y.shape == x.shape
    side = json.loads(store.download(f"{out_key}.meters.json"))
    assert sorted(side) == ["integrated_lufs", "lra_lu",
                            "max_momentary_lufs", "max_short_term_lufs",
                            "true_peak_dbtp"]
    assert abs(side["integrated_lufs"] - SETTINGS["lufs"]) <= 1e-2
    tp = float(met.true_peak_db(torch.from_numpy(y)))
    assert abs(side["true_peak_dbtp"] - tp) <= 0.05 and tp <= -0.8
    assert side["max_short_term_lufs"] is None   # shorter than 3 s

    key = engine.process_audio_from_gcs("local://jobs/uploads/silence.wav",
                                        settings, store=store, device="cpu")
    side = json.loads(store.download(f"{key}.meters.json"))
    assert side["integrated_lufs"] is None
    assert side["max_momentary_lufs"] < -300.0   # the meter's floor


def _skip_with_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")


@pytest.mark.parametrize("entry", ["master", "master_streamed",
                                   "master_album", "master_album_streamed"])
def test_entry_points_default_to_the_card(entry):
    """Called without ``device``, the entry points run on the card; with
    none they raise, naming the missing device, and never fall back to
    the CPU."""
    from python_audio_mastering_tpu_torch.parallel import batch

    _skip_with_a_card()
    run = {"master": master, "master_streamed": master_streamed,
           "master_album": batch.master_album,
           "master_album_streamed": batch.master_album_streamed}[entry]
    x = np.zeros((4800, 2), np.float32)
    with pytest.raises(RuntimeError, match=f"{entry}: device 'cuda'.*CUDA"):
        run([x, x] if "album" in entry else x, MasteringParams(),
            ChainConfig.gpu_default(48000))


def test_new_engine_entries_default_to_the_card(tmp_path):
    """Without ``device`` and without a card, ``batch_process_audio``
    reports an ``ERROR:`` naming CUDA for every file and masters none, and
    ``process_audio_from_uri`` raises before it downloads anything."""
    _skip_with_a_card()
    src = tmp_path / "in"
    src.mkdir()
    _two_wavs(src)
    msgs = []
    assert engine.batch_process_audio(SETTINGS, str(src),
                                      str(tmp_path / "out"),
                                      msgs.append) == 0
    errors = [m for m in msgs if m.strip().startswith("ERROR:")]
    assert len(errors) == 2 and all("CUDA" in m for m in errors), msgs
    with pytest.raises(RuntimeError,
                       match="process_audio_from_uri: device 'cuda'.*CUDA"):
        engine.process_audio_from_uri("local://jobs/absent.wav", SETTINGS,
                                      store=LocalFSBlobStore(str(tmp_path)))
    with pytest.raises(RuntimeError,
                       match="process_album_from_uris: device 'cuda'.*CUDA"):
        engine.process_album_from_uris(["local://jobs/absent.wav"], SETTINGS,
                                       store=LocalFSBlobStore(str(tmp_path)))


def test_process_audio_defaults_to_the_card(tmp_path):
    """Without ``device`` and without a card the job fails visibly: False
    and an ``ERROR:`` message naming CUDA, no output file."""
    _skip_with_a_card()
    src, dst = tmp_path / "in.wav", tmp_path / "out.wav"
    wavio.write_wav(src, np.zeros((4800, 2), np.float32), 48000)
    msgs = []
    ok = engine.process_audio({**SETTINGS, "input_file": str(src),
                               "output_file": str(dst)}, msgs.append)
    assert not ok
    assert msgs[-1].startswith("ERROR:") and "CUDA" in msgs[-1], msgs
    assert not dst.exists()


def test_port_imports_without_jax():
    """The card's machine has no jax: the port must import and run, in
    quality mode too, and take an automaster fit step, with jax
    unimportable; the CLI and the GUI logic import."""
    code = (
        "import sys, dataclasses; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import python_audio_mastering_tpu_torch as p\n"
        "from python_audio_mastering_tpu_torch import engine, convert\n"
        "from python_audio_mastering_tpu_torch.parallel import streaming\n"
        "from python_audio_mastering_tpu_torch.ops import limiter, meters,"
        " resample\n"
        "from python_audio_mastering_tpu_torch.serving import store, http,"
        " jobqueue, worker\n"
        "from python_audio_mastering_tpu_torch.parallel import batch\n"
        "from python_audio_mastering_tpu_torch.io import native\n"
        "from python_audio_mastering_tpu_torch import cli, gui_logic\n"
        "from python_audio_mastering_tpu_torch.models import automaster\n"
        "cfg = dataclasses.replace(p.ChainConfig.gpu_default(),"
        " limiter_mode='lookahead_truepeak')\n"
        "y = p.master(np.full((2048, 2), 0.5, np.float32),"
        " p.MasteringParams(), cfg, device='cpu')\n"
        "assert float(abs(y).max()) <= 10 ** (-1 / 20) * (1 + 1e-6)\n"
        "outs, _ = batch.master_album_streamed([np.full((2048, 2), 0.5,"
        " np.float32)] * 2, p.MasteringParams(), cfg, transfer='pcm16',"
        " device='cpu')\n"
        "assert len(outs) == 2 and outs[0].shape == (2048, 2)\n"
        "m = automaster.AutoMasterModel(config=p.ChainConfig.gpu_default(),"
        " device='cpu')\n"
        "x = np.random.default_rng(0).standard_normal((8192, 2)) * 0.1\n"
        "fitted, losses = automaster.fit(m, x,"
        " automaster.spectral_profile(x * 0.5, 44100), steps=1)\n"
        "assert len(losses) == 1 and np.isfinite(losses[0])\n"
        "assert not any(m == 'python_audio_mastering_tpu' or"
        " m.startswith('python_audio_mastering_tpu.') for m in sys.modules)\n"
        "print('ok', tuple(y.shape))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=os.path.dirname(PKG), env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ok (2048, 2)" in proc.stdout


def test_port_sources_name_neither_jax_nor_the_jax_package():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax\b|python_audio_mastering_tpu\b(?!_torch))",
                     re.M)
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f
