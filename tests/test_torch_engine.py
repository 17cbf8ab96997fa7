"""The port's streamed runner and engine entry point.

Streamed vs one-shot and vs the JAX streamed runner: atol 2e-4, the JAX
kernels-vs-XLA chain budget (test_pallas_multiband.py:117, 269)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.parallel.streaming import (
    master_streamed as jax_master_streamed,
)
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, master
from python_audio_mastering_tpu_torch import engine
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.parallel.streaming import (
    default_chunk_frames,
    master_streamed,
)

from .conftest import make_signal

SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
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
    ({"quality": True}, "lookahead"),
    ({"output_sample_rate": 44100}, "resampler"),
])
def test_process_audio_reports_outside_the_slice(tmp_path, settings, match):
    src = tmp_path / "in.wav"
    wavio.write_wav(src, np.zeros((4800, 2), np.float32), 48000)
    msgs = []
    ok = engine.process_audio({**settings, "input_file": str(src),
                               "output_file": str(tmp_path / "o.wav")},
                              msgs.append, device="cpu")
    assert not ok
    assert msgs[-1].startswith("ERROR") and match in msgs[-1]
    assert "ROADMAP" in msgs[-1]


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


@pytest.mark.parametrize("kwargs", [{"transfer": "pcm16"},
                                    {"checkpoint_dir": "ckpt"},
                                    {"return_meters": True}])
def test_master_streamed_outside_the_slice_raises(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        master_streamed(np.zeros((4800, 2), np.float32), MasteringParams(),
                        ChainConfig.gpu_default(48000), device="cpu",
                        **kwargs)


def _skip_with_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")


@pytest.mark.parametrize("entry", ["master", "master_streamed"])
def test_entry_points_default_to_the_card(entry):
    """Called without ``device``, the entry points run on the card; with
    none they raise, naming the missing device, and never fall back to
    the CPU."""
    _skip_with_a_card()
    run = {"master": master, "master_streamed": master_streamed}[entry]
    with pytest.raises(RuntimeError, match=f"{entry}: device 'cuda'.*CUDA"):
        run(np.zeros((4800, 2), np.float32), MasteringParams(),
            ChainConfig.gpu_default(48000))


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
    """The card's machine has no jax: the port must import and run with
    jax unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import python_audio_mastering_tpu_torch as p\n"
        "from python_audio_mastering_tpu_torch import engine, convert\n"
        "from python_audio_mastering_tpu_torch.parallel import streaming\n"
        "y = p.master(np.zeros((2048, 2), np.float32), p.MasteringParams(),"
        " p.ChainConfig.gpu_default(), device='cpu')\n"
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
