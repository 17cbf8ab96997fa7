"""The port's CLI (``python_audio_mastering_tpu_torch.cli``): the JAX CLI's
cases (tests/test_cli.py) with ``--device cpu``, each output held to the
JAX CLI's on the same WAV.

Tolerances: mastered 16-bit WAVs within 2e-4 (the JAX kernels-vs-XLA
chain budget, test_pallas_multiband.py:269) plus one 16-bit step
(3.052e-5) for a sample rounded the other way; the resampler's within
1e-5 (its float64 budget, test_torch_resample.py) plus that step; the
printed meter values within their last printed digit."""

import re
import shutil

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu import cli as jax_cli
from python_audio_mastering_tpu_torch import cli
from python_audio_mastering_tpu_torch.io import wavio

from .conftest import make_signal

FS = 44100
LSB = 1.0 / 32768.0
CHAIN = 2e-4 + LSB
CPU = ["--device", "cpu"]


@pytest.fixture
def in_wav(tmp_path):
    path = str(tmp_path / "in.wav")
    wavio.write_wav(path, (make_signal(FS // 2) * 0.4).astype(np.float32), FS)
    return path


def _both(tmp_path, argv_of, name):
    """Run ``argv_of(out_path)`` through the port's CLI (``--device cpu``)
    and the JAX CLI; returns both exit codes and outputs."""
    ours, theirs = str(tmp_path / f"{name}.wav"), str(tmp_path / f"{name}_jax.wav")
    rc = cli.main(argv_of(ours) + CPU)
    rc_jax = jax_cli.main(argv_of(theirs))
    return rc, rc_jax, wavio.read_wav(ours), wavio.read_wav(theirs)


def _close(got, want, limit):
    (y, fs), (y_ref, fs_ref) = got, want
    assert fs == fs_ref and y.shape == y_ref.shape
    err = float(np.abs(y - y_ref).max())
    print(f"max abs vs the JAX CLI {err:.3e}")
    assert err <= limit, err


def test_master_verb(tmp_path, in_wav, capsys):
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["master", in_wav, out, "--preset", "techno",
                               "--saturation", "15", "--lufs", "-15",
                               "--exact"], "out")
    assert rc == rc_jax == 0
    assert got[1] == FS and got[0].shape[1] == 2
    assert "complete" in capsys.readouterr().out.lower()
    _close(got, want, CHAIN)


def test_master_default_config_matches_jax(tmp_path, in_wav):
    """Without ``--exact``: the port's ``gpu_default`` against the JAX
    CLI's ``tpu_default`` (the same knobs)."""
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["master", in_wav, out, "--preset", "pop",
                               "--width", "1.3", "--multiband"], "fast")
    assert rc == rc_jax == 0
    _close(got, want, CHAIN)


def test_master_no_lufs_and_multiband_flags(tmp_path, in_wav):
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["master", in_wav, out, "--no-lufs",
                               "--multiband", "--low-thresh", "-30",
                               "--exact"], "o2")
    assert rc == rc_jax == 0
    _close(got, want, CHAIN)


def _numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]


def test_measure_verb(in_wav, capsys):
    rc = cli.main(["measure", in_wav] + CPU)
    out = capsys.readouterr().out
    assert rc == 0
    assert "LUFS" in out and "dBTP" in out
    assert jax_cli.main(["measure", in_wav]) == 0
    ref = capsys.readouterr().out
    # LUFS, mono LUFS, LRA (nan on 0.5 s), peak, true peak, to their digits
    got, want = _numbers(out.split(":", 1)[1]), _numbers(ref.split(":", 1)[1])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=0.0101)
    assert "nan LU" in out and "nan LU" in ref


def test_batch_verb(tmp_path, in_wav, capsys):
    in_dir = tmp_path / "batchin"
    in_dir.mkdir()
    shutil.copy(in_wav, in_dir / "a.wav")
    shutil.copy(in_wav, in_dir / "b.wav")
    rc = cli.main(["batch", str(in_dir), str(tmp_path / "batchout"),
                   "--preset", "pop", "--exact"] + CPU)
    assert rc == 0
    assert sorted(p.name for p in (tmp_path / "batchout").iterdir()) == \
        ["a_mastered.wav", "b_mastered.wav"]
    assert jax_cli.main(["batch", str(in_dir), str(tmp_path / "jaxout"),
                         "--preset", "pop", "--exact"]) == 0
    for name in ("a_mastered.wav", "b_mastered.wav"):
        _close(wavio.read_wav(str(tmp_path / "batchout" / name)),
               wavio.read_wav(str(tmp_path / "jaxout" / name)), CHAIN)


def test_batch_empty_folder_fails(tmp_path):
    (tmp_path / "empty").mkdir()
    rc = cli.main(["batch", str(tmp_path / "empty"), str(tmp_path / "o")]
                  + CPU)
    assert rc == 1


def test_missing_input_returns_error(tmp_path, capsys):
    rc = cli.main(["master", str(tmp_path / "nope.wav"),
                   str(tmp_path / "o.wav")] + CPU)
    assert rc == 1
    assert "ERROR: cannot read" in capsys.readouterr().out


def test_cli_resample(tmp_path):
    t = np.arange(FS) / FS
    x = np.stack([np.sin(2 * np.pi * 440 * t)] * 2, axis=1).astype(np.float32)
    src = str(tmp_path / "in.wav")
    wavio.write_wav(src, x, FS)
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["resample", src, out, "--rate", "48000"],
        "r48")
    assert rc == rc_jax == 0
    assert got[1] == 48000
    assert got[0].shape[0] == -(-FS * 160 // 147)
    _close(got, want, 1e-5 + LSB)


def test_cli_master_output_rate(tmp_path, in_wav):
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["master", in_wav, out, "--no-lufs", "--exact",
                               "--output-rate", "48000"], "m48")
    assert rc == rc_jax == 0
    assert got[1] == 48000
    _close(got, want, CHAIN)


def test_cli_resample_float_width(tmp_path):
    """--width float writes IEEE-float WAV (no 16-bit quantization)."""
    x = (np.random.default_rng(0).standard_normal((FS, 2)) * 1e-4) \
        .astype(np.float32)
    src = str(tmp_path / "tiny.wav")
    wavio.write_wav(src, x, FS, float_format=True)
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["resample", src, out, "--rate", "48000",
                               "--width", "float"], "tiny48")
    assert rc == rc_jax == 0
    y, fs_out = got
    assert fs_out == 48000
    # -84 dBFS content survives: 16-bit quantization would destroy it
    assert np.abs(y).max() > 5e-5
    assert np.std(y) > 1e-5
    _close(got, want, 1e-5 * 1e-4)   # the resampler's 1e-5, at 1e-4 scale


def test_cli_album(tmp_path, capsys):
    """``album``: the whole folder masters as one batched run, with
    per-track meters and the folder-batch completion message."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(2):
        x = (make_signal(int(FS * (0.8 + 0.2 * i)), seed=i) * 0.4) \
            .astype(np.float32)
        wavio.write_wav(str(in_dir / f"t{i}.wav"), x, FS)
    out_dir, jax_dir = tmp_path / "out", tmp_path / "jax"
    rc = cli.main(["album", str(in_dir), str(out_dir), "--preset", "pop",
                   "--lufs", "-16", "--exact"] + CPU)
    assert rc == 0
    assert "Album processing complete! 2 files mastered." in \
        capsys.readouterr().out
    assert jax_cli.main(["album", str(in_dir), str(jax_dir), "--preset",
                         "pop", "--lufs", "-16", "--exact"]) == 0
    for i in range(2):
        got = wavio.read_wav(str(out_dir / f"t{i}_mastered.wav"))
        assert got[1] == FS and np.isfinite(got[0]).all()
        _close(got, wavio.read_wav(str(jax_dir / f"t{i}_mastered.wav")),
               CHAIN)

    rc = cli.main(["album", str(tmp_path / "nope"), str(out_dir)] + CPU)
    assert rc == 1


def test_cli_master_quality_flag(tmp_path, in_wav):
    from python_audio_mastering_tpu_torch.ops import meters as met

    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["master", in_wav, out, "--lufs", "-9",
                               "--exact", "--quality"], "q")
    assert rc == rc_jax == 0
    assert float(met.true_peak_db(torch.from_numpy(got[0]))) <= -0.8
    _close(got, want, CHAIN)


def test_automaster_verb(tmp_path, in_wav, capsys):
    """``automaster``: the fit (3 steps) and the one-shot master with the
    fitted settings; the fitted sliders and the output against the JAX
    CLI's.  The printed sliders (two decimals) within one printed step
    (measured: equal) and the outputs within the chain budget (measured
    two 16-bit steps)."""
    ref = str(tmp_path / "ref.wav")
    wavio.write_wav(ref, (make_signal(FS // 2, seed=5) * 0.5).astype(
        np.float32), FS)
    rc, rc_jax, got, want = _both(
        tmp_path, lambda out: ["automaster", in_wav, out, "--reference", ref,
                               "--steps", "3", "--lufs", "-16"], "am")
    assert rc == rc_jax == 0
    text = capsys.readouterr().out
    fitted = re.findall(r"fitted settings: (\{.*\})", text)
    assert len(fitted) == 2 and text.count("step 2: loss") == 2
    import ast

    ours, theirs = (ast.literal_eval(f) for f in fitted)
    print("fitted vs the JAX CLI:", {k: ours[k] - theirs[k] for k in ours
                                     if isinstance(ours[k], float)})
    for k in ("saturation", "bass_boost", "mid_cut", "presence_boost",
              "treble_boost", "width", "lufs"):
        assert abs(ours[k] - theirs[k]) <= 0.0101, (k, ours[k], theirs[k])
    _close(got, want, CHAIN)


def test_cli_without_a_card(tmp_path, in_wav, capsys):
    """No ``--device``: the card is asked for, and without one every verb
    fails with an ``ERROR:`` line naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for argv in (["master", in_wav, str(tmp_path / "o.wav")],
                 ["measure", in_wav],
                 ["automaster", in_wav, str(tmp_path / "a.wav"),
                  "--reference", in_wav, "--steps", "1"],
                 ["resample", in_wav, str(tmp_path / "r.wav"), "--rate",
                  "48000"]):
        assert cli.main(argv) == 1, argv
        out = capsys.readouterr().out
        assert "ERROR:" in out and "CUDA" in out, (argv, out)
    assert not (tmp_path / "o.wav").exists()
