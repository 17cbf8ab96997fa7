"""The port's GUI logic (``python_audio_mastering_tpu_torch.gui_logic``):
the JAX package's tests/test_gui.py cases over the port's copy, the same
rules checked against the JAX ``GuiState`` where both answer, the
automaster engine end to end (``engine.automaster_audio``, ``device=
"cpu"``) against the JAX engine's, and a real-Tk case that skips without
a display, as JAX's does.

Tolerances: the automaster engine's fitted sliders within 1e-3 (float32
fits, three Adam steps; measured 2.0e-5) and its 16-bit output
within the 2e-4 chain budget plus one 16-bit step."""

import os

import numpy as np
import pytest

from python_audio_mastering_tpu import gui_logic as jax_gui_logic
from python_audio_mastering_tpu_torch import MasteringParams, engine
from python_audio_mastering_tpu_torch.gui_logic import (
    AUTOMASTER_KEYS,
    MB_SLIDERS,
    SLIDERS,
    GuiState,
    classify_status,
    default_output_path,
)
from python_audio_mastering_tpu_torch.io import wavio
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS

from .conftest import make_signal

FS = 44100
CHAIN = 2e-4 + 1.0 / 32768.0


def test_settings_dict_matches_reference_shape():
    """mastering_gui.py:179-190: 13 sliders + multiband + compress; the
    same dict as the JAX GuiState's."""
    st = GuiState()
    s = st.get_current_settings()
    expected_keys = {a for a, *_ in SLIDERS} | {a for a, *_ in MB_SLIDERS} \
        | {"multiband", "compress"}
    assert set(s) == expected_keys
    assert len([a for a, *_ in SLIDERS + MB_SLIDERS]) == 13
    assert s["compress"] is False
    assert s["multiband"] is False
    assert s["lufs"] == -14.0 and s["width"] == 1.0
    assert s["low_band_threshold"] == -25.0 and s["high_band_ratio"] == 4.0
    assert s == jax_gui_logic.GuiState().get_current_settings()
    assert SLIDERS == jax_gui_logic.SLIDERS
    assert MB_SLIDERS == jax_gui_logic.MB_SLIDERS
    assert AUTOMASTER_KEYS == jax_gui_logic.AUTOMASTER_KEYS


def test_settings_feed_mastering_params():
    """The GUI dict (long spellings) maps onto the port's params schema."""
    st = GuiState()
    st.set_value("low_band_threshold", -33.0)
    st.set_value("mid_band_ratio", 5.0)
    st.multiband = True
    p = MasteringParams.from_settings(st.get_current_settings())
    assert p.low_thresh == -33.0 and p.mid_ratio == 5.0
    assert p.multiband is True and p.lufs_enabled


def test_apply_preset_verbatim_and_none():
    st, ref = GuiState(), jax_gui_logic.GuiState()
    for name, vals in EQ_PRESETS.items():
        st.apply_preset(name)
        ref.apply_preset(name)
        for k in ("bass_boost", "mid_cut", "presence_boost", "treble_boost"):
            assert st.values[k] == float(vals[k]), (name, k)
        assert st.values == ref.values
    st.apply_preset("None")
    assert all(st.values[k] == 0.0 for k in
               ("bass_boost", "mid_cut", "presence_boost", "treble_boost"))


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        GuiState().apply_preset("vaporwave")


def test_set_value_clamps_to_slider_range():
    st = GuiState()
    st.set_value("saturation", 250.0)
    assert st.values["saturation"] == 100.0
    st.set_value("lufs", -99.0)
    assert st.values["lufs"] == -24.0
    with pytest.raises(KeyError):
        st.set_value("gain_of_nonsense", 1.0)


def test_busy_gating_and_status_contract():
    st = GuiState()
    settings, err = st.start_single_job("in.wav", "out.wav")
    assert err is None and settings["input_file"] == "in.wav"
    assert st.busy
    s2, err2 = st.start_single_job("a.wav", "b.wav")
    assert s2 is None and "already running" in err2
    assert st.on_status("Processed chunk 3/7...") == "progress" and st.busy
    assert st.on_status("Processing complete! Saved to out.wav") == "done"
    assert not st.busy
    _, err3 = st.start_batch_job("", "outdir")
    assert "folder" in err3
    settings, err4 = st.start_batch_job("indir", "outdir")
    assert err4 is None and st.busy
    assert st.on_status("No audio files found in the input folder.") == "empty"
    assert not st.busy
    st.start_single_job("x.wav", "y.wav")
    assert st.on_status("ERROR: boom") == "error" and not st.busy


def test_classify_status_complete_beats_error():
    msgs = ["Processing complete! Saved to /data/error_analysis/out.wav",
            "ERROR: decode failed", "Batch processing complete! 3/3",
            "no audio files", "Loading x.wav...", "Fitting 3/40: loss 0.5"]
    want = ["done", "error", "done", "empty", "progress", "progress"]
    assert [classify_status(m) for m in msgs] == want
    assert [jax_gui_logic.classify_status(m) for m in msgs] == want


def test_default_output_path():
    assert default_output_path("/a/b/track.wav") == "/a/b/track_mastered.wav"
    assert default_output_path("t.mp3") == "t_mastered.mp3"


def test_gui_state_drives_engine_end_to_end(tmp_path):
    """The full desktop flow, headless: GuiState settings -> the port's
    engine -> terminal status string -> busy cleared."""
    from python_audio_mastering_tpu_torch import ChainConfig

    x = (make_signal(FS) * 0.4).astype(np.float32)
    in_path = str(tmp_path / "in.wav")
    wavio.write_wav(in_path, x, FS)

    st = GuiState()
    st.apply_preset("pop")
    st.set_value("saturation", 15.0)
    settings, err = st.start_single_job(in_path, str(tmp_path / "out.wav"))
    assert err is None
    msgs = []

    def cb(m):
        msgs.append(m)
        st.on_status(m)

    ok = engine.process_audio(settings, cb, config=ChainConfig(sample_rate=FS),
                              device="cpu")
    assert ok and not st.busy
    assert any(classify_status(m) == "done" for m in msgs)
    out, fs2 = wavio.read_wav(str(tmp_path / "out.wav"))
    assert fs2 == FS and np.isfinite(out).all()


@pytest.mark.skipif(not os.environ.get("DISPLAY"),
                    reason="no display server")
def test_real_tk_app_settings_roundtrip():
    from python_audio_mastering_tpu_torch.gui import MasteringApp

    app = MasteringApp(device="cpu")
    try:
        app.vars["saturation"].set(30.0)
        app.use_multiband.set(True)
        s = app.get_current_settings()
        assert s["saturation"] == 30.0 and s["multiband"] is True
        assert s["compress"] is False
    finally:
        app.destroy()


def test_automaster_job_validation_and_busy_gate():
    st = GuiState()
    s, err = st.start_automaster_job("", "ref.wav", "out.wav")
    assert s is None and "select" in err.lower()
    s, err = st.start_automaster_job("in.wav", "ref.wav", "out.wav")
    assert err is None and st.busy
    assert s["input_file"] == "in.wav"
    assert s["reference_file"] == "ref.wav"
    assert s["output_file"] == "out.wav"
    s2, err2 = st.start_automaster_job("a.wav", "b.wav", "c.wav")
    assert s2 is None and "already running" in err2
    assert st.on_status("Processing complete! Saved to out.wav") == "done"
    assert not st.busy


def test_apply_fitted_settings_clamps_to_slider_ranges():
    st = GuiState()
    fitted = {"saturation": 35.0, "bass_boost": 2.5, "mid_cut": -3.0,
              "presence_boost": 9.0, "treble_boost": 1.0, "width": 1.4,
              "lufs": -14.0, "multiband": False}
    applied = st.apply_fitted_settings(fitted)
    assert set(applied) == set(AUTOMASTER_KEYS)
    assert st.values["saturation"] == 35.0
    assert st.values["mid_cut"] == 0.0       # clamped: slider floor is 0
    assert st.values["presence_boost"] == 6.0  # clamped: slider cap is 6
    assert st.values["width"] == 1.4
    assert st.preset == "None"
    assert applied == jax_gui_logic.GuiState().apply_fitted_settings(fitted)


def test_automaster_engine_end_to_end(tmp_path):
    """The automaster engine fits finite sliders, writes the output, and
    finishes with a 'complete' message, as the JAX engine does on the same
    WAVs and config; the fitted settings and the output against JAX's."""
    from python_audio_mastering_tpu import ChainConfig as JConfig
    from python_audio_mastering_tpu import engine as jax_engine
    from python_audio_mastering_tpu_torch import ChainConfig

    x = (make_signal(FS, fs=FS) * 0.3).astype(np.float32)
    ref = (make_signal(FS, fs=FS, seed=5) * 0.5).astype(np.float32)
    wavio.write_wav(tmp_path / "in.wav", x, FS)
    wavio.write_wav(tmp_path / "ref.wav", ref, FS)
    job = {"input_file": str(tmp_path / "in.wav"),
           "reference_file": str(tmp_path / "ref.wav"), "lufs": -16.0}
    knobs = dict(sample_rate=FS, block_size=256, comp_hop=8,
                 comp_block_ctrl=256)
    msgs, jmsgs = [], []
    fitted = engine.automaster_audio(
        {**job, "output_file": str(tmp_path / "out.wav")}, msgs.append,
        config=ChainConfig(**knobs), steps=3, device="cpu")
    want = jax_engine.automaster_audio(
        {**job, "output_file": str(tmp_path / "jax.wav")}, jmsgs.append,
        config=JConfig(filter_method="blocked", **knobs), steps=3)
    assert fitted is not None and want is not None
    assert all(np.isfinite(v) for v in fitted.values()
               if isinstance(v, float))
    assert (tmp_path / "out.wav").exists()
    assert any("complete" in m.lower() for m in msgs)
    assert [m.split(":")[0] for m in msgs if m.startswith("Fitting")] == \
        [f"Fitting {i}/3" for i in (1, 2, 3)] == \
        [m.split(":")[0] for m in jmsgs if m.startswith("Fitting")]
    assert set(fitted) == set(want)
    diff = {k: abs(fitted[k] - want[k]) for k in want
            if isinstance(want[k], float)}
    print("fitted vs the JAX engine:", diff)
    assert max(diff.values()) <= 1e-3, diff
    y, _ = wavio.read_wav(str(tmp_path / "out.wav"))
    y_ref, _ = wavio.read_wav(str(tmp_path / "jax.wav"))
    err = float(np.abs(y - y_ref).max())
    print(f"output vs the JAX engine: max abs {err:.3e}")
    assert err <= CHAIN


def test_automaster_engine_needs_every_path():
    msgs = []
    assert engine.automaster_audio({"input_file": "in.wav"}, msgs.append,
                                   device="cpu") is None
    assert msgs == ["ERROR: input_file, reference_file and output_file "
                    "must be set."]
