"""The port's settings contract and JAX carry-over
(python_audio_mastering_tpu_torch.config / .convert) against the JAX
package's config.  Exact equality: both are the same host arithmetic."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu import config as jcfg
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, convert
from python_audio_mastering_tpu_torch.parallel.streaming import StreamState

SETTINGS = [
    {},
    {"saturation": 20, "preset": "techno", "width": 1.3, "lufs": -14.0},
    {"preset": "rock", "bass_boost": 2.5, "lufs": None},
    {"preset": "None", "mid_cut": 1.0, "multiband": True},
    {"use_multiband": True, "low_band_threshold": -30, "mid_band_ratio": 5},
    {"low_thresh": -10, "low_band_threshold": -30, "high_ratio": 2,
     "high_band_ratio": 8, "lufs": -9},
    {"preset": "dubstep", "treble_boost": 0.0, "presence_boost": None},
]


@pytest.mark.parametrize("settings", SETTINGS)
def test_from_settings_matches_jax(settings):
    ours = MasteringParams.from_settings(settings)
    ref = jcfg.MasteringParams.from_settings(settings)
    for f in dataclasses.fields(MasteringParams):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.to_settings() == ref.to_settings()


@pytest.mark.parametrize("settings", SETTINGS)
def test_params_from_jax_round_trip(settings):
    ref = jcfg.MasteringParams.from_settings(settings)
    assert convert.params_from_jax(ref) == MasteringParams.from_settings(
        settings)


@pytest.mark.parametrize("sample_rate", [44100, 48000])
def test_config_from_jax(sample_rate):
    ours = convert.config_from_jax(jcfg.ChainConfig.tpu_default(sample_rate))
    assert ours == ChainConfig.gpu_default(sample_rate)
    assert convert.config_from_jax(jcfg.ChainConfig()) == ChainConfig()


def test_stream_state_from_jax():
    r = np.random.default_rng(0)
    eq_zi, kw_zi = r.standard_normal((4, 2, 2)), r.standard_normal((2, 2, 2))
    st = convert.stream_state_from_jax(
        jstream.StreamState(eq_zi=eq_zi, kw_zi=kw_zi))
    assert isinstance(st, StreamState)
    assert st.eq_zi.dtype == torch.float32 and st.eq_zi.shape == (4, 2, 2)
    np.testing.assert_array_equal(st.kw_zi.numpy(), kw_zi.astype(np.float32))
    assert convert.stream_state_from_jax(jstream.StreamState()).eq_zi is None
    # a multiband state: every array of the nested dict, keys kept
    mb = {"crossover": {"lp": jnp.asarray(r.standard_normal((2, 2, 2))),
                        "hp": jnp.asarray(r.standard_normal((2, 2, 2)))},
          "att": jnp.asarray([1.5, 0.0, 3.25]),
          "ctrl_tail": jnp.asarray(r.random((3, 56)))}
    st = convert.stream_state_from_jax(
        jstream.StreamState(eq_zi=eq_zi, mb=mb, kw_zi=kw_zi))
    assert set(st.mb) == {"crossover", "att", "ctrl_tail"}
    assert set(st.mb["crossover"]) == {"lp", "hp"}
    for got, ref in ((st.mb["crossover"]["lp"], mb["crossover"]["lp"]),
                     (st.mb["crossover"]["hp"], mb["crossover"]["hp"]),
                     (st.mb["att"], mb["att"]),
                     (st.mb["ctrl_tail"], mb["ctrl_tail"])):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref, np.float32))
