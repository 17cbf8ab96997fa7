"""The port's one-shot master() against the JAX package's eager master()
on the bench settings, multiband off and on, tpu_default knobs and the
Pallas kernels forced (interpret mode): max abs < 2e-4, the JAX
kernels-vs-XLA chain budget (test_pallas_multiband.py:269), and the
measured loudness within 1e-3 LU.

Eager JAX builds its EQ operators in float64 on the host from the
float32-rounded coefficients, as the port does (under jit it builds them
in float32 in-graph instead)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.models.chain import master as jax_master
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, master

from .conftest import make_signal

FS = 44100
BENCH_NO_MB = {"saturation": 20, "preset": "techno", "width": 1.3,
               "lufs": -14.0}


@pytest.mark.parametrize("channels,seconds,multiband", [
    pytest.param(2, 1.5, False, id="2-1.5"),
    pytest.param(1, 1.5, False, id="1-1.5"),
    pytest.param(2, 0.03, False, id="2-0.03"),
    pytest.param(2, 1.5, True, id="2-1.5-multiband"),
    pytest.param(1, 1.5, True, id="1-1.5-multiband"),
])
def test_master_matches_jax(channels, seconds, multiband):
    """Stereo, mono, and a signal shorter than 4 blocks (the port pads it
    into the rows body; JAX runs its row-major body); with multiband, the
    JAX chain's Pallas multiband kernels and exact ballistics."""
    x = (make_signal(int(FS * seconds), channels=channels, seed=7) * 0.5
         ).astype(np.float32)
    settings = {**BENCH_NO_MB, "multiband": multiband}
    jcfg = dataclasses.replace(JConfig.tpu_default(FS),
                               mb_kernel="pallas_interpret")
    ref = jax_master(jnp.asarray(x), JParams.from_settings(settings),
                     jcfg, return_result=True)
    got = master(x, MasteringParams.from_settings(settings),
                 ChainConfig.gpu_default(FS), return_result=True,
                 device="cpu")
    assert got.audio.shape == x.shape
    err = np.max(np.abs(got.audio.numpy() - np.asarray(ref.audio)))
    assert err < 2e-4, err
    m_ref, m_got = float(ref.measured_lufs), float(got.measured_lufs)
    if np.isfinite(m_ref):
        assert abs(m_got - m_ref) < 1e-3, (m_got, m_ref)
    else:
        assert m_got == m_ref


def test_master_no_lufs_and_1d_input():
    """lufs off: no gain, NaN measurement; (N,) input gives (N,) output
    equal to the (N, 1) run."""
    x = (make_signal(FS, channels=1, seed=2) * 0.5).astype(np.float32)
    params = MasteringParams.from_settings({"saturation": 10, "lufs": None})
    cfg = ChainConfig.gpu_default(FS)
    res = master(x, params, cfg, return_result=True, device="cpu")
    assert np.isnan(float(res.measured_lufs))
    assert float(res.applied_gain_db) == 0.0
    flat = master(x[:, 0], params, cfg, device="cpu")
    assert flat.shape == (FS,)
    np.testing.assert_array_equal(flat.numpy(), res.audio[:, 0].numpy())


@pytest.mark.parametrize("params,config,match", [
    pytest.param({"multiband": True}, {"comp_ballistics": "blocked"},
                 "blocked", id="params0-config0-multiband"),
    pytest.param({}, {"variant": "legacy"}, "legacy",
                 id="params1-config1-legacy"),
    pytest.param({}, {"limiter_mode": "lookahead_truepeak"}, "lookahead",
                 id="params2-config2-lookahead"),
])
def test_outside_the_slice_raises(params, config, match):
    x = np.zeros((4096, 2), np.float32)
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS), **config)
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*ROADMAP"):
        master(x, MasteringParams.from_settings(params), cfg, device="cpu")
