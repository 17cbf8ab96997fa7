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


@pytest.mark.parametrize("params,config,error,match", [
    pytest.param({"multiband": True}, {"comp_ballistics": "bogus"},
                 ValueError, "unknown comp_ballistics 'bogus'",
                 id="params0-config0-multiband"),
    pytest.param({}, {"variant": "bogus"}, ValueError,
                 "unknown variant 'bogus'", id="params1-config1-legacy"),
    pytest.param({}, {"limiter_mode": "lookahead_truepeak"}, None, None,
                 id="params2-config2-lookahead"),
    pytest.param({}, {"limiter_mode": "brickwall"}, ValueError,
                 "unknown limiter_mode 'brickwall'",
                 id="params3-config3-unknown-limiter"),
])
def test_outside_the_slice_raises(params, config, error, match):
    """What the chain refuses: a variant, a ballistics execution or a
    limiter mode that does not exist is a ``ValueError`` (the legacy
    variant and every ballistics execution of the JAX package run, see
    test_torch_legacy.py and test_torch_ballistics_modes.py).  Quality
    mode (the lookahead limiter) runs: a hot input comes out under the
    ceiling."""
    x = (make_signal(4096, seed=3) * 2.0).astype(np.float32)
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS), **config)
    p = MasteringParams.from_settings(params)
    if error is None:
        y = master(x, p, cfg, device="cpu").numpy()
        assert y.shape == x.shape and np.isfinite(y).all()
        assert np.abs(y).max() <= 10.0 ** (-1.0 / 20.0) * (1 + 1e-6)
        return
    with pytest.raises(error, match=match):
        master(x, p, cfg, device="cpu")


@pytest.mark.parametrize("multiband", [False, True])
def test_quality_master_matches_jax(multiband):
    """Quality mode (``limiter_mode="lookahead_truepeak"``) against the JAX
    quality chain at -8 LUFS, the limiter working: JAX in float64 (its XLA
    rows body; its float32 attack sum drifts, see test_torch_limiter.py),
    the port in float32, within the 2e-4 chain budget, and the port's
    sample peak within the ceiling."""
    x = (make_signal(int(FS * 1.5), seed=7) * 0.5).astype(np.float32)
    settings = {**BENCH_NO_MB, "lufs": -8.0, "multiband": multiband}
    jcfg = dataclasses.replace(JConfig.tpu_default(FS), dtype="float64",
                               mb_kernel="xla",
                               limiter_mode="lookahead_truepeak")
    ref = jax_master(jnp.asarray(x), JParams.from_settings(settings), jcfg,
                     return_result=True)
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS),
                              limiter_mode="lookahead_truepeak")
    got = master(x, MasteringParams.from_settings(settings), cfg,
                 return_result=True, device="cpu")
    y = got.audio.numpy()
    err = np.max(np.abs(y - np.asarray(ref.audio)))
    print(f"quality master, multiband {multiband}: max abs {err:.3e}")
    assert err < 2e-4, err
    assert abs(float(got.measured_lufs) - float(ref.measured_lufs)) < 1e-3
    assert np.abs(y).max() <= 10.0 ** (-1.0 / 20.0) * (1 + 1e-6)


@pytest.mark.parametrize("variant", ["worker", "legacy"])
@pytest.mark.parametrize("multiband", [False, True])
def test_float64_master_matches_jax_float64(variant, multiband):
    """In float64 both chains compute in float64 throughout: the exciter's
    coefficients and the legacy EQ's blend gains follow the signal's
    dtype (a float32-rounded ``dry`` left the float64 chains 2.5e-9 apart
    behind the multiband compressor, and 1.9e-7 LU apart in loudness), and
    the legacy split's operators are built in it (in float32 its products
    refused the float64 signal)."""
    x = make_signal(FS, seed=7) * 0.5
    settings = {"saturation": 30, "preset": "techno", "lufs": -14.0,
                "multiband": multiband}
    jcfg = JConfig(sample_rate=FS, dtype="float64", comp_ballistics="scan",
                   variant=variant)
    ref = jax_master(jnp.asarray(x), JParams.from_settings(settings), jcfg,
                     return_result=True)
    got = master(x, MasteringParams.from_settings(settings),
                 ChainConfig(sample_rate=FS, dtype="float64",
                             variant=variant),
                 return_result=True, device="cpu")
    np.testing.assert_allclose(got.audio.numpy(), np.asarray(ref.audio),
                               rtol=1e-12, atol=1e-13)
    assert abs(float(got.measured_lufs) - float(ref.measured_lufs)) < 1e-11
