"""The port's polyphase resampler (``ops.resample``) against the JAX
package's: the taps and the phase bank bitwise, the output within 1e-10
(float64 on both sides), and against ``scipy.signal.resample_poly``'s own
design within the JAX test's budget (test_resample.py:36)."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import resample as jrs
from python_audio_mastering_tpu_torch.ops import resample as rs

from .conftest import make_signal

RATIOS = [(160, 147), (147, 160), (2, 1), (1, 3)]


@pytest.mark.parametrize("up,down", RATIOS)
def test_taps_and_bank_equal_jax(up, down):
    h = rs.design_resample_taps(up, down)
    np.testing.assert_array_equal(h, jrs.design_resample_taps(up, down))
    g, v_lo = rs._polyphase_bank(h.tobytes(), h.shape[0], up, down)
    g_ref, v_ref = jrs._polyphase_bank(h.tobytes(), h.shape[0], up, down)
    np.testing.assert_array_equal(g, g_ref)
    assert v_lo == v_ref


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_poly_matches_jax(up, down, channels):
    x = make_signal(20011, channels=channels, seed=up + down)
    if channels == 1:
        x = x[:, 0]
    got = rs.resample_poly(torch.from_numpy(x), up, down)
    ref = np.asarray(jrs.resample_poly(jnp.asarray(x), up, down))
    assert got.shape == ref.shape == ((-(-x.shape[0] * up // down),)
                                      + x.shape[1:])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_poly_matches_scipy_default_design(up, down):
    x = np.random.default_rng(7).standard_normal(30000)
    got = rs.resample_poly(torch.from_numpy(x), up, down).numpy()
    np.testing.assert_allclose(got, sps.resample_poly(x, up, down),
                               rtol=1e-4, atol=1e-5)


def test_resample_rates_and_validation():
    x = torch.from_numpy(make_signal(4410, channels=2))
    y = rs.resample(x, 44100, 48000)
    assert y.shape == (4800, 2)
    np.testing.assert_array_equal(y.numpy(),
                                  rs.resample_poly(x, 160, 147).numpy())
    assert rs.resample(x, 48000, 48000) is x
    assert rs.resample_poly(x, 3, 3) is x
    with pytest.raises(ValueError):
        rs.resample(x, 0, 48000)
    with pytest.raises(ValueError):
        rs.resample_poly(x, 2, 1, taps=np.ones(10))
