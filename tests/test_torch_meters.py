"""The port's R128 meters (``ops.meters``) against the JAX package's, on
the same numpy-seeded inputs, float64 on both sides: within 1e-9 (LU, dB
or linear).  The interpolator's taps are bitwise the JAX design."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import meters as jmet
from python_audio_mastering_tpu_torch.ops import meters as met

from .conftest import make_signal

FS = 48000


def test_oversample_taps_equal_jax():
    np.testing.assert_array_equal(met._oversample_taps(4),
                                  jmet._oversample_taps(4))


@pytest.mark.parametrize("exclude_pad", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_true_peak_linear_matches_jax(exclude_pad):
    """Edges with a crest next to each end, so the windows that touch the
    padding matter."""
    x = make_signal(FS // 4, fs=FS, seed=1) * 0.7
    x[0], x[-1] = 0.95, -0.97
    got = met.true_peak_linear(torch.from_numpy(x), exclude_pad=exclude_pad)
    ref = jmet.true_peak_linear(jnp.asarray(x), exclude_pad=exclude_pad)
    assert abs(float(got) - float(ref)) <= 1e-9


@pytest.mark.parametrize("channels", [1, 2])
def test_true_peak_db_matches_jax(channels):
    t = np.arange(FS // 2) / FS
    # a quarter-rate sine whose samples miss the crest
    x = np.tile((0.99 * np.sin(2 * np.pi * (FS / 4) * t + np.pi / 4))[:, None],
                (1, channels))
    got = float(met.true_peak_db(torch.from_numpy(x)))
    assert abs(got - float(jmet.true_peak_db(jnp.asarray(x)))) <= 1e-9
    assert got > 20 * math.log10(np.abs(x).max()) + 2.0


@pytest.mark.parametrize("series", ["momentary_loudness",
                                    "shortterm_loudness"])
@pytest.mark.parametrize("downmix", ["bs1770", "reference_mono_mean"])
def test_loudness_series_match_jax(series, downmix):
    x = make_signal(int(3.33 * FS), fs=FS, seed=2) * 0.5
    got = getattr(met, series)(torch.from_numpy(x), FS, downmix=downmix)
    ref = getattr(jmet, series)(jnp.asarray(x), FS, downmix=downmix)
    assert got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)


def test_loudness_range_matches_jax():
    """Loud and quiet sections, so both gates and the percentiles act."""
    x = make_signal(10 * FS, fs=FS, seed=3) * 0.5
    x[3 * FS: 7 * FS] *= 0.1
    got = float(met.loudness_range(torch.from_numpy(x), FS))
    ref = float(jmet.loudness_range(jnp.asarray(x), FS))
    assert got > 10.0
    assert abs(got - ref) <= 1e-9


@pytest.mark.parametrize("case", ["empty", "one_window", "gated_out",
                                  "ramp"])
def test_lra_from_shortterm_matches_jax(case):
    st = {"empty": np.zeros(0), "one_window": np.array([-20.0]),
          "gated_out": np.full(40, -80.0),
          "ramp": np.linspace(-40.0, -10.0, 97)}[case]
    got = float(met.lra_from_shortterm(torch.from_numpy(st)))
    ref = float(jmet.lra_from_shortterm(jnp.asarray(st)))
    assert (math.isnan(got) and math.isnan(ref)) or abs(got - ref) <= 1e-9
