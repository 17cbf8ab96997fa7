"""The port's blocked IIR (python_audio_mastering_tpu_torch.ops.iir)
against the JAX package's and scipy.

The float64 operators are built by the same host algebra: bit-equal.  The
float32 states pass is held to the JAX states-pass budget, rtol 2e-5
(test_pallas_multiband.py:44), with atol 1e-6 for states near zero.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.models.chain import eq_sos as jax_eq_sos
from python_audio_mastering_tpu.ops import iir as jiir
from python_audio_mastering_tpu.ops import loudness as jloud
from python_audio_mastering_tpu_torch import MasteringParams
from python_audio_mastering_tpu_torch.models.chain import eq_sos
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops.loudness import kweight_sos

from .conftest import make_signal

FS = 44100
BENCH = {"saturation": 20, "preset": "techno", "width": 1.3, "lufs": -14.0}


def _filters(fs=FS):
    eq = eq_sos(MasteringParams.from_settings(BENCH), fs)
    return {"eq": eq.astype(np.float32).astype(np.float64),
            "kweight": kweight_sos(fs)}


@pytest.mark.parametrize("name", ["eq", "kweight"])
def test_eq_and_kweight_designs_match_jax(name):
    ours = _filters()[name]
    if name == "eq":
        ref = np.asarray(jax_eq_sos(JParams.from_settings(BENCH), FS))
        ref = ref.astype(np.float32).astype(np.float64)
    else:
        ref = jloud.kweight_sos(FS)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("L", [384, 512])
@pytest.mark.parametrize("name", ["eq", "kweight"])
def test_operators_bit_equal(name, L):
    sos = _filters()[name]
    key = (sos.tobytes(), sos.shape[0])
    for a, b in zip(iir.cascade_state_space(sos),
                    jiir.cascade_state_space(jnp.asarray(sos))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-14, atol=1e-15)
    for a, b in zip(iir._state_space_static(*key),
                    jiir._state_space_static(*key)):
        np.testing.assert_array_equal(a, b)
    ours = iir._blocked_operators_static(*key, L)
    ref = jiir._blocked_operators_static(*key, L)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    al = np.ascontiguousarray(ours[3])
    for group in (128, 7):
        for a, b in zip(iir._boundary_operators_from_a(al.tobytes(),
                                                       al.shape[0], group),
                        jiir._boundary_operators_from_a(al.tobytes(),
                                                        al.shape[0], group)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("name", ["eq", "kweight"])
def test_states_rows_match_jax(name, carry):
    sos = _filters()[name]
    L, nb, c = 384, 90, 2
    x = (make_signal(nb * L, channels=c, seed=3) * 0.5).T.astype(np.float32)
    xrows = x.reshape(c, nb, L)
    k = sos.shape[0]
    zi = (np.random.default_rng(1).standard_normal((k, 2, c)) * 0.1
          ).astype(np.float32) if carry else None
    s_ref, zf_ref, _ = jiir.sosfilt_states_rows(
        sos, jnp.asarray(xrows), zi=None if zi is None else jnp.asarray(zi))
    s_in, zf, _ = iir.sosfilt_states_rows(
        sos, torch.from_numpy(xrows),
        zi=None if zi is None else torch.from_numpy(zi))
    np.testing.assert_allclose(s_in.numpy(), np.asarray(s_ref), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_ref), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", ["eq", "kweight"])
def test_blocked_rows_matches_scipy(name, channels):
    """The plain blocked filter in float64 is scipy's sosfilt to 1e-9,
    including a carried initial state and the returned final state."""
    sos = _filters()[name]
    L, nb = 384, 40
    x = make_signal(nb * L, channels=channels, seed=5)          # (N, C)
    zi = np.random.default_rng(2).standard_normal((sos.shape[0], 2, channels))
    ref, zf_ref = sps.sosfilt(sos, x, axis=0, zi=zi)
    y, zf = iir.sosfilt_blocked_rows(
        sos, torch.from_numpy(np.ascontiguousarray(x.T)).reshape(
            channels, nb, L), zi=torch.from_numpy(zi))
    np.testing.assert_allclose(y.reshape(channels, -1).numpy().T, ref,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(zf.numpy(), zf_ref, rtol=1e-9, atol=1e-9)
