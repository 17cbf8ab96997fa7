"""Loudness: the port's kweight_cells (plain version on the CPU, the CUDA
kernel on the card) against the JAX Pallas kernel in interpret mode, its
gating against the JAX gating, and its integrated loudness against the
independent BS.1770 oracle."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import loudness as jloud
from python_audio_mastering_tpu.ops import pallas_multiband as pmb
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import loudness as loud

from .conftest import make_signal
from .oracles.bs1770_ref import integrated_loudness as oracle_lufs

L = 384



def _operands(fs, channels, nb=100, seed=0, device="cpu"):
    x = (make_signal(nb * L, channels=channels, fs=fs, seed=seed) * 0.5).T
    xrows = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                            device=device).reshape(channels, nb, L)
    s_in, _, ops = iir.sosfilt_states_rows(loud.kweight_sos(fs), xrows)
    return xrows, s_in, ops, math.gcd(loud._gating_geometry(fs)[0], L)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_kweight_cells_ref_matches_jax_kernel(fs, channels):
    """Budget of the JAX cells kernel: rtol 2e-5, atol 1e-10
    (test_pallas_multiband.py:221).  h = 6 at 44.1 kHz, 192 at 48 kHz."""
    xrows, s_in, ops, h = _operands(fs, channels, seed=channels)
    got = cmb.kweight_cells(xrows, s_in, ops.t, ops.w, h)
    ref = pmb.kweight_cells(*(jnp.asarray(a.numpy())
                              for a in (xrows, s_in, ops.t, ops.w)),
                            h, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=1e-10)


@pytest.mark.parametrize("masked", [False, True])
def test_loudness_from_cells_matches_jax(masked):
    """Same gating on the same float64 cells: 1e-9 LU."""
    r = np.random.default_rng(3)
    cells = 10.0 ** r.uniform(-9, -1, size=(200, 2))
    cells[40:60] = 1e-12                         # gated out absolutely
    mask = np.arange(200) < 170 if masked else None
    got = loud.loudness_from_cells(
        torch.from_numpy(cells),
        cell_mask=None if mask is None else torch.from_numpy(mask))
    ref = jloud.loudness_from_cells(
        jnp.asarray(cells), cell_mask=None if mask is None else jnp.asarray(mask))
    assert abs(float(got) - float(ref)) < 1e-9
    silent = loud.loudness_from_cells(torch.zeros((20, 1)))
    assert float(silent) == -math.inf
    assert float(loud.gain_for_target(silent, -14.0)) == 1.0


@pytest.mark.parametrize("downmix", ["reference_mono_mean", "bs1770"])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_integrated_loudness_matches_oracle(fs, downmix):
    """float32 rows through the float64-built K operators: within 1e-3 LU
    of the float64 scipy oracle."""
    nb = int(2.5 * fs) // L
    x = make_signal(nb * L, channels=2, fs=fs, seed=9) * 0.5
    xrows = torch.as_tensor(np.ascontiguousarray(x.T, np.float32)).reshape(
        2, nb, L)
    got = float(loud.integrated_loudness_rows(xrows, fs, downmix=downmix))
    ref = oracle_lufs(x.mean(axis=1) if downmix == "reference_mono_mean"
                      else x, fs)
    assert abs(got - ref) < 1e-3, (got, ref)
