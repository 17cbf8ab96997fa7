"""Loudness: the port's kweight_cells (plain version on the CPU, the CUDA
kernel on the card) against the JAX Pallas kernel in interpret mode, its
gating against the JAX gating, and its integrated loudness against the
independent BS.1770 oracle."""

import functools
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
from .test_torch_tf32 import kweight_cells_emulated

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


@functools.cache
def _jax_cells(fs, channels):
    """The JAX cells kernel (interpret mode) on seeded operands, with the
    operands: ``(xrows, s_in, ops, h, cells)``."""
    xrows, s_in, ops, h = _operands(fs, channels, nb=200, seed=10 + channels)
    cells = pmb.kweight_cells(*(jnp.asarray(a.numpy())
                                for a in (xrows, s_in, ops.t, ops.w)),
                              h, interpret=True)
    return xrows, s_in, ops, h, np.asarray(cells)


def _cell_loudness(buckets, fs):
    """Integrated loudness (LUFS) of bucket sums ``(C, n/h)``, gated as
    ``block_cell_energies_rows`` + ``loudness_from_cells`` do, float64."""
    cell, _ = loud._gating_geometry(fs)
    h = math.gcd(cell, L)
    c, nq = buckets.shape
    per = cell // h
    n_cells = nq // per
    cells = torch.as_tensor(np.asarray(buckets, np.float64))[
        :, :n_cells * per].reshape(c, n_cells, per).sum(dim=2).T / cell
    return float(loud.loudness_from_cells(cells))


def _emulated_and_jax(fs, channels):
    xrows, s_in, ops, h, ref = _jax_cells(fs, channels)
    got = kweight_cells_emulated(xrows.numpy(), s_in.numpy(), ops.t.numpy(),
                                 ops.w.numpy(), h)
    return got, ref


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_kweight_cells_kernel_emulated_matches_jax_kernel(fs, channels):
    """K4 as the CUDA kernel computes it, emulated on the CPU (x @ T in
    3xTF32, the states term in fp32, the squares summed in h-buckets left
    to right in each 128-column tile, and a bucket that crosses tiles, as
    at L = 384 at both rates (h = 6 and 192), joined from its tiles'
    pieces), against the JAX kernel in interpret mode: within 1e-5 of its
    max."""
    got, ref = _emulated_and_jax(fs, channels)
    assert got.shape == ref.shape
    ratio = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"K4 emulated vs JAX, {fs} Hz, C={channels}: {ratio:.3e} of the "
          f"max")
    assert ratio <= 1e-5, ratio


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_loudness_of_emulated_kweight_cells_matches_jax(fs, channels):
    """The integrated loudness from the emulated K4's sums, gated by
    ``loudness_from_cells``, within 1e-4 LU of that from the JAX sums."""
    got, ref = _emulated_and_jax(fs, channels)
    d_lu = abs(_cell_loudness(got, fs) - _cell_loudness(ref, fs))
    print(f"K4 emulated vs JAX, {fs} Hz, C={channels}: {d_lu:.3e} LU")
    assert d_lu <= 1e-4, d_lu


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
