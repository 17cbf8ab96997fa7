"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the test conftest (which imports jax),
so the card's machine, which has no jax, runs it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` need an NVIDIA GPU and skip without one; the
others check the wrappers' device dispatch on the CPU.  Kernel vs plain
on the card: fp32 sums in another order, max abs ≤ 1e-4 (K4: relative
to the largest bucket).
"""

import math

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

L = 384
SETTINGS = {"saturation": 25, "preset": "dubstep", "width": 1.4,
            "lufs": -14.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _signal(n, channels, fs, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 55 * t) + 0.2 * np.sin(2 * np.pi * 3000 * t)
         + 0.1 * r.standard_normal((channels, n)))
    return np.ascontiguousarray(x, np.float32)            # (C, N)


def _front_operands(channels, nb, device, fs=44100):
    params = MasteringParams.from_settings(SETTINGS)
    chain = MasteringChain(ChainConfig.gpu_default(fs)).to(device)
    xrows = torch.as_tensor(_signal(nb * L, channels, fs, channels),
                            device=device).reshape(channels, nb, L)
    ops = chain.eq_ops(params)
    s_in, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=ops)
    return (xrows, s_in, ops.t, ops.w, params.saturation, params.width)


def _kweight_operands(channels, nb, device, fs):
    xrows = torch.as_tensor(_signal(nb * L, channels, fs, 7 + channels),
                            device=device).reshape(channels, nb, L)
    s_in, _, ops = iir.sosfilt_states_rows(loud.kweight_sos(fs), xrows)
    return (xrows, s_in, ops.t, ops.w,
            math.gcd(loud._gating_geometry(fs)[0], L))


@pytest.mark.parametrize("emit_mono", [False, True])
def test_wrappers_take_the_plain_version_on_cpu(emit_mono):
    """A CPU tensor gets the plain version and counts no launch."""
    cmb.reset_launch_counts()
    args = _front_operands(2, 9, "cpu")
    got = cmb.front_chain(*args, emit_mono=emit_mono)
    ref = cmb.front_chain_ref(*args, emit_mono=emit_mono)
    for g, r in zip(got if emit_mono else (got,), ref if emit_mono else (ref,)):
        assert torch.equal(g, r)
    kargs = _kweight_operands(1, 20, "cpu", 44100)
    assert torch.equal(cmb.kweight_cells(*kargs), cmb.kweight_cells_ref(*kargs))
    assert cmb.launch_counts() == {"front_chain": 0, "kweight_cells": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither CPU nor CUDA: no kernel, no silent fallback."""
    args = [a.to("meta") if torch.is_tensor(a) else a
            for a in _front_operands(1, 4, "cpu")]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.front_chain(*args)
    kargs = [a.to("meta") if torch.is_tensor(a) else a
             for a in _kweight_operands(1, 4, "cpu", 44100)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.kweight_cells(*kargs)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_mono", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_front_chain_kernel_matches_plain(cuda_device, channels, emit_mono):
    """nb = 45 leaves a ragged last group for every channel count."""
    args = _front_operands(channels, 45, cuda_device)
    before = cmb.front_chain.launches
    got = cmb.front_chain(*args, emit_mono=emit_mono)
    torch.cuda.synchronize()
    assert cmb.front_chain.launches == before + 1
    ref = cmb.front_chain_ref(*args, emit_mono=emit_mono)
    for g, r in zip(got if emit_mono else (got,), ref if emit_mono else (ref,)):
        assert (g - r).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_kweight_cells_kernel_matches_plain(cuda_device, fs, channels):
    """h = 6 at 44.1 kHz, 192 at 48 kHz; nb = 99 leaves a ragged group."""
    args = _kweight_operands(channels, 99, cuda_device, fs)
    before = cmb.kweight_cells.launches
    got = cmb.kweight_cells(*args)
    torch.cuda.synchronize()
    assert cmb.kweight_cells.launches == before + 1
    ref = cmb.kweight_cells_ref(*args)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_validate_operands(cuda_device):
    xrows, s_in, t, w, sat, width = _front_operands(2, 8, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cmb.front_chain(xrows.double(), s_in, t, w, sat, width)
    with pytest.raises(ValueError, match="contiguous"):
        cmb.front_chain(xrows.transpose(1, 2).contiguous().transpose(1, 2),
                        s_in, t, w, sat, width)
    with pytest.raises(ValueError, match="shape"):
        cmb.front_chain(xrows, s_in[:, :4], t, w, sat, width)


@pytest.mark.cuda
def test_master_on_the_card_matches_the_cpu_path(cuda_device):
    """The whole chain on the card runs through both kernels and agrees
    with the port's plain CPU path within the JAX chain budget 2e-4."""
    fs = 44100
    x = _signal(2 * fs, 2, fs, 3).T * 0.8
    params = MasteringParams.from_settings(SETTINGS)
    cfg = ChainConfig.gpu_default(fs)
    cmb.reset_launch_counts()
    got = MasteringChain(cfg).to(cuda_device)(x, params, return_result=True)
    torch.cuda.synchronize()
    assert cmb.launch_counts() == {"front_chain": 1, "kweight_cells": 1}
    ref = MasteringChain(cfg)(x, params, return_result=True)
    assert (got.audio.cpu() - ref.audio).abs().max().item() < 2e-4
    assert abs(float(got.measured_lufs) - float(ref.measured_lufs)) < 1e-3
