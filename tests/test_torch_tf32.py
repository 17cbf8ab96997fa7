"""The tensor-core kernels' 3xTF32 product, emulated on the CPU.

``csrc/tf32_product.cuh`` splits every fp32 operand ``v`` into ``big``, ``v``
rounded to TF32 (add half of TF32's last place to the bits, cut the low
13), and ``small``, the cut of ``v - big`` (``split_tf32``), and forms a
product as ``small·big + big·small + big·big`` with fp32 accumulation.
Here the split is numpy uint32 bit operations and the three products are
float32 matmuls (a product of two TF32 values is exact in fp32), on the
operands the kernels get: K1 ``front_chain``'s ``[saturate(x) | s] @ [T ;
Wt]`` for every EQ preset, and the crossover product of K2
``band_energies`` and K3 ``band_gain_apply`` at 44.1 and 48 kHz.  Each is
held against the float64 product of the same operands within 1e-4 of its
largest value, the limit ``chip_smoke.py`` holds the kernels to against
their plain versions.  This file imports no jax.
"""

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import multiband as mb
from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

LIMIT = 1e-4
TF32_MASK = np.uint32(0xFFFFE000)


def split_tf32(v):
    """``(big, small)`` of float32 ``v``, bit for bit as the kernels."""
    v = np.ascontiguousarray(v, np.float32)
    big = ((v.view(np.uint32) + np.uint32(0x1000)) & TF32_MASK).view(
        np.float32)
    small = ((v - big).view(np.uint32) & TF32_MASK).view(np.float32)
    return big, small


def product_3xtf32(a, b):
    """``a @ b`` as the kernels form it: three TF32 products, fp32 sums."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _rows(channels, nb, block, fs, seed):
    r = np.random.default_rng(seed)
    t = np.arange(nb * block) / fs
    x = (0.4 * np.sin(2 * np.pi * 55 * t) + 0.2 * np.sin(2 * np.pi * 3000 * t)
         + 0.1 * r.standard_normal((channels, nb * block)))
    return torch.as_tensor(x, dtype=torch.float32).reshape(channels, nb, block)


def _check(what, a, b):
    """3xTF32 ``a @ b`` against float64 within LIMIT of its max."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = product_3xtf32(a, b)
    ratio = np.abs(got - ref).max() / np.abs(ref).max()
    tf32 = split_tf32(a)[0] @ split_tf32(b)[0]
    print(f"{what}: 3xTF32 max |err| / max |product| {ratio:.3e} "
          f"(TF32 alone {np.abs(tf32 - ref).max() / np.abs(ref).max():.3e})")
    assert ratio <= LIMIT, (what, ratio)


def test_split_tf32_keeps_22_bits():
    """``big`` and ``small`` carry 11 bits each: ``v - big - small`` is
    within 2^-22 of ``|v|``, and both have their low 13 bits clear."""
    r = np.random.default_rng(0)
    v = (r.standard_normal(100_000) * 10.0 ** r.uniform(-6, 3, 100_000)
         ).astype(np.float32)
    big, small = split_tf32(v)
    for part in (big, small):
        assert not np.any(part.view(np.uint32) & ~TF32_MASK)
    rest = v.astype(np.float64) - big.astype(np.float64) - small
    assert np.all(np.abs(rest) <= 2.0 ** -22 * np.abs(v))


@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("preset", sorted(EQ_PRESETS))
def test_front_chain_operands_hold_in_3xtf32(preset, fs):
    """K1's EQ product ``[saturate(x) | s] @ [T ; Wt]`` (block 384, S = 8),
    the operands new to 3xTF32 in the port."""
    params = MasteringParams.from_settings(
        {"saturation": 25, "preset": preset, "width": 1.4})
    chain = MasteringChain(ChainConfig.gpu_default(fs))
    ops = chain.eq_ops(params)
    xs = saturate(_rows(2, 40, 384, fs, seed=1), params.saturation)
    s_in, _, _ = iir.sosfilt_states_rows(None, xs, ops=ops)
    a = torch.cat([xs.reshape(80, -1), s_in.reshape(80, -1)], dim=1)
    b = torch.cat([ops.t, ops.w.T], dim=0)
    _check(f"K1 {preset} {fs} Hz", a.numpy(), b.numpy())


@pytest.mark.parametrize("block", [128, 384, 512])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_crossover_operands_hold_in_3xtf32(fs, block):
    """K2's and K3's product ``[x | s_lp | s_hp] @ [[T_lp, T_hp], [W_lp,
    0], [0, W_hp]]``, the LR4 crossovers at 250 Hz and 4 kHz (S = 4)."""
    sos = mb._crossover_sos(fs, 250.0, 4000.0)
    xrows = _rows(2, 40, block, fs, seed=2)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(sos, xrows)
    t2, wt2 = cmb.crossover_operands(*sos, block, "cpu")
    zeros = torch.zeros_like(wt2[0])
    a = torch.cat([xrows.reshape(80, -1), s_lp.reshape(80, -1),
                   s_hp.reshape(80, -1)], dim=1)
    b = torch.cat([torch.cat([t2[0], t2[1]], dim=1),
                   torch.cat([wt2[0], zeros], dim=1),
                   torch.cat([zeros, wt2[1]], dim=1)], dim=0)
    _check(f"K2/K3 crossover {fs} Hz, block {block}", a.numpy(), b.numpy())
