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
their plain versions.  K4 ``kweight_cells`` splits its product: ``x @ T``
in 3xTF32 and the states term ``s @ Wt`` in fp32 (the K-weighting's state
operator is ~70 times the signal, and its 3xTF32 rounding dominates the
all-3xTF32 product's error); :func:`kweight_product_emulated` is that
split, held within 5e-6 of the float64 product's max.  This file imports
no jax.
"""

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.ops import multiband as mb
from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

LIMIT = 1e-4
K4_LIMIT = 5e-6     # K4's split: fp32-level, ~1e-6 measured
TF32_MASK = np.uint32(0xFFFFE000)
TILE_COLS = 128     # csrc/tf32_product.cuh: columns of a one-filter tile


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


def kweight_product_emulated(x, s, t, wt):
    """K4's ``x @ T + s @ Wt`` as the kernel forms it: ``x @ T`` in
    3xTF32, then the states term in fp32 added to it (float32 rows)."""
    s = np.ascontiguousarray(s, np.float32)
    return (product_3xtf32(x, t)
            + s @ np.ascontiguousarray(wt, np.float32)).astype(np.float32)


def bucket_sums_emulated(y, h):
    """K4's epilogue on float32 rows ``y (n, L)``: squares summed over
    buckets of ``h`` columns (``(n, L/h)``).  Each 128-column tile sums
    its part of a bucket left to right; a bucket that crosses tile edges
    is then the sum of its tiles' pieces, left to right, as the last CTA
    of the row group adds them."""
    n, L = y.shape
    out = np.zeros((n, L // h), np.float32)
    pieces = {}            # (tile, bucket) -> the tile's piece of it
    for j0 in range(0, L, TILE_COLS):
        for q in range(j0 // h, (j0 + TILE_COLS - 1) // h + 1):
            s = np.zeros(n, np.float32)
            for i in range(max(q * h, j0), min((q + 1) * h, j0 + TILE_COLS)):
                s = s + y[:, i] * y[:, i]
            if q * h >= j0 and (q + 1) * h <= j0 + TILE_COLS:
                out[:, q] = s
            else:
                pieces[j0 // TILE_COLS, q] = s
    for q in {q for _, q in pieces}:
        s = np.zeros(n, np.float32)
        for tile in sorted(t for t, qq in pieces if qq == q):
            s = s + pieces[tile, q]
        out[:, q] = s
    return out


def kweight_cells_emulated(xrows, s_in, t, w, h):
    """K4 ``kweight_cells`` emulated: ``(C, nb·L/h)`` from rows ``(C, nb,
    L)``, states ``(C, nb, S)`` and the K-filter's ``T``, ``W``."""
    c, nb, L = xrows.shape
    y = kweight_product_emulated(np.asarray(xrows).reshape(c * nb, L),
                                 np.asarray(s_in).reshape(c * nb, -1),
                                 np.asarray(t), np.asarray(w).T)
    return bucket_sums_emulated(y, h).reshape(c, nb * (L // h))


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


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("block", [128, 384, 512])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_kweight_operands_hold_with_the_states_term_in_fp32(fs, block,
                                                            channels):
    """K4's product ``x @ T + s @ Wt`` (the K-weighting, S = 4): ``x @ T``
    in 3xTF32 with the states term in fp32, as the kernel splits it, holds
    the float64 product within 5e-6 of its max; the all-3xTF32 product,
    printed beside it, errs ~1.4e-5 at block 384 through ``s @ Wt``."""
    xrows = _rows(channels, 100, block, fs, seed=3)
    s_in, _, ops = iir.sosfilt_states_rows(loud.kweight_sos(fs), xrows)
    x = xrows.reshape(channels * 100, block).numpy()
    s = s_in.reshape(channels * 100, -1).numpy()
    t, wt = ops.t.numpy(), ops.w.T.contiguous().numpy()
    ref = x.astype(np.float64) @ t + s.astype(np.float64) @ wt
    scale = np.abs(ref).max()
    split = np.abs(kweight_product_emulated(x, s, t, wt) - ref).max() / scale
    whole = np.abs(product_3xtf32(np.concatenate([x, s], 1),
                                  np.concatenate([t, wt], 0))
                   - ref).max() / scale
    print(f"K4 {fs} Hz, block {block}, C={channels}: x @ T in 3xTF32 + "
          f"fp32 states term {split:.3e} of the max (all in 3xTF32 "
          f"{whole:.3e}; max |Wt| {np.abs(wt).max():.1f})")
    assert split <= K4_LIMIT, split


@pytest.mark.parametrize("h", [1, 2, 6, 64, 128, 192, 384])
def test_bucket_sums_emulated_join_across_tiles(h):
    """The emulated epilogue, with its pieces joined across 128-column tiles,
    equals plain float64 bucket sums of the squares (to fp32 roundoff)."""
    y = np.random.default_rng(h).standard_normal((5, 384)).astype(np.float32)
    ref = (y.astype(np.float64) ** 2).reshape(5, 384 // h, h).sum(axis=2)
    np.testing.assert_allclose(bucket_sums_emulated(y, h), ref, rtol=1e-5)
