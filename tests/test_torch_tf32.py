"""The tensor-core kernels' 3xTF32 product, emulated on the CPU.

``csrc/tf32_wgmma.cuh`` splits every fp32 operand ``v`` into ``big``, ``v``
rounded to TF32 (add half of TF32's last place to the bits, cut the low
13), and ``small``, the cut of ``v - big`` (``split_tf32``), and forms a
product as ``small·big + big·small + big·big`` with fp32 accumulation.
Here the split is numpy uint32 bit operations and the three products are
float32 matmuls (a product of two TF32 values is exact in fp32).  Every
kernel on that header forms ``x @ T`` in 3xTF32 and adds the states term
``s @ Wt`` in fp32 on its epilogue warps (the K-weighting's state
operator is ~70 times the signal, the crossovers' up to ~4e4, and their
3xTF32 rounding dominates the all-3xTF32 product's error): K1
``front_chain`` after its exciter, applied to the signal before the
split (:func:`front_chain_emulated`, its width and mono mean included),
K2 ``band_energies`` and K3 ``band_gain_apply``
(:func:`band_product_emulated`) and K4 ``kweight_cells``
(:func:`kweight_product_emulated`, with its bucket sums carried across
a span's 64-column tiles, :func:`bucket_sums_emulated`).  Each is held
against the float64 computation of the same operands within 1e-4 of its
largest value, the limit ``chip_smoke.py`` holds the kernels to against
their plain versions (K4 within 5e-6).  The all-3xTF32 products of the
``mma.sync`` kernels these replaced stay as the yardsticks they are held
against.  This file imports no jax.
"""

import math

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
TILE_COLS = 64      # csrc/kweight_cells.cu: K4's column tile


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
    buckets of ``h`` columns (``(n, L/h)``).  A CTA's item spans lcm(h,
    64) columns, whole buckets, in 64-column tiles taken left to right;
    each tile adds its columns of a bucket to it left to right (fmaf, the
    sum rounded once a column), starting from the sum carried from the
    tile before where the bucket began there, and a bucket that goes on
    into the next tile carries its sum there."""
    n, L = y.shape
    span = h * TILE_COLS // math.gcd(h, TILE_COLS)
    out = np.zeros((n, L // h), np.float32)
    for s0 in range(0, L, span):
        carry = None
        for j0 in range(s0, s0 + span, TILE_COLS):
            for q in range(j0 // h, (j0 + TILE_COLS - 1) // h + 1):
                s = carry if q * h < j0 else np.zeros(n, np.float32)
                for i in range(max(q * h, j0),
                               min((q + 1) * h, j0 + TILE_COLS)):
                    s = (s.astype(np.float64) + y[:, i].astype(np.float64)
                         * y[:, i]).astype(np.float32)
                if (q + 1) * h <= j0 + TILE_COLS:
                    out[:, q] = s
                else:
                    carry = s
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
    """K1's EQ product ``[saturate(x) | s] @ [T ; Wt]`` (block 384, S = 8)
    all in 3xTF32, as the ``mma.sync`` kernel formed it: the yardstick of
    :func:`test_front_chain_tile_emulated_holds_for_every_preset`."""
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


def band_product_emulated(x, s_lp, s_hp, t2, wt2):
    """K2's and K3's ``[low | high]`` as ``csrc/tf32_wgmma.cuh`` forms them:
    ``x @ T_f`` in 3xTF32, then the states term ``s_f @ Wt_f`` in fp32
    added to it (float32 rows)."""
    return np.concatenate([
        kweight_product_emulated(x, s, t2[f], wt2[f])
        for f, s in enumerate((s_lp, s_hp))], axis=1)


@pytest.mark.parametrize("block", [128, 256, 384, 512])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_crossover_operands_hold_with_the_states_term_in_fp32(fs, block):
    """K2's and K3's product as the wgmma kernels split it (``x @ T`` in
    3xTF32, the states term in fp32) holds the float64 product within
    1e-4 of its max, and errs no more than the all-3xTF32 product of the
    ``mma.sync`` kernels it replaced (printed beside it): the low-pass
    state operator reaches ~4e4, and its 3xTF32 rounding dominated."""
    sos = mb._crossover_sos(fs, 250.0, 4000.0)
    xrows = _rows(2, 40, block, fs, seed=2)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(sos, xrows)
    t2, wt2 = (v.numpy() for v in cmb.crossover_operands(*sos, block, "cpu"))
    x = xrows.reshape(80, -1).numpy()
    s_lp, s_hp = (v.reshape(80, -1).numpy() for v in (s_lp, s_hp))
    ref = np.concatenate([x.astype(np.float64) @ t2[f]
                          + s.astype(np.float64) @ wt2[f]
                          for f, s in enumerate((s_lp, s_hp))], axis=1)
    scale = np.abs(ref).max()
    split = np.abs(band_product_emulated(x, s_lp, s_hp, t2, wt2)
                   - ref).max() / scale
    zeros = np.zeros_like(wt2[0])
    whole = np.abs(product_3xtf32(
        np.concatenate([x, s_lp, s_hp], 1),
        np.block([[t2[0], t2[1]], [wt2[0], zeros], [zeros, wt2[1]]]))
        - ref).max() / scale
    print(f"K2/K3 {fs} Hz, block {block}: x @ T in 3xTF32 + fp32 states "
          f"term {split:.3e} of the max (all in 3xTF32 {whole:.3e}; max "
          f"|Wt| {np.abs(wt2).max():.3g})")
    assert split <= LIMIT, split
    assert split <= whole, (split, whole)


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
    """The emulated epilogue, its sums carried across a span's 64-column
    tiles (h = 6 and 192 span three, 128 two, 384 six), equals plain
    float64 bucket sums of the squares (to fp32 roundoff)."""
    y = np.random.default_rng(h).standard_normal((5, 384)).astype(np.float32)
    ref = (y.astype(np.float64) ** 2).reshape(5, 384 // h, h).sum(axis=2)
    np.testing.assert_allclose(bucket_sums_emulated(y, h), ref, rtol=1e-5)


def exciter_np(x, coefs):
    """``dry·x + wet·tanh(x·drive)`` in float32, each operation rounded
    (the kernel's ``__fmul_rn`` / ``__fadd_rn``; numpy's float32 tanh for
    ``tanhf``)."""
    dry, wet, drive = (np.float32(c) for c in coefs)
    x = np.asarray(x, np.float32)
    return dry * x + wet * np.tanh(x * drive)


def front_chain_emulated(xrows, s_in, t, w, coefs, width, channels):
    """K1 as ``csrc/front_chain.cu`` forms it, in float32: the exciter on
    the signal, then ``x @ T`` in 3xTF32, the states term in fp32 added
    to it, then the width (stereo) and the mono mean; returns ``(y, mono)``
    of shapes ``(C·nb, L)`` and ``(nb, L)``."""
    xs = exciter_np(xrows, coefs)
    u = kweight_product_emulated(xs, s_in, t, np.ascontiguousarray(w.T))
    u = u.reshape(channels, -1, u.shape[1])
    if channels == 2:
        half = np.float32(0.5)
        mid = (u[0] + u[1]) * half
        side = (u[0] - u[1]) * (half * np.float32(width))
        y = np.stack([mid + side, mid - side])
        return y.reshape(-1, y.shape[2]), (y[0] + y[1]) * half
    return u.reshape(-1, u.shape[2]), u.sum(axis=0) * np.float32(
        1.0 / channels)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("preset", sorted(EQ_PRESETS))
def test_front_chain_tile_emulated_holds_for_every_preset(preset, fs,
                                                          channels):
    """K1's tile arithmetic on ``wgmma`` (the exciter in float32 on the
    signal, then its split: ``x @ T`` in 3xTF32, the EQ's states term
    (S = 8) in fp32 on the epilogue warps, the width and the mono mean),
    emulated, holds the float64 chain of the same operands (the exciter
    in float64 on the same float32 signal and coefficients) within 1e-4
    of the max of y and of mono; the all-3xTF32 product of the
    ``mma.sync`` kernel it replaced is printed beside it."""
    from python_audio_mastering_tpu_torch.ops.waveshaper import exciter_coefs

    params = MasteringParams.from_settings(
        {"saturation": 25, "preset": preset, "width": 1.4})
    chain = MasteringChain(ChainConfig.gpu_default(fs))
    ops = chain.eq_ops(params)
    xrows = _rows(channels, 40, 384, fs, seed=4)
    coefs = exciter_coefs(params.saturation, dtype=torch.float32)
    s_in, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=ops)
    x = xrows.reshape(channels * 40, -1).numpy()
    s = s_in.reshape(channels * 40, -1).numpy()
    t, w = ops.t.numpy(), ops.w.numpy()
    assert s.shape[1] == 8
    y, mono = front_chain_emulated(x, s, t, w, coefs, params.width, channels)
    dry, wet, drive = (float(np.float32(c)) for c in coefs)
    x64 = x.astype(np.float64)
    u_flat = ((dry * x64 + wet * np.tanh(x64 * drive)) @ t.astype(np.float64)
              + s.astype(np.float64) @ w.T.astype(np.float64))
    u = u_flat.reshape(channels, 40, -1)
    if channels == 2:
        wd = float(np.float32(params.width))
        mid, side = (u[0] + u[1]) / 2, (u[0] - u[1]) / 2 * wd
        ref = np.stack([mid + side, mid - side])
    else:
        ref = u
    ref_mono = ref.mean(axis=0)
    ref = ref.reshape(channels * 40, -1)
    whole = product_3xtf32(
        np.concatenate([exciter_np(x, coefs), s], 1),
        np.concatenate([t, np.ascontiguousarray(w.T)], 0))
    whole_err = np.abs(whole - u_flat).max() / np.abs(u_flat).max()
    errs = [np.abs(got - want).max() / np.abs(want).max()
            for got, want in ((y, ref), (mono, ref_mono))]
    print(f"K1 {preset} {fs} Hz C={channels}: y {errs[0]:.3e}, mono "
          f"{errs[1]:.3e} of the max (all-3xTF32 product "
          f"{whole_err:.3e})")
    assert max(errs) <= LIMIT, errs
