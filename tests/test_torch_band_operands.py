"""The tensor-core kernels' packed operators (``csrc/tf32_wgmma.cuh``).

``ops.cuda_multiband.crossover_packed`` splits ``T_lp`` and ``T_hp`` once
into TF32 big and small parts and lays them out as the band kernels' B
descriptor reads them: for each column tile ``jt`` (64 columns of each
band) the k-tiles ``kt < 2·jt + 2`` of the causal T, each a big and a
small ``(128, 32)`` part of ``Tᵀ`` with its 16-byte chunks swizzled
(chunk ``c`` of row ``n`` at ``c ^ (n % 8)``).  ``packed_operator`` does
the same for one filter: K1's EQ in 128-column tiles, K4's K-weighting in
64-column tiles (the k-tiles ``kt < (jt + 1)·cols / 32``), cached with the
operator.  Here the layouts are undone with plain indexing, independently
of the packing code, and held bit for bit to numpy's split of ``T``.  This
file imports no jax.
"""

import gc


import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import multiband as mb

TF32_MASK = np.uint32(0xFFFFE000)


def np_split_tf32(v):
    """``(big, small)`` as uint32 bits, the kernels' split in numpy."""
    v = np.ascontiguousarray(v, np.float32)
    big = (v.view(np.uint32) + np.uint32(0x1000)) & TF32_MASK
    small = (v - big.view(np.float32)).view(np.uint32) & TF32_MASK
    return big, small


def unpack(packed, L):
    """``(big, small)`` of shape ``(2, L, L)`` (filter, k, j) from the
    packed operator, zero where no k-tile was packed (``k >= 64·jt + 64``
    for the columns of tile ``jt``)."""
    words = packed.contiguous().view(torch.int32).numpy().view(np.uint32)
    nt = L // 64
    out = np.zeros((2, 2, L, L), np.uint32)          # part, f, k, j
    at = 0
    for jt in range(nt):
        for kt in range(2 * jt + 2):
            for part in range(2):
                tile = words[at:at + 128 * 32].reshape(128, 32)
                at += 128 * 32
                for n in range(128):
                    row = tile[n].reshape(8, 4)
                    chunks = row[[c ^ (n % 8) for c in range(8)]]
                    out[part, n // 64, 32 * kt:32 * kt + 32,
                        64 * jt + n % 64] = chunks.reshape(32)
    assert at == words.size, (at, words.size)
    return out[0], out[1]


@pytest.mark.parametrize("block", [128, 384, 512])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_packed_operator_is_the_split_of_T(fs, block):
    """The packed operator unpacks to exactly the ``split_tf32`` big and
    small parts of ``T_lp``, ``T_hp`` in every packed k-tile, and the
    k-tiles it leaves out are zero in ``T`` (causal)."""
    sos = mb._crossover_sos(fs, 250.0, 4000.0)
    t2, _ = cmb.crossover_operands(*sos, block, "cpu")
    packed = cmb.crossover_packed(*sos, block, "cpu")
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() == (block // 64) * (block // 64 + 1) * 2 * 128 * 32
    big, small = unpack(packed, block)
    want_big, want_small = np_split_tf32(t2.numpy())
    k = np.arange(block)[:, None]
    j = np.arange(block)[None, :]
    packed_at = k < (j // 64) * 64 + 64                 # the k-tiles kept
    assert np.array_equal(big[:, packed_at], want_big[:, packed_at])
    assert np.array_equal(small[:, packed_at], want_small[:, packed_at])
    assert not np.any(t2.numpy()[:, ~packed_at])        # T is causal there
    # big + small is T within 2^-22 of |T|; where T - big is subnormal
    # (|T| < ~2^-115, T's far tail) the cut of small's low 13 bits loses
    # up to 2^13 subnormal steps, 2^-136
    t = t2.numpy().astype(np.float64)
    rest = t - big.view(np.float32) - small.view(np.float32).astype(
        np.float64)
    assert np.all(np.abs(rest[:, packed_at])
                  <= 2.0 ** -22 * np.abs(t[:, packed_at]) + 2.0 ** -136)
    normal = packed_at & (np.abs(t) >= 2.0 ** -100)
    assert np.all(np.abs(rest[normal]) <= 2.0 ** -22 * np.abs(t[normal]))


def test_split_tf32_in_torch_is_numpy_s():
    """The torch split the packing uses equals the kernels' bit recipe on
    values across many binades, signs and zeros."""
    r = np.random.default_rng(0)
    v = (r.standard_normal(50_000) * 10.0 ** r.uniform(-8, 5, 50_000)
         ).astype(np.float32)
    v[:100] = 0.0
    v[100:200] = -v[100:200]
    big, small = cmb.split_tf32(torch.from_numpy(v))
    want_big, want_small = np_split_tf32(v)
    assert np.array_equal(big.numpy().view(np.uint32), want_big)
    assert np.array_equal(small.numpy().view(np.uint32), want_small)


def test_packed_operator_is_cached_per_pair_and_block():
    sos = mb._crossover_sos(44100, 250.0, 4000.0)
    a = cmb.crossover_packed(*sos, 256, "cpu")
    assert cmb.crossover_packed(*sos, 256, "cpu") is a
    assert cmb.crossover_packed(*sos, 384, "cpu") is not a


def unpack_one(packed, L, cols):
    """``(big, small)`` of shape ``(L, L)`` (k, j) from a one-filter
    packed operator of ``cols``-column tiles, zero where no k-tile was
    packed (``k >= cols·jt + cols`` for the columns of tile ``jt``)."""
    words = packed.contiguous().view(torch.int32).numpy().view(np.uint32)
    nt, q = L // cols, cols // 32
    n = np.arange(cols)[:, None]
    stored = np.arange(8)[None, :] ^ (n % 8)     # where chunk c of row n is
    out = np.zeros((2, L, L), np.uint32)         # part, k, j
    at = 0
    for jt in range(nt):
        for kt in range(q * (jt + 1)):
            for part in range(2):
                tile = words[at:at + cols * 32].reshape(cols, 8, 4)
                at += cols * 32
                out[part, 32 * kt:32 * kt + 32, cols * jt:cols * jt + cols] \
                    = tile[n, stored].reshape(cols, 32).T
    assert at == words.size, (at, words.size)
    return out[0], out[1]


def _one_filter_operator(what, fs, block):
    """``T`` as the main path hands it to K1 (an EQ preset's, from the
    chain's operator cache) or K4 (the chain's K-weighting buffer)."""
    import dataclasses

    cfg = dataclasses.replace(ChainConfig.gpu_default(fs), block_size=block)
    chain = MasteringChain(cfg)
    if what == "kweighting":
        return chain.kweight_ops().t
    params = MasteringParams.from_settings(
        {"saturation": 25, "preset": what, "width": 1.4})
    return chain.eq_ops(params).t


@pytest.mark.parametrize("block", [128, 256, 384, 512])
@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("what", sorted(EQ_PRESETS) + ["kweighting"])
def test_one_filter_packed_operator_is_the_split_of_T(what, fs, block):
    """K1's (128-column tiles) and K4's (64-column) packed operators of
    every EQ preset and of the K-weighting unpack to exactly the
    ``split_tf32`` big and small parts of ``T`` in every packed k-tile,
    hold the k-tiles below each tile's last column and no others, and the
    k-tiles they leave out are zero in ``T`` (causal)."""
    t = _one_filter_operator(what, fs, block)
    want_big, want_small = np_split_tf32(t.numpy())
    k = np.arange(block)[:, None]
    j = np.arange(block)[None, :]
    for cols in (cmb._FRONT_COLS, cmb._CELLS_COLS):
        packed = cmb.packed_operator(t, cols)
        assert packed.dtype == torch.float32 and packed.is_contiguous()
        nt = block // cols
        assert packed.numel() == (cols // 32) * nt * (nt + 1) // 2 * 2 * (
            cols * 32)
        big, small = unpack_one(packed, block, cols)
        packed_at = k < (j // cols) * cols + cols
        assert np.array_equal(big[packed_at], want_big[packed_at])
        assert np.array_equal(small[packed_at], want_small[packed_at])
        assert not np.any(big[~packed_at]) and not np.any(small[~packed_at])
        assert not np.any(t.numpy()[~packed_at])


def test_packed_operator_is_cached_with_the_operator():
    """K1's packed EQ operator is packed once for the chain's cached EQ
    operators and K4's once for its K-weighting buffer; a copy of T, a
    write into T and another tile width are packed anew, and an entry goes
    with its T."""
    chain = MasteringChain(ChainConfig.gpu_default(44100))
    params = MasteringParams.from_settings({"preset": "rock"})
    t = chain.eq_ops(params).t
    a = cmb.packed_operator(t, cmb._FRONT_COLS)
    assert cmb.packed_operator(chain.eq_ops(params).t, cmb._FRONT_COLS) is a
    assert cmb.packed_operator(t, cmb._CELLS_COLS) is not a
    kw = cmb.packed_operator(chain.kweight_ops().t, cmb._CELLS_COLS)
    assert cmb.packed_operator(chain.kweight_ops().t, cmb._CELLS_COLS) is kw
    t2 = t.clone()
    b = cmb.packed_operator(t2, cmb._FRONT_COLS)
    assert b is not a and torch.equal(a, b)
    t2.mul_(2.0)
    c = cmb.packed_operator(t2, cmb._FRONT_COLS)
    assert c is not b
    assert torch.equal(c, cmb.pack_operator(t2[None], cmb._FRONT_COLS))
    n = len(cmb._PACKED)
    del t2, b, c
    gc.collect()
    assert len(cmb._PACKED) == n - 1


def test_packed_operator_under_autograd_is_packed_each_call():
    """A T that requires grad (the automaster's EQ, built in the graph each
    step) is packed on every call, outside the graph, and not cached."""
    chain = MasteringChain(ChainConfig.gpu_default(48000))
    t = chain.eq_ops(MasteringParams.from_settings({"preset": "pop"})).t
    tg = t.clone().requires_grad_(True)
    a = cmb.packed_operator(tg, cmb._FRONT_COLS)
    b = cmb.packed_operator(tg, cmb._FRONT_COLS)
    assert a is not b and torch.equal(a, b) and not a.requires_grad
    assert tg not in cmb._PACKED
    assert torch.equal(a, cmb.packed_operator(t, cmb._FRONT_COLS))
