"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the test conftest (which imports jax),
so the card's machine, which has no jax, runs it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` need an NVIDIA GPU and skip without one; the
others check the wrappers' device dispatch on the CPU.  K1 and K4 under
autograd (the kernel forward, the VJP written out in plain torch) against
autograd through their plain twins: within 1e-5 of each gradient's max.  Kernel vs plain
on the card: fp32 sums in another order, max abs ≤ 1e-4 (K2, K4:
relative to the largest value; K1-K4 run their products in 3xTF32 on
``wgmma``, close to fp32, and their states term in fp32); the ballistics
kernels K5-K7 run the plain version's float operations in its order, so
they agree bitwise.  K10 against its plain twin: float32 with the twin's
float64 sums, gain within 2e-6 relative, output max abs within 1e-6.
The multiband chain on the card vs the CPU path: max abs < 5e-3, rms <
5e-5, |ΔLUFS| < 1e-3 (the JAX package's on-chip kernels-vs-XLA residual,
1.2e-3 max / 1.3e-5 rms, comes from detector threshold flips,
DESIGN.md:124-129).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.ops import ballistics as bal
from python_audio_mastering_tpu_torch.ops.biquad import butter_sos
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.ops import multiband as mb
from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

from . import torch_k5_cases

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


def _front_operands(channels, nb, device, fs=44100, block=L):
    params = MasteringParams.from_settings(SETTINGS)
    cfg = dataclasses.replace(ChainConfig.gpu_default(fs), block_size=block)
    chain = MasteringChain(cfg).to(device)
    xrows = torch.as_tensor(_signal(nb * block, channels, fs, channels),
                            device=device).reshape(channels, nb, block)
    ops = chain.eq_ops(params)
    s_in, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=ops)
    return (xrows, s_in, ops.t, ops.w, params.saturation, params.width)


def _kweight_operands(channels, nb, device, fs, block=L):
    xrows = torch.as_tensor(_signal(nb * block, channels, fs, 7 + channels),
                            device=device).reshape(channels, nb, block)
    s_in, _, ops = iir.sosfilt_states_rows(loud.kweight_sos(fs), xrows)
    return (xrows, s_in, ops.t, ops.w,
            math.gcd(loud._gating_geometry(fs)[0], block))


def _band_operands(channels, nb, device, hop=8, fs=44100, block=L):
    """(xrows, s_lp, s_hp, sos_lp, sos_hp) and control-rate gain columns."""
    xrows = torch.as_tensor(_signal(nb * block, channels, fs, 20 + channels),
                            device=device).reshape(channels, nb, block)
    sos = mb._crossover_sos(fs, 250.0, 4000.0)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(sos, xrows)
    r = np.random.default_rng(channels)
    g = torch.as_tensor(0.5 + 0.5 * r.random((3, nb * block // hop)),
                        dtype=torch.float32, device=device)
    cols = torch.stack([g[1], g[0] - g[1], g[2] - g[1]]).contiguous()
    return (xrows, s_lp, s_hp, *sos), cols


def _ballistics_operands(t, device, seed=0):
    """A bursty target timeline (B = 3) with the bench's hop-8 rates, a
    frozen stretch and a nonzero incoming state, ``T`` a block multiple."""
    r = np.random.default_rng(seed)
    m = (r.random((3, t)) * 12 * (r.random(t) < 0.5)).astype(np.float32)
    m[:, t // 3: t // 2] = 0.0
    ca = [8 / max(a * 44.1, 1.0) for a, _ in mb.BAND_BALLISTICS_MS]
    cr = [8 / max(rel * 44.1, 1.0) for _, rel in mb.BAND_BALLISTICS_MS]

    def dev(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return dev(m), dev(ca), dev(cr), dev([2.0, 0.0, 5.0])


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
    bargs, cols = _band_operands(2, 9, "cpu")
    assert torch.equal(cmb.band_energies(*bargs, hop=8),
                       cmb.band_energies_ref(*bargs, hop=8))
    got = cmb.band_gain_apply(*bargs[:3], cols, *bargs[3:], hop=8,
                              emit_mono=emit_mono)
    ref = cmb.band_gain_apply_ref(*bargs[:3], cols, *bargs[3:], hop=8,
                                  emit_mono=emit_mono)
    for g, r in zip(got if emit_mono else (got,), ref if emit_mono else (ref,)):
        assert torch.equal(g, r)
    m, ca, cr, att0 = _ballistics_operands(4 * 128, "cpu")
    inc = torch.rand((3, 4))
    assert torch.equal(bal.replay(m, ca, cr, inc),
                       bal.replay_ref(m, ca, cr, inc))
    assert torch.equal(bal.pass1_bnd(m, ca, cr, att0),
                       bal.pass1_bnd_ref(m, ca, cr, att0))
    idx = bal._frozen_index(m)
    c1, c2 = bal.new_ctrl("cpu"), bal.new_ctrl("cpu")
    assert torch.equal(bal.replay_bnd(m, ca, cr, att0, idx, inc, c1),
                       bal.replay_bnd_ref(m, ca, cr, att0, idx, inc, c2))
    assert torch.equal(c1, c2)
    lo, hi, stops = bal.pass1_hull(m, ca, cr, att0 + 12.0)
    assert all(torch.equal(a, b) for a, b in zip(
        (lo, hi, stops), bal.pass1_hull_ref(m, ca, cr, att0 + 12.0)))
    assert torch.equal(bal.pass1_runs(m, ca, cr, att0, lo, hi, stops),
                       bal.pass1_runs_ref(m, ca, cr, att0, lo, hi, stops))
    assert cmb.launch_counts() == {
        "front_chain": 0, "kweight_cells": 0, "band_energies": 0,
        "band_gain_apply": 0, "pass1_hull": 0, "pass1_runs": 0, "replay": 0,
        "replay_bnd": 0, "sos_scan": 0, "gain_limit": 0,
        "lookahead_limit": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither CPU nor CUDA: no kernel, no silent fallback."""
    def meta(args):
        return [a.to("meta") if torch.is_tensor(a) else a for a in args]

    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.front_chain(*meta(_front_operands(1, 4, "cpu")))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.kweight_cells(*meta(_kweight_operands(1, 4, "cpu", 44100)))
    bargs, cols = _band_operands(1, 4, "cpu")
    bargs = meta(bargs)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.band_energies(*bargs, hop=8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cmb.band_gain_apply(*bargs[:3], cols.to("meta"), *bargs[3:], hop=8)
    m, ca, cr, att0 = meta(_ballistics_operands(2 * 128, "cpu"))
    inc = torch.zeros((3, 2), device="meta")
    idx = torch.zeros((3, 2), dtype=torch.int64, device="meta")
    stops = torch.zeros((3, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.pass1_bnd(m, ca, cr, att0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.pass1_runs(m, ca, cr, att0, inc, inc, stops)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.replay(m, ca, cr, inc)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.replay_bnd(m, ca, cr, att0, idx, inc,
                       torch.zeros(6, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("emit_mono", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("block", [128, 256, 384, 512])
def test_front_chain_kernel_matches_plain(cuda_device, block, channels,
                                          emit_mono):
    """K1's 128-column tiles, its causal k-tile skips and the exciter at
    every block size the kernels take; nb = 45 leaves a ragged last row
    tile for every channel count."""
    args = _front_operands(channels, 45, cuda_device, block=block)
    before = cmb.front_chain.launches
    got = cmb.front_chain(*args, emit_mono=emit_mono)
    torch.cuda.synchronize()
    assert cmb.front_chain.launches == before + 1
    ref = cmb.front_chain_ref(*args, emit_mono=emit_mono)
    for g, r in zip(got if emit_mono else (got,), ref if emit_mono else (ref,)):
        assert (g - r).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("block", [128, 256, 384, 512])
def test_kweight_cells_kernel_matches_plain(cuda_device, block, fs,
                                            channels):
    """K4 (x @ T in 3xTF32 on wgmma, the states term in fp32) at every
    block size: h = 6 at 44.1 kHz and 192 at 48 kHz with block 384
    (buckets that cross the 64-column tiles, carried across a span's tiles
    in shared memory), 2 and 64 at the other sizes; nb = 99 leaves a
    ragged last row tile, and 3 channels a tile of 126 rows.  Limit: the
    chip smoke's, 1e-4 of the max.  A second launch gives the same bits:
    each bucket is summed in one fixed order, with no atomics."""
    args = _kweight_operands(channels, 99, cuda_device, fs, block)
    before = cmb.kweight_cells.launches
    got = cmb.kweight_cells(*args)
    torch.cuda.synchronize()
    assert cmb.kweight_cells.launches == before + 1
    ref = cmb.kweight_cells_ref(*args)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    assert torch.equal(cmb.kweight_cells(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize(("channels", "nb"), [(1, 2940), (2, 2940),
                                              (1, 257), (2, 129), (3, 43)])
@pytest.mark.parametrize("fs", [44100, 48000])
def test_one_filter_kernels_on_the_persistent_grid(cuda_device, fs,
                                                   channels, nb):
    """K1 and K4 at the streamed runner's chunk (2940 blocks: 23 mono row
    tiles, the last of 124 blocks) and at row counts that are not a
    multiple of a tile's (257 mono blocks of 128 a tile, 129 stereo of 64,
    43 of 42 at three channels), against their plain twins at their
    limits (K1 1e-4 abs with and without mono, K4 1e-4 of the max and the
    same bits twice)."""
    args = _front_operands(channels, nb, cuda_device, fs=fs)
    for emit in (False, True):
        got = cmb.front_chain(*args, emit_mono=emit)
        ref = cmb.front_chain_ref(*args, emit_mono=emit)
        for g, r in zip(got if emit else (got,), ref if emit else (ref,)):
            assert (g - r).abs().max().item() <= 1e-4
    kargs = _kweight_operands(channels, nb, cuda_device, fs)
    got = cmb.kweight_cells(*kargs)
    ref = cmb.kweight_cells_ref(*kargs)
    torch.cuda.synchronize()
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    assert torch.equal(cmb.kweight_cells(*kargs), got)


def _grads(fn, args, ups):
    """Gradients of ``fn(*args)`` (every tensor argument a fresh leaf) for
    the upstream gradients ``ups``; an argument the result does not use
    (the width of a mono signal) gets zeros."""
    leaves = [a.detach().clone().requires_grad_(True)
              if torch.is_tensor(a) else a for a in args]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, [a for a in leaves if torch.is_tensor(a)],
                               ups, allow_unused=True, materialize_grads=True)


def _assert_grads_close(got, want, limit=1e-5):
    """Each gradient within ``limit`` of its own max (zero where the
    reference is zero)."""
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= limit * scale if scale else err == 0.0, (err, scale)


def _k1_grad_operands(channels, nb, device, block=L):
    """K1's operands with the exciter coefficients and width as tensors."""
    from python_audio_mastering_tpu_torch.ops.waveshaper import exciter_coefs

    x, s_in, t, w, sat, width = _front_operands(channels, nb, device,
                                                block=block)
    return (x, s_in, t, w, *(torch.tensor(c, device=device)
                             for c in exciter_coefs(sat)),
            torch.tensor(width, device=device))


def _k1(kernel):
    def fn(x, s, t, w, dry, wet, drive, width, emit_mono=False):
        return kernel(x, s, t, w, (dry, wet, drive), width,
                      emit_mono=emit_mono)
    return fn


@pytest.mark.parametrize("emit_mono", [False, True])
def test_autograd_wrappers_take_the_plain_version_on_cpu(emit_mono):
    """Under autograd a CPU tensor goes through the same
    ``autograd.Function`` the card runs, its forward the plain version:
    the outputs are the plain twin's bits, the gradients autograd's through
    the plain twin (within 1e-5 of each gradient's max, fp32 sums in
    another order), no launch is counted and the backward calls no plain
    twin."""
    g = torch.Generator().manual_seed(3)
    args = _k1_grad_operands(2, 9, "cpu")
    ups = [torch.randn(2, 9, L, generator=g)] + (
        [torch.randn(9, L, generator=g)] if emit_mono else [])
    cmb.reset_launch_counts()
    got = _grads(lambda *a: _k1(cmb.front_chain)(*a, emit_mono=emit_mono),
                 args, ups)
    assert cmb.plain_calls()["front_chain_ref"] == 1
    want = _grads(lambda *a: _k1(cmb.front_chain_ref)(*a,
                                                      emit_mono=emit_mono),
                  args, ups)
    _assert_grads_close(got, want)
    kargs = _kweight_operands(1, 20, "cpu", 44100)
    up = [torch.randn(1, 20 * L // kargs[4], generator=g)]
    cmb.reset_launch_counts()
    got = _grads(lambda *a: cmb.kweight_cells(*a, kargs[4]), kargs[:4], up)
    assert cmb.plain_calls()["kweight_cells_ref"] == 1
    want = _grads(lambda *a: cmb.kweight_cells_ref(*a, kargs[4]), kargs[:4],
                  up)
    _assert_grads_close(got, want)
    assert not any(cmb.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("emit_mono", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("block", [128, 384, 512])
def test_front_chain_vjp_matches_plain_autograd(cuda_device, block, channels,
                                                emit_mono):
    """K1 under autograd (the kernel forward, the written-out VJP) against
    autograd through the plain twin, every input and slider: within 1e-5
    of each gradient's max.  The backward launches nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(block + channels)
    args = _k1_grad_operands(channels, 45, cuda_device, block=block)
    ups = [torch.randn(channels, 45, block, generator=g, device=cuda_device)]
    if emit_mono:
        ups.append(torch.randn(45, block, generator=g, device=cuda_device))
    cmb.reset_launch_counts()
    got = _grads(lambda *a: _k1(cmb.front_chain)(*a, emit_mono=emit_mono),
                 args, ups)
    torch.cuda.synchronize()
    assert cmb.front_chain.launches == 1
    assert cmb.plain_calls()["front_chain_ref"] == 0
    want = _grads(lambda *a: _k1(cmb.front_chain_ref)(*a,
                                                      emit_mono=emit_mono),
                  args, ups)
    _assert_grads_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("block", [128, 384, 512])
def test_kweight_cells_vjp_matches_plain_autograd(cuda_device, block, fs):
    """K4 under autograd against autograd through its plain twin (signal,
    states and both operators): within 1e-5 of each gradient's max."""
    args = _kweight_operands(1, 99, cuda_device, fs, block)
    h = args[4]
    g = torch.Generator(device=cuda_device).manual_seed(block)
    up = [torch.randn(1, 99 * block // h, generator=g, device=cuda_device)]
    cmb.reset_launch_counts()
    got = _grads(lambda *a: cmb.kweight_cells(*a, h), args[:4], up)
    torch.cuda.synchronize()
    assert cmb.kweight_cells.launches == 1
    assert cmb.plain_calls()["kweight_cells_ref"] == 0
    want = _grads(lambda *a: cmb.kweight_cells_ref(*a, h), args[:4], up)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("case", ["states_f1", "states_f2", "rows", "T"])
def test_tensor_core_wrappers_refuse_what_the_kernels_cannot_take(case):
    """The checks the tensor-core kernels' wrappers run before a launch:
    at most 16 state columns (16 states of one filter, 8 of each of two),
    and rows and T on 16-byte boundaries (checked on CPU tensors here)."""
    xrows = torch.zeros((2, 4, 128))
    t = torch.zeros((128, 128))
    args = {"states_f1": (xrows, t, 17, 1, "at most 16 states"),
            "states_f2": (xrows, t, 9, 2, "at most 8 states"),
            "rows": (torch.zeros(2 * 4 * 128 + 2)[2:].view(2, 4, 128), t, 8,
                     1, "the rows must start on a 16-byte"),
            "T": (xrows, torch.zeros(128 * 128 + 1)[1:].view(128, 128), 4,
                  2, "the T must start on a 16-byte")}
    x, tt, s, filters, match = args[case]
    cmb._check_tf32_operands("k", xrows, t, 16 // filters, filters)  # edge
    with pytest.raises(ValueError, match=match):
        cmb._check_tf32_operands("k", x, tt, s, filters)


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
    shifted = torch.empty(xrows.numel() + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        cmb.front_chain(shifted.view(xrows.shape), s_in, t, w, sat, width)
    # K4: at most 128 channels (a tile's rows), L a multiple of 128
    t128, w128 = (torch.zeros(shape, device=cuda_device)
                  for shape in ((128, 128), (128, 4)))
    for c, L_ in ((129, 128), (1, 192)):
        x_ = torch.zeros((c, 2, L_), device=cuda_device)
        s_ = torch.zeros((c, 2, 4), device=cuda_device)
        with pytest.raises(ValueError, match="channels"):
            cmb.kweight_cells(x_, s_, t128[:L_, :L_], w128[:L_], 2)


@pytest.mark.cuda
def test_master_on_the_card_matches_the_cpu_path(cuda_device):
    """The whole chain on the card runs through its kernels and agrees
    with the port's plain CPU path within the JAX chain budget 2e-4."""
    fs = 44100
    x = _signal(2 * fs, 2, fs, 3).T * 0.8
    params = MasteringParams.from_settings(SETTINGS)
    cfg = ChainConfig.gpu_default(fs)
    cmb.reset_launch_counts()
    got = MasteringChain(cfg).to(cuda_device)(x, params, return_result=True)
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    assert counts.pop("front_chain") == 1 and counts.pop("kweight_cells") == 1
    assert counts.pop("gain_limit") == 1
    assert not any(counts.values()), counts   # multiband off: no band kernel
    ref = MasteringChain(cfg)(x, params, return_result=True)
    assert (got.audio.cpu() - ref.audio).abs().max().item() < 2e-4
    assert abs(float(got.measured_lufs) - float(ref.measured_lufs)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [1, 8])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_band_kernels_match_plain(cuda_device, channels, hop):
    """K2 and K3 (with and without the mono output); nb = 45 leaves a
    ragged last group for every channel count."""
    bargs, cols = _band_operands(channels, 45, cuda_device, hop=hop)
    before = cmb.launch_counts()
    got = cmb.band_energies(*bargs, hop=hop)
    ref = cmb.band_energies_ref(*bargs, hop=hop)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    for emit in (False, True):
        got = cmb.band_gain_apply(*bargs[:3], cols, *bargs[3:], hop=hop,
                                  emit_mono=emit)
        ref = cmb.band_gain_apply_ref(*bargs[:3], cols, *bargs[3:], hop=hop,
                                      emit_mono=emit)
        for g, r in zip(got if emit else (got,), ref if emit else (ref,)):
            assert (g - r).abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    after = cmb.launch_counts()
    assert after["band_energies"] == before["band_energies"] + 1
    assert after["band_gain_apply"] == before["band_gain_apply"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", [128, 70 * 128, 300 * 128,
                                  *torch_k5_cases.CASES])
def test_ballistics_kernels_match_plain_bitwise(cuda_device, case):
    """K5 (each of its two launches, and the two together against the
    serial walk), K6 and K7 against their plain versions on the card,
    bitwise; T spans one block, a ragged last CTA and several CTAs; and the
    timelines of ``torch_k5_cases``: frozen stretches between scattered
    live blocks (one longer than the walker's search window), every block
    frozen with ``att0 > 0``, a live run of 96 blocks."""
    if isinstance(case, int):
        m, ca, cr, att0 = _ballistics_operands(case, cuda_device)
    else:
        m, att0, ca, cr = (torch.as_tensor(v, device=cuda_device)
                           for v in torch_k5_cases.case(case))
    t = m.shape[1]
    nblk = t // bal.BLOCK
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    before = cmb.launch_counts()
    lo, hi, stops = bal.pass1_hull(m, ca, cr, hmax)
    lo_p, hi_p, stops_p = bal.pass1_hull_ref(m, ca, cr, hmax)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
    assert torch.equal(stops, stops_p)
    assert torch.equal(bal.pass1_runs(m, ca, cr, att0, lo, hi, stops),
                       bal.pass1_runs_ref(m, ca, cr, att0, lo, hi, stops))
    bnd = bal.pass1_bnd(m, ca, cr, att0)
    serial = bal.pass1_bnd_ref(*(v.cpu() for v in (m, ca, cr, att0)))
    assert torch.equal(bnd.cpu(), serial)
    after = cmb.launch_counts()
    assert after["pass1_hull"] == before["pass1_hull"] + 2
    assert after["pass1_runs"] == before["pass1_runs"] + 2
    inc = torch.cat([att0[:, None], bnd[:, :-1]], dim=1).contiguous()
    assert torch.equal(bal.replay(m, ca, cr, inc),
                       bal.replay_ref(m, ca, cr, inc))
    idx = bal._frozen_index(m)
    s = torch.zeros((3, nblk), device=cuda_device)
    ck, cp = bal.new_ctrl(cuda_device), bal.new_ctrl(cuda_device)
    for _ in range(bal.FIXPOINT_ITERS):
        s_k = bal.replay_bnd(m, ca, cr, att0, idx, s, ck)
        s_p = bal.replay_bnd_ref(m, ca, cr, att0, idx, s, cp)
        assert torch.equal(s_k, s_p) and torch.equal(ck, cp)
        s = s_k
    # the certified (or fallen-back) result equals the serial walk
    assert torch.equal(bal.ballistics_rates_bt(m, ca, cr, att0)[0],
                       bal.ballistics_rates_bt(m, ca, cr, att0,
                                               mode="serial")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 3, bal.FIXPOINT_ITERS])
@pytest.mark.parametrize("t", [128, 70 * 128, 300 * 128, 1 << 23])
def test_replay_bnd_rounds_in_one_launch_match_plain(cuda_device, t, rounds):
    """K7 running up to ``rounds`` fixed-point rounds in one cooperative
    launch against the plain loop of one-round calls, states and ctrl
    bitwise; T = 2^23 steps a band (3 x 65 536 blocks) is more than the
    grid's shared memory holds, so its rounds read m from device memory."""
    m, ca, cr, att0 = _ballistics_operands(t, cuda_device)
    idx = bal._frozen_index(m)
    s0 = torch.zeros((3, t // bal.BLOCK), device=cuda_device)
    ck, cp = bal.new_ctrl(cuda_device), bal.new_ctrl(cuda_device)
    before = bal.replay_bnd.launches
    got = bal.replay_bnd(m, ca, cr, att0, idx, s0, ck, rounds=rounds)
    torch.cuda.synchronize()
    assert bal.replay_bnd.launches == before + 1
    ref = bal.replay_bnd_ref(m, ca, cr, att0, idx, s0, cp, rounds=rounds)
    assert torch.equal(got, ref)
    assert torch.equal(ck, cp), (ck.tolist(), cp.tolist())
    # a launch on the stopped loop carries its input through
    if int(cp[bal.ACTIVE]) == 0:
        assert torch.equal(bal.replay_bnd(m, ca, cr, att0, idx, got, ck,
                                          rounds=rounds), got)
        assert torch.equal(ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256, 512])
def test_band_gain_apply_kernel_matches_plain_at_every_block_size(
        cuda_device, block):
    """K3's column tiles (64 wide) and its causal k-tile skip at every
    block size the kernels take, stereo, hop 8, both outputs; nb = 70
    leaves a ragged last row tile.  Limit: the chip smoke's, 1e-4 of the
    largest value."""
    bargs, cols = _band_operands(2, 70, cuda_device, block=block)
    got = cmb.band_gain_apply(*bargs[:3], cols, *bargs[3:], hop=8,
                              emit_mono=True)
    ref = cmb.band_gain_apply_ref(*bargs[:3], cols, *bargs[3:], hop=8,
                                  emit_mono=True)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert ((g - r).abs().max() / r.abs().max()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(("block", "hop"), [
    (block, hop) for block in (128, 256, 384, 512)
    for hop in (1, 3, 6, 8, 12, block) if block % hop == 0])
def test_band_energies_kernel_matches_plain_at_every_block_and_hop(
        cuda_device, block, hop):
    """K2 at every block size and at hops whose buckets lie inside a
    64-column tile (1, 8), cross from one tile into the next (3, 6, 12)
    or span several (the whole block); stereo, nb = 70 leaves a ragged
    last row tile.  Limit: the chip smoke's, 1e-4 of the largest value."""
    bargs, _ = _band_operands(2, 70, cuda_device, hop=hop, block=block)
    before = cmb.band_energies.launches
    got = cmb.band_energies(*bargs, hop=hop)
    torch.cuda.synchronize()
    assert cmb.band_energies.launches == before + 1
    ref = cmb.band_energies_ref(*bargs, hop=hop)
    assert got.shape == (3, 70 * block // hop)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["ballistics.cu", "band_gain_apply.cu",
                                    "front_chain.cu", "band_energies.cu",
                                    "kweight_cells.cu", "sos_scan.cu",
                                    "gain_limit.cu", "lookahead_limit.cu"])
def test_kernel_sources_do_not_spill(cuda_device, source):
    """ptxas -v on the rewritten sources: every kernel in them reports 0
    bytes of spill stores and loads.  The band kernels are the
    ``tf32_wgmma.cuh`` product's (their entries take its ``wgb::Geometry``):
    with ``setmaxnreg`` the consumers hold more registers than the 96 of
    the launch, and still spill nothing."""
    import re

    from python_audio_mastering_tpu_torch.ops import _kernels

    log = _kernels.library().compiler_log
    assert f"== {source}" in log, "no compiler log beside the library"
    section = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        section)
    assert spills, section
    assert all(a == "0" and b == "0" for a, b in spills), section
    if source.startswith(("band_", "front_", "kweight_")):
        assert "wgb8Geometry" in section, section


def _kernel_sass(kernels=("band_energies_kernel",
                          "band_gain_apply_kernel")):
    """``{kernel name: SASS}`` of ``kernels`` in the built library
    (``cuobjdump -sass``, from the toolkit that built it)."""
    import re
    import subprocess
    from pathlib import Path

    from python_audio_mastering_tpu_torch.ops import _kernels

    cuobjdump = Path(_kernels._nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_kernels.library().path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        for kernel in kernels:
            if kernel in name:
                out[kernel] = fn
    return out


def _assert_wgmma_only(sass):
    """Each kernel's SASS holds warpgroup MMAs on TF32 (``HGMMA ...
    TF32``, wgmma's instruction), no ``HMMA`` (``mma.sync``, the previous
    generation's) and no local memory."""
    import re

    for kernel, text in sass.items():
        hgmma = [line for line in text.splitlines() if "HGMMA" in line]
        print(kernel, len(hgmma), "HGMMA;", hgmma[0].strip() if hgmma
              else "")
        assert hgmma and all("TF32" in line for line in hgmma), kernel
        assert not re.search(r"\bHMMA\b", text), kernel
        assert not re.search(r"\b(STL|LDL)\b", text), kernel


@pytest.mark.cuda
def test_band_kernels_run_tf32_wgmma_and_no_mma_sync(cuda_device):
    """The design guard of K2 and K3 (:func:`_assert_wgmma_only`)."""
    sass = _kernel_sass()
    assert sorted(sass) == ["band_energies_kernel", "band_gain_apply_kernel"]
    _assert_wgmma_only(sass)


@pytest.mark.cuda
def test_one_filter_kernels_run_tf32_wgmma_and_no_mma_sync(cuda_device):
    """The design guard of K1 and K4 (:func:`_assert_wgmma_only`): K1's
    ``m64n128k8`` and K4's ``m64n64k8`` products."""
    sass = _kernel_sass(("front_chain_kernel", "kweight_cells_kernel"))
    assert sorted(sass) == ["front_chain_kernel", "kweight_cells_kernel"]
    _assert_wgmma_only(sass)
    assert "64x128x8" in sass["front_chain_kernel"]
    assert "64x64x8" in sass["kweight_cells_kernel"]


def test_no_kernel_source_runs_mma_sync():
    """Every tensor-core product of ``csrc/`` runs on ``wgmma``
    (``tf32_wgmma.cuh``): no source names ``mma.sync``, and the
    ``mma.sync`` header ``tf32_product.cuh`` is gone."""
    from python_audio_mastering_tpu_torch.ops import _kernels

    cu, cuh = _kernels._sources()
    names = [f.name for f in cu + cuh]
    assert "tf32_product.cuh" not in names
    assert "tf32_wgmma.cuh" in names
    for f in cu + cuh:
        assert "mma.sync" not in f.read_text(), f.name
    for f in ("front_chain.cu", "kweight_cells.cu", "band_energies.cu",
              "band_gain_apply.cu"):
        assert '#include "tf32_wgmma.cuh"' in (
            _kernels._SRC_DIR / f).read_text(), f


@pytest.mark.cuda
@pytest.mark.parametrize(("channels", "nb"), [
    (2, 1), (1, 1), (2, 63), (2, 65), (3, 43), (1, 129),
    (2, 12 * 2940)])
def test_band_kernels_on_the_persistent_grid(cuda_device, channels, nb):
    """K2 and K3 over grids of one item, a partial row tile (63 blocks of
    the 64 a stereo tile holds; 129 mono blocks), one block past a tile,
    and the album chunk's rows (12 tracks x 2940 blocks, stereo), hop 8
    and (K2) hop 3, against their plain twins within 1e-4 of the max."""
    bargs, cols = _band_operands(channels, nb, cuda_device)
    for hop in (8, 3):
        got = cmb.band_energies(*bargs, hop=hop)
        ref = cmb.band_energies_ref(*bargs, hop=hop)
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    got = cmb.band_gain_apply(*bargs[:3], cols, *bargs[3:], hop=8,
                              emit_mono=True)
    ref = cmb.band_gain_apply_ref(*bargs[:3], cols, *bargs[3:], hop=8,
                                  emit_mono=True)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert ((g - r).abs().max() / r.abs().max()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [3, 8])
def test_band_kernels_give_the_same_bits_twice(cuda_device, hop):
    """Every bucket and sample is summed in one fixed order by one thread
    (no atomics, a static schedule): two launches agree bit for bit."""
    bargs, cols = _band_operands(2, 700, cuda_device, hop=hop)
    e1, e2 = (cmb.band_energies(*bargs, hop=hop) for _ in range(2))
    y1, y2 = (cmb.band_gain_apply(*bargs[:3], cols, *bargs[3:], hop=hop,
                                  emit_mono=True) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(e1, e2)
    assert torch.equal(y1[0], y2[0]) and torch.equal(y1[1], y2[1])


@pytest.mark.cuda
def test_band_kernels_refuse_more_states_than_their_registers_hold(
        cuda_device):
    """The wgmma band kernels hold 4 states a filter (the LR4 crossovers'):
    a 6th-order cascade (S = 6) is refused before a launch."""
    (xrows, s_lp, s_hp, *_), cols = _band_operands(2, 9, cuda_device)
    sos = butter_sos(6, 250.0, "lowpass", fs=44100)
    s6 = torch.zeros((2, 9, 6), device=cuda_device)
    with pytest.raises(ValueError, match="at most 4 states"):
        cmb.band_energies(xrows, s6, s6, sos, sos, hop=8)
    with pytest.raises(ValueError, match="at most 4 states"):
        cmb.band_gain_apply(xrows, s6, s6, cols, sos, sos, hop=8)


@pytest.mark.cuda
def test_multiband_master_on_the_card_matches_the_cpu_path(cuda_device):
    """The multiband chain on the card launches every kernel of the path
    and agrees with the port's plain CPU path within the on-chip budget."""
    fs = 44100
    x = _signal(2 * fs, 2, fs, 3).T * 0.8
    params = MasteringParams.from_settings({**SETTINGS, "multiband": True})
    cfg = ChainConfig.gpu_default(fs)
    cmb.reset_launch_counts()
    got = MasteringChain(cfg).to(cuda_device)(x, params, return_result=True)
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    for name in ("front_chain", "kweight_cells", "band_energies",
                 "band_gain_apply", "replay", "replay_bnd"):
        assert counts[name] >= 1, (name, counts)
    ref = MasteringChain(cfg)(x, params, return_result=True)
    d = (got.audio.cpu() - ref.audio).abs()
    assert d.max().item() < 5e-3 and d.pow(2).mean().sqrt().item() < 5e-5
    assert abs(float(got.measured_lufs) - float(ref.measured_lufs)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("multiband", [False, True])
def test_legacy_chain_on_the_card(cuda_device, multiband):
    """The legacy chain: K1 with the legacy exciter ``(0, 1/g, g)``
    against its plain twin (max abs <= 1e-4), and the one-shot and streamed
    legacy chains on the card against the CPU path (the multiband limits
    above)."""
    from python_audio_mastering_tpu_torch import master
    from python_audio_mastering_tpu_torch.ops import waveshaper as ws
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )

    params = MasteringParams.from_settings({**SETTINGS,
                                            "multiband": multiband})
    cfg = dataclasses.replace(ChainConfig.gpu_default(48000),
                              variant="legacy")
    xrows, s_in, t, w, _, width = _front_operands(2, 45, cuda_device, 48000)
    coefs = ws.exciter_coefs(params.saturation, "legacy")
    s_in, _, _ = iir.sosfilt_states_rows(None, ws.exciter(xrows, coefs),
                                         ops=MasteringChain(cfg).to(
                                             cuda_device).eq_ops(params))
    got = cmb.front_chain(xrows, s_in, t, w, coefs, width)
    assert (got - cmb.front_chain_ref(xrows, s_in, t, w, coefs,
                                      width)).abs().max().item() <= 1e-4
    x = _signal(96000, 2, 48000, 11).T.copy() * 0.5
    for run in (lambda d: master(x, params, cfg, device=d).cpu().numpy(),
                lambda d: master_streamed(x, params, cfg, chunk_seconds=0.6,
                                          device=d)[0]):
        d = np.abs(run(cuda_device) - run("cpu"))
        assert d.max() < 5e-3 and np.sqrt(np.mean(d ** 2)) < 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sos_scan_kernel_bitwise_its_plain_version(cuda_device, dtype):
    """K8: three cascades of 2, 2 and 4 sections in one launch over three
    columns, each from its own state, each column's final state after its
    own valid length, and the recorded sections: bitwise the plain
    version on the CPU."""
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    r = np.random.default_rng(8)
    lp = butter_sos(4, 0.05, "lowpass")
    hp = butter_sos(4, 0.3, "highpass")
    mid = np.concatenate([hp, lp])
    x = torch.from_numpy(r.standard_normal((3, 5000))).to(dtype)
    zis = [torch.from_numpy(r.standard_normal((s.shape[0], 2, 3)) * 0.1)
           .to(dtype) for s in (lp, hp, mid)]
    nv = [5000, 1234, 0]
    before = k8.sos_scan.launches
    got_y, got_z = k8.sos_scan(x.to(cuda_device), [lp, hp, mid],
                               [z.to(cuda_device) for z in zis], nv)
    torch.cuda.synchronize()
    assert k8.sos_scan.launches == before + 1
    ref_y, ref_z = k8.sos_scan_ref(x, [lp, hp, mid], zis, nv)
    assert torch.equal(got_y.cpu(), ref_y)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_z, ref_z))
    sos = k8._as_sos(mid, x)
    rec = k8._sections(x.to(cuda_device), sos.to(cuda_device),
                       zis[2].to(cuda_device))
    assert torch.equal(rec.cpu(), k8._sections(x, sos, zis[2]))


def _scan_operands(rows, n, k, dtype, seed, dev, offset=1):
    """``rows`` columns of ``n`` samples, CPU and card copies, each a view
    ``offset`` elements into its storage (so a row starts off a 16-byte
    boundary wherever ``(offset + r * n) * elem`` is not a multiple of
    16), a stable
    cascade of ``k`` sections (second-order low passes) and ``rows``
    initial states."""
    r = np.random.default_rng(seed)
    buf = torch.from_numpy(r.standard_normal(rows * n + offset)).to(dtype)
    x, xd = (b[offset:].view(rows, n) for b in (buf, buf.to(dev)))
    sos = np.concatenate([butter_sos(2, w) for w in np.linspace(0.05, 0.4,
                                                                 k)])
    zi = torch.from_numpy(r.standard_normal((k, 2, rows)) * 0.1).to(dtype)
    return x, xd, sos, zi


@pytest.mark.cuda
@pytest.mark.parametrize("n_case", ["under_a_tile", "a_tile_and_one",
                                    "two_tiles", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_sos_scan_kernel_bitwise_by_sections(cuda_device, k, dtype, n_case):
    """K8 at k sections, in one launch, bitwise its plain version: N
    under one tile, one sample over a tile and an odd N (``N * elem`` not
    a multiple of 16), rows off 16-byte boundaries; two whole tiles with
    every row and output aligned (float32's four-sample loads and
    stores); final states taken at valid lengths 0, 1, mid-tile, a tile
    edge and N."""
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    tile = k8.launch_plan(k, dtype).tile
    n = {"under_a_tile": tile // 2 + 3, "a_tile_and_one": tile + 1,
         "two_tiles": 2 * tile, "odd": 5001}[n_case]
    nv = [0, 1, min(tile // 2 + 1, n), min(tile, n), n]
    x, xd, sos, zi = _scan_operands(len(nv), n, k, dtype, k, cuda_device,
                                    offset=int(n_case != "two_tiles"))
    before = k8.sos_scan.launches
    got_y, (got_z,) = k8.sos_scan(xd, [sos], [zi.to(cuda_device)], nv)
    torch.cuda.synchronize()
    assert k8.sos_scan.launches == before + 1
    ref_y, (ref_z,) = k8.sos_scan_ref(x, [sos], [zi], nv)
    assert torch.equal(got_y.cpu(), ref_y)
    assert torch.equal(got_z.cpu(), ref_z)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sos_scan_kernel_records_every_section(cuda_device, k, dtype):
    """The record path (every section's output, as the gradient's adjoint
    cascade of 2K <= 8 sections launches it, the largest shared memory at
    k = 8) in one launch, bitwise the plain version's."""
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    x, xd, sos, zi = _scan_operands(3, 5001, k, dtype, 20 + k, cuda_device)
    sos_t = k8._as_sos(sos, x)
    before = k8.sos_scan.launches
    rec = k8._sections(xd, sos_t.to(cuda_device), zi.to(cuda_device))
    torch.cuda.synchronize()
    assert k8.sos_scan.launches == before + 1
    assert torch.equal(rec.cpu(), k8._sections(x, sos_t, zi))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sos_scan_kernel_long_cascade_in_pieces(cuda_device, dtype):
    """A 12-section cascade: two launches (8 sections, then 4 on their
    output), output, final states and recorded sections bitwise the plain
    version's."""
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    x, xd, sos, zi = _scan_operands(2, 3001, 12, dtype, 12, cuda_device)
    nv = [3001, 1500]
    before = k8.sos_scan.launches
    got_y, (got_z,) = k8.sos_scan(xd, [sos], [zi.to(cuda_device)], nv)
    torch.cuda.synchronize()
    assert k8.sos_scan.launches == before + 2
    ref_y, (ref_z,) = k8.sos_scan_ref(x, [sos], [zi], nv)
    assert torch.equal(got_y.cpu(), ref_y)
    assert torch.equal(got_z.cpu(), ref_z)
    sos_t = k8._as_sos(sos, x)
    rec = k8._sections(xd, sos_t.to(cuda_device), zi.to(cuda_device))
    assert k8.sos_scan.launches == before + 4
    assert torch.equal(rec.cpu(), k8._sections(x, sos_t, zi))


@pytest.mark.cuda
def test_sos_scan_kernel_refuses_a_wrong_launch(cuda_device):
    """The C entry refuses a shared-memory size other than its plan's,
    more than 8 sections, and y and ysec both given or both missing; the
    wrapper raises on a refused launch."""
    from python_audio_mastering_tpu_torch.ops import _kernels
    from python_audio_mastering_tpu_torch.ops import sos_scan as k8

    x = torch.zeros((1, 64), device=cuda_device)
    sos = torch.tensor([[1.0, 0, 0, 1, 0, 0]], device=cuda_device)
    nsec = torch.ones(1, dtype=torch.int32, device=cuda_device)
    zi = torch.zeros((1, 1, 2, 1), device=cuda_device)
    nv = torch.full((1,), 64, dtype=torch.int64, device=cuda_device)
    y, zf = torch.empty_like(x), torch.empty_like(zi)
    fn = _kernels.library().lib.pam_sos_scan_f32
    ptr = _kernels.ptr
    stream = torch.cuda.current_stream().cuda_stream
    good = k8.launch_plan(1, torch.float32).smem_bytes

    def launch(y_ptr, ysec_ptr, kmax=1, smem=good):
        return fn(ptr(x), ptr(sos), ptr(nsec), ptr(zi), ptr(nv), y_ptr,
                  ptr(zf), ysec_ptr, 1, 1, 64, kmax, smem, stream)

    assert launch(ptr(y), None) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    for bad in (launch(ptr(y), None, smem=good + 16),
                launch(ptr(y), None, kmax=9, smem=good),
                launch(ptr(y), ptr(y)), launch(None, None)):
        assert bad != 0
    with pytest.raises(RuntimeError, match="sos_scan kernel launch failed"):
        k8._raise_on("sos_scan", launch(None, None))


def _tail_operands(channels, tracks, m, device, seed=0, gained=True):
    """Rows ``(C, T, M)`` of which many cross the limiter's threshold
    once gained, with zeros, signed zeros and the threshold itself among
    them; T distinct gains (or None)."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((channels, tracks, m)) * 0.7).astype(np.float32)
    flat = x.reshape(-1)
    flat[: 6] = [0.0, -0.0, 0.98, -0.98, 1e-30, -3.5]
    gain = (torch.tensor(np.linspace(0.6, 2.2, tracks), dtype=torch.float32,
                         device=device) if gained else None)
    return torch.as_tensor(x, device=device), gain


def _max_ulps(a, b):
    """The largest distance in float32 steps between ``a`` and ``b``."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize(("m", "n"), [(640, 640), (640, 637), (641, 639)])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("gained", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_kernel_bitwise_plain(cuda_device, variant, gained,
                                         channels, m, n):
    """K9 against its plain version on the card, bit for bit: the quads'
    16-byte loads (M a multiple of 4) and scalar ones (M = 641), 16-,
    8- and 4-byte aligned stores (t·n·C offsets with n = 637 odd), a
    track's last partial quad."""
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    xr, gain = _tail_operands(channels, 3, m, cuda_device, seed=channels,
                              gained=gained)
    before = k9.gain_limit.launches
    got = k9.gain_limit(xr, gain, n, 0.98, variant)
    want = k9.gain_limit_ref(xr, gain, n, 0.98, variant)
    torch.cuda.synchronize()
    assert k9.gain_limit.launches == before + 1
    assert got.shape == (3, n, channels) and got.is_contiguous()
    assert torch.equal(got, want), _max_ulps(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_kernel_bitwise_plain_on_the_persistent_grid(
        cuda_device, variant):
    """Tracks of 4 M frames: every thread of the grid walks several quads
    of each track."""
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    m = 1 << 22
    xr, gain = _tail_operands(2, 2, m, cuda_device, seed=9)
    got = k9.gain_limit(xr, gain, m - 3, 0.98, variant)
    want = k9.gain_limit_ref(xr, gain, m - 3, 0.98, variant)
    assert torch.equal(got, want), _max_ulps(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("gained", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_vjp_on_the_card_matches_plain_autograd(
        cuda_device, variant, gained):
    """K9 under autograd (the kernel forward, the VJP in plain torch)
    against autograd through its plain version: within 1e-5 of each
    gradient's max."""
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    xr, gain = _tail_operands(2, 3, 640, cuda_device, seed=4, gained=gained)
    up = torch.randn((3, 637, 2), device=cuda_device,
                     generator=torch.Generator(device=cuda_device
                                               ).manual_seed(1))
    grads = []
    for fn in (k9.gain_limit, k9.gain_limit_ref):
        x_ = xr.clone().requires_grad_(True)
        g_ = None if gain is None else gain.clone().requires_grad_(True)
        before = k9.gain_limit.launches
        (fn(x_, g_, 637, 0.98, variant) * up).sum().backward()
        assert k9.gain_limit.launches == before + (fn is k9.gain_limit)
        grads.append((x_.grad, g_))
    (dx, g1), (dx_ref, g2) = grads
    assert (dx - dx_ref).abs().max() <= 1e-5 * dx_ref.abs().max()
    if gained:
        assert ((g1.grad - g2.grad).abs().max()
                <= 1e-5 * g2.grad.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reference", "lookahead_truepeak"])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_forward_tracks_launches_gain_limit_once(cuda_device, variant,
                                                 mode, monkeypatch):
    """One K9 launch a ``forward_tracks`` call with the reference limiter
    (none with the lookahead limiter), whose output equals the CPU path's
    within the chain budget, and, bit for bit, the same chain ending in
    the unfused plain ops; the launch adds no host synchronisation."""
    import warnings

    from python_audio_mastering_tpu_torch.models import chain as chain_mod
    from python_audio_mastering_tpu_torch.ops.waveshaper import (
        soft_limiter,
        soft_limiter_legacy,
    )

    def unfused_tail(xr, gain, n, threshold, variant="worker"):
        if gain is not None:
            xr = xr * gain.view(1, xr.shape[1], 1)
        lim = soft_limiter_legacy if variant == "legacy" else soft_limiter
        return lim(xr[:, :, :n].permute(1, 2, 0), threshold=threshold)

    fs = 44100
    cfg = dataclasses.replace(ChainConfig.gpu_default(fs), variant=variant,
                              limiter_mode=mode)
    params = MasteringParams.from_settings({**SETTINGS, "lufs": -9.0})
    batch = np.stack([_signal(fs, 2, fs, 30 + i).T * 0.8
                      for i in range(2)]).astype(np.float32)
    chain = MasteringChain(cfg).to(cuda_device)
    xb = torch.as_tensor(batch, device=cuda_device)
    chain.forward_tracks(xb, params)                  # operators built
    syncs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(chain_mod, "gain_limit", unfused_tail)
        cmb.reset_launch_counts()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                y, _, _ = chain.forward_tracks(xb, params)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # the synchronising calls, not the mode's own notice (given once
        # a process: "... does not yet detect all synchronizing ...")
        syncs.append(sum("synchroniz" in str(w.message)
                         and "does not yet detect" not in str(w.message)
                         for w in caught))
        if fused:
            assert cmb.launch_counts()["gain_limit"] == (
                1 if mode == "reference" else 0)
            y_fused = y
    assert syncs[0] == syncs[1], syncs
    if mode == "reference":
        assert y_fused.is_contiguous()
        assert torch.equal(y_fused, y)
    ref, _, _ = MasteringChain(cfg).forward_tracks(torch.as_tensor(batch),
                                                   params)
    assert (y_fused.cpu() - ref).abs().max().item() < 5e-3


@pytest.mark.cuda
def test_gain_limit_adds_no_host_sync(cuda_device):
    """K9's wrapper under PyTorch's sync debug mode set to raise: the
    gain stays on the device, the launch never waits for the card."""
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    xr, gain = _tail_operands(2, 3, 640, cuda_device)
    k9.gain_limit(xr, gain, 637, 0.98, "worker")      # the library loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k9.gain_limit(xr, gain, 637, 0.98, "worker")
        k9.gain_limit(xr, None, 637, 0.98, "legacy")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gain_limit_refuses_what_the_kernel_cannot_take(cuda_device):
    from python_audio_mastering_tpu_torch.ops import gain_limit as k9

    xr, gain = _tail_operands(2, 3, 64, cuda_device)
    for bad in (dict(xr=xr.double()), dict(n=65), dict(n=0),
                dict(gain=gain[:2]), dict(gain=gain.cpu())):
        args = {"xr": xr, "gain": gain, "n": 60, **bad}
        with pytest.raises(ValueError, match="gain_limit"):
            k9.gain_limit(args["xr"], args["gain"], args["n"], 0.98)


# K10 lookahead_limit ---------------------------------------------------------

FS_Q = 44100


def _limiter_input(kind, n, channels, device, seed=0):
    """Seeded float32 ``(n, C)`` on the card: hot noise with a loud and a
    quiet stretch, silence, a hot square wave, or a quiet track that ends
    in a burst (inside an attack)."""
    r = np.random.default_rng(seed)
    if kind == "noise":
        x = r.standard_normal((n, channels)) * 0.6
        x[n // 3: n // 2] *= 4.0
        x[2 * n // 3:] *= 0.05
    elif kind == "silence":
        x = np.zeros((n, channels))
    elif kind == "square":
        t = np.arange(n) / FS_Q
        x = np.repeat(1.6 * np.sign(np.sin(2 * np.pi * 441.0 * t))[:, None],
                      channels, 1)
    else:
        x = r.standard_normal((n, channels)) * 0.05
        x[-min(n, 33):] *= 60.0
    return torch.as_tensor(x.astype(np.float32), device=device)


def _k10_against_twin(x, **kw):
    """K10 through the limiter's route and its twin on ``x``: one launch
    and no twin call on the route, the gain within 2e-6 of the
    twin's relative to it, the output within 1e-6 (the only freedom is the
    FIR's order of sums in float32, ~1 unit of the envelope, and the
    float64 sums' rounding before their cast: a few units of the gain),
    the input's envelope times the kernel's gain at most the ceiling
    times 1 + 1e-6 (its two float32 roundings and the output's: the true
    peak the limiter controls, -1 dBTP + 1e-6 dB), and the output's own
    true peak the twin's within 3e-5 dB (the outputs' 1e-6 through the
    interpolator, whose phases sum |taps| to 2.25 at most, over these
    outputs' peaks of 0.69 or more: 3.3e-6 relative, 2.8e-5 dB)."""
    from python_audio_mastering_tpu_torch.ops import limiter as lim
    from python_audio_mastering_tpu_torch.ops import meters

    cmb.reset_launch_counts()
    got = lim.lookahead_limiter(x, FS_Q, **kw)
    assert cmb.launch_counts()["lookahead_limit"] == 1
    assert cmb.plain_calls()["lookahead_limit_ref"] == 0
    want = lim.lookahead_limit_ref(x, FS_Q, **kw)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-6
    xs = x if x.ndim == 2 else x[:, None]
    big = xs.abs().argmax(dim=1, keepdim=True)       # the loudest channel
    xb = xs.gather(1, big).double()[:, 0]
    keep = xb.abs() > 1e-3
    g_got = ((got if got.ndim == 2 else got[:, None]).gather(1, big)
             .double()[:, 0] / xb)
    g_want = ((want if want.ndim == 2 else want[:, None]).gather(1, big)
              .double()[:, 0] / xb)
    if keep.any():
        rel = ((g_got - g_want).abs() / g_want)[keep].max().item()
        assert rel <= 2e-6, rel
        if kw.get("true_peak", True):
            env = lim._peak_env(xs, True).double()
            ceiling = 10.0 ** (kw.get("ceiling_db", -1.0) / 20.0)
            assert (env * g_got)[keep].max().item() <= ceiling * (1 + 1e-6)
    if got.abs().max() > 0:
        tp = meters.true_peak_db(got).item()
        assert abs(tp - meters.true_peak_db(want).item()) <= 3e-5
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("true_peak", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [1, 65, 149, 4155, 9001, 300017])
@pytest.mark.parametrize("kind", ["noise", "silence", "square", "end_attack"])
def test_lookahead_limit_kernel_against_its_twin(cuda_device, kind, n,
                                                 channels, true_peak):
    """K10 on tracks shorter than its halos, lengths that fill no tile
    (4154 frames at the default look-ahead), several tiles chained by the
    look-back, silence, hard limiting and a track ending in an attack."""
    x = _limiter_input(kind, n, channels, cuda_device, seed=n)
    _k10_against_twin(x, true_peak=true_peak)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"lookahead_ms": 0.0}, {"release_ms": 1e-6},
                                {"release_ms": 2000.0},
                                {"ceiling_db": -3.0, "lookahead_ms": 5.0}])
def test_lookahead_limit_kernel_other_settings(cuda_device, kw):
    """A look-ahead of one frame (the direct erosion), no release (rho =
    0), a release long enough that the look-back walks past 32 tiles,
    another ceiling and a longer look-ahead."""
    x = _limiter_input("noise", 400_000, 2, cuda_device, seed=5)
    _k10_against_twin(x, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["chain_rows", "padded_length", "mono_1d",
                                  "three_channels"])
def test_lookahead_limit_kernel_on_strided_views(cuda_device, view):
    """The chain's track view ``xr[:, i, :v].T`` (element strides (1,
    T·M)), the ``as_strided`` view over the padding after it, a 1-D mono
    track and three channels (read again from the L2 cache for the
    output)."""
    tracks, m, v = 3, 200_000, 123_457
    if view in ("chain_rows", "padded_length"):
        rows = _limiter_input("noise", 2 * tracks * m, 1, cuda_device,
                              seed=9).reshape(2, tracks, m)
        x = rows[:, 1, :v].T
        if view == "padded_length":
            x = x.as_strided((m, 2), x.stride(), x.storage_offset())
        assert not x.is_contiguous()
    elif view == "mono_1d":
        x = _limiter_input("noise", v, 1, cuda_device, seed=10)[:, 0]
    else:
        x = _limiter_input("noise", v, 3, cuda_device, seed=11)
    _k10_against_twin(x)


@pytest.mark.cuda
def test_lookahead_limit_adds_no_host_sync(cuda_device):
    """K10's wrapper under PyTorch's sync debug mode set to raise: the
    workspace is zeroed on the stream, the taps uploaded once, the launch
    never waits for the card."""
    from python_audio_mastering_tpu_torch.ops import limiter as lim

    x = _limiter_input("noise", 50_000, 2, cuda_device)
    lim.lookahead_limiter(x, FS_Q)                 # the library loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lim.lookahead_limiter(x, FS_Q)
        lim.lookahead_limiter(x[:, 0], FS_Q, true_peak=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lookahead_limit_refuses_what_the_kernel_cannot_take(cuda_device):
    """A float64 signal, and a look-ahead over ``MAX_LOOK`` frames, which
    the route takes to the kernel on the card and the kernel refuses."""
    from python_audio_mastering_tpu_torch.ops import limiter as lim
    from python_audio_mastering_tpu_torch.ops import lookahead_limit as k10

    x = _limiter_input("noise", 1000, 2, cuda_device)
    taps = lim._k10_taps(x.device)
    with pytest.raises(ValueError, match="lookahead_limit"):
        k10.lookahead_limit(x.double(), taps, FS_Q)
    with pytest.raises(ValueError, match="at most 1365 frames"):
        lim.lookahead_limiter(x, FS_Q, lookahead_ms=40.0)
    lim.lookahead_limiter(x, FS_Q, lookahead_ms=30.0)      # 1323 frames


@pytest.mark.cuda
def test_forward_tracks_quality_launches_lookahead_limit_a_track(cuda_device):
    """The album in quality mode on the card: one K10 launch a track,
    no K9, each track limited to its own end (zeros after it), as many
    host synchronisations as with the plain stages, and the CPU path's
    output within the chain budget 5e-3."""
    import warnings

    from python_audio_mastering_tpu_torch.models import chain as chain_mod
    from python_audio_mastering_tpu_torch.ops import limiter as lim

    cfg = dataclasses.replace(ChainConfig.gpu_default(FS_Q),
                              limiter_mode="lookahead_truepeak")
    params = MasteringParams.from_settings({**SETTINGS, "lufs": -8.0})
    lengths = [FS_Q, 30011, 9001]
    batch = np.zeros((3, FS_Q, 2), np.float32)
    for i, v in enumerate(lengths):
        batch[i, :v] = _signal(v, 2, FS_Q, 40 + i).T * 0.8
    chain = MasteringChain(cfg).to(cuda_device)
    xb = torch.as_tensor(batch, device=cuda_device)
    chain.forward_tracks(xb, params, lengths)        # operators built
    syncs, outs = [], []
    with pytest.MonkeyPatch.context() as mp:
        for kernel in (True, False):
            if not kernel:
                mp.setattr(chain_mod, "lookahead_limiter",
                           lim.lookahead_limit_ref)
            cmb.reset_launch_counts()
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    y, _, _ = chain.forward_tracks(xb, params, lengths)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            syncs.append(sum("synchroniz" in str(w.message)
                             and "does not yet detect" not in str(w.message)
                             for w in caught))
            counts = cmb.launch_counts()
            assert counts["lookahead_limit"] == (3 if kernel else 0)
            assert counts["gain_limit"] == 0
            outs.append(y)
    assert syncs[0] == syncs[1], syncs
    got, plain = outs
    assert (got - plain).abs().max().item() <= 1e-6
    for i, v in enumerate(lengths):
        assert not got[i, v:].any()
    ref, _, _ = MasteringChain(cfg).forward_tracks(torch.as_tensor(batch),
                                                   params, lengths)
    assert (got.cpu() - ref).abs().max().item() < 5e-3
