"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the test conftest (which imports jax),
so the card's machine, which has no jax, runs it:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests marked ``cuda`` need an NVIDIA GPU and skip without one; the
others check the wrappers' device dispatch on the CPU.  K1 and K4 under
autograd (the kernel forward, the VJP written out in plain torch) against
autograd through their plain twins: within 1e-5 of each gradient's max.  Kernel vs plain
on the card: fp32 sums in another order, max abs ≤ 1e-4 (K2, K4:
relative to the largest value; K1-K4 run their products in 3xTF32 on the
tensor cores, close to fp32, K4 its states term in fp32); the ballistics
kernels K5-K7 run the plain version's float operations in its order, so
they agree bitwise.
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
    lo, hi = bal.pass1_hull(m, ca, cr, att0 + 12.0)
    assert all(torch.equal(a, b) for a, b in zip(
        (lo, hi), bal.pass1_hull_ref(m, ca, cr, att0 + 12.0)))
    assert torch.equal(bal.pass1_runs(m, ca, cr, att0, lo, hi),
                       bal.pass1_runs_ref(m, ca, cr, att0, lo, hi))
    assert cmb.launch_counts() == {
        "front_chain": 0, "kweight_cells": 0, "band_energies": 0,
        "band_gain_apply": 0, "pass1_hull": 0, "pass1_runs": 0, "replay": 0,
        "replay_bnd": 0, "sos_scan": 0}


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
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.pass1_bnd(m, ca, cr, att0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bal.pass1_runs(m, ca, cr, att0, inc, inc)
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
    """K4 (x @ T in 3xTF32, the states term in fp32) at every block size:
    h = 6 at 44.1 kHz and 192 at 48 kHz with block 384 (buckets that cross
    the 128-column tiles, joined by the row group's last CTA), 2 and 64 at
    the other sizes; nb = 99 leaves a ragged last row tile, and 3 channels
    a tile of 126 rows.  Limit: the chip smoke's, 1e-4 of the max.  A
    second launch gives the same bits: the last CTA of each row group set
    its ticket back to 0."""
    args = _kweight_operands(channels, 99, cuda_device, fs, block)
    before = cmb.kweight_cells.launches
    got = cmb.kweight_cells(*args)
    torch.cuda.synchronize()
    assert cmb.kweight_cells.launches == before + 1
    ref = cmb.kweight_cells_ref(*args)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    assert torch.equal(cmb.kweight_cells(*args), got)
    assert all(int(t.abs().sum()) == 0 for t in cmb._TICKETS.values())


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
    """The whole chain on the card runs through both kernels and agrees
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
@pytest.mark.parametrize("t", [128, 70 * 128, 300 * 128])
def test_ballistics_kernels_match_plain_bitwise(cuda_device, t):
    """K5 (each of its two launches, and the two together against the
    serial walk), K6 and K7 against their plain versions on the card,
    bitwise; T spans one block, a ragged last CTA and several CTAs."""
    m, ca, cr, att0 = _ballistics_operands(t, cuda_device)
    nblk = t // bal.BLOCK
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    before = cmb.launch_counts()
    lo, hi = bal.pass1_hull(m, ca, cr, hmax)
    lo_p, hi_p = bal.pass1_hull_ref(m, ca, cr, hmax)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
    assert torch.equal(bal.pass1_runs(m, ca, cr, att0, lo, hi),
                       bal.pass1_runs_ref(m, ca, cr, att0, lo, hi))
    bnd = bal.pass1_bnd(m, ca, cr, att0)
    assert torch.equal(bnd, bal.pass1_bnd_ref(m, ca, cr, att0))
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
                                    "kweight_cells.cu"])
def test_kernel_sources_do_not_spill(cuda_device, source):
    """ptxas -v on the rewritten sources: every kernel in them reports 0
    bytes of spill stores and loads."""
    import re

    from python_audio_mastering_tpu_torch.ops import _kernels

    log = _kernels.library().compiler_log
    assert f"== {source}" in log, "no compiler log beside the library"
    section = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        section)
    assert spills, section
    assert all(a == "0" and b == "0" for a, b in spills), section


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
