"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times   # kernel times only (A/B runs)

Drives the port (``python_audio_mastering_tpu_torch``, never jax) through
its entry points, called without a ``device`` argument (they run on the
card by default), on a seeded 180 s 44.1 kHz stereo track with the bench
settings, multiband off (phases 2-6) and on (phases 7-12), after building
its CUDA kernels from the sources in the checkout and checking each
against its plain PyTorch version at the shapes the chain gives it.
Phases:

  0  device, torch/CUDA versions, TF32 flags (refuses without a GPU)
  1  build the kernels (nvcc, sm_90a)
  2  front_chain kernel (3xTF32 on the tensor cores) vs plain (fp32
     cuBLAS), (2, 20672, 384), emit_mono off and on: max abs <= 1e-4
  3  kweight_cells kernel (x @ T in 3xTF32 on the tensor cores, the states
     term in fp32) vs plain, (1, 20672, 384), at the chain's h = 6 and at
     h = 192 (48 kHz's bucket, which spans column tiles): max |diff| /
     max |plain| <= 1e-4
  4  master() without a device argument: on the card, finite, |y| <= 1,
     BS.1770 oracle loudness within 0.15 LU of -14, both kernels
     launched, and within 2e-4 max abs / 1e-3 LU of the port's plain path
     on the CPU
  5  engine.process_audio and master_streamed without a device argument,
     on a temp WAV: both launch the kernels; process_audio equals one-shot
     master() within 2e-4
  6  timings: the chain (CUDA events, warm, median of 5), each kernel
     (its device time under torch.profiler, mean of 10 launches), its
     plain version and, for the product kernels, one torch.matmul of the
     same operands (the yardstick, product only; CUDA events, median of
     5); kweight_cells also at the streamed runner's chunk, (1, 2940, 384)
  7  band_energies kernel (3xTF32 on the tensor cores) vs plain,
     (2, 20672, 384), at the chain's hop 8 and at hop 3 (buckets that
     cross the kernel's 64-column tiles): max |diff| / max |plain| <= 1e-4
  8  band_gain_apply kernel (3xTF32 on the tensor cores) vs plain (fp32
     cuBLAS), emit_mono off and on: max |diff| / max |plain| <= 1e-4
  9  ballistics on the track's own detector targets (3, 992256): K5's two
     launches (hull pass, run walk) bitwise equal to their plain twins at
     full T, and the hull statistics (collapsed share, runs, longest
     run); K5 bitwise equal to the serial walk pass1_bnd_ref on the first
     65 536 steps (a Python loop of one step per iteration, too slow at
     full T); replay and replay_bnd (every fixed-point round as a
     one-round launch, and all rounds in one launch, ctrl included)
     bitwise equal to their plain versions at full T, and all rounds in
     one launch on a bursty (3, 8388608) timeline, too long for the
     grid's shared memory; at full T the collapse mode, the serial mode
     and the forced fallback (iters=1) bitwise equal; fixed-point rounds
     reported
 10  multiband master(): finite, |y| <= 1, oracle loudness within 0.15 LU
     of -14, every kernel of the path launched (replay_bnd once: the
     whole fixed point is one launch), host synchronisations
     counted, and within 5e-3 max abs / 5e-5 rms / 1e-3 LU of the port's
     plain path on the CPU (the JAX package's on-chip kernels-vs-XLA
     residual from detector threshold flips is 1.2e-3 / 1.3e-5)
 11  multiband engine.process_audio (no device argument): equals one-shot
     master() within 2e-4
 12  multiband timings: master(), process_audio, the ballistics in serial
     and collapse mode, each kernel vs its plain version (and the
     yardstick product for the band kernels); replay_bnd as one launch
     for the whole fixed point
 13  where the time goes: torch.profiler over 5 calls of master(),
     multiband on and off: device time per call, the kernels that take
     it, and the share of the wall the device is idle

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
peak rate of their type (67 TFLOP/s fp32 on the CUDA cores; 495 TFLOP/s
TF32 on the tensor cores for the three products per multiply-add of K1,
K2, K3 and K4's x @ T, with K4's states term on the fp32 cores; each
product kernel's bound all on the fp32 cores is printed beside it),
H100 SXM data-sheet rates at 700 W, from this run's shapes (and, for K5,
this run's collapsed blocks; for K7, the rounds this run's fixed point
ran).

Exits non-zero at the first failed phase.  The last two lines of output
are the kernel record and ``{"ok": true, "device": {...}}``.

``--kernel-times`` builds the kernels of the checkout it sits in and
prints, as one JSON line, the device time of K1-K4 at the main path's
shapes, K4 at the streamed chunk, and the fixed point's K7 launches of
one ``_run_collapse`` (their sum and count): run in two checkouts in one
call, it compares two versions on one card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 44100
SECONDS = 180
L = 384
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
MB_SETTINGS = {**SETTINGS, "multiband": True}
NO_MB_KERNELS = ("front_chain", "kweight_cells")
MB_KERNELS = ("band_energies", "band_gain_apply", "pass1_bnd", "replay",
              "replay_bnd")
K5_LAUNCHES = ("pass1_hull", "pass1_runs")   # K5's two kernels
# the multiband kernels by the names of their launch counts
MB_COUNTED = ("band_energies", "band_gain_apply", *K5_LAUNCHES, "replay",
              "replay_bnd")
K5_PLAIN_STEPS = 65536
CHUNK_BLOCKS = 2940        # the streamed runner's chunk, 1 128 960 frames
K4_HOPS = (6, 192)         # h at 44.1 kHz (the chain's) and at 48 kHz
K7_LONG_T = 8388608        # steps a band: more than the grid's shared memory
FP32_FLOPS = 67e12    # H100 SXM, fp32 on the CUDA cores, dense
TF32_FLOPS = 495e12   # H100 SXM, TF32 on the tensor cores, dense
HBM_BYTES = 3.35e12   # H100 SXM, HBM3 bytes/s
_PMB = "python_audio_mastering_tpu/ops/pallas_multiband.py"
_PK = "python_audio_mastering_tpu/ops/pallas_kernels.py"
REPLACES = {
    "front_chain": f"{_PMB}:228",
    "kweight_cells": f"{_PMB}:312",
    "band_energies": f"{_PMB}:421",
    "band_gain_apply": f"{_PMB}:477",
    "pass1_bnd": f"{_PK}:152",
    "replay": f"{_PK}:184",
    "replay_bnd": f"{_PK}:217",
}
_CSRC = "python_audio_mastering_tpu_torch/csrc"
SOURCES = {
    "front_chain": f"{_CSRC}/front_chain.cu",
    "kweight_cells": f"{_CSRC}/kweight_cells.cu",
    "band_energies": f"{_CSRC}/band_energies.cu",
    "band_gain_apply": f"{_CSRC}/band_gain_apply.cu",
    "pass1_bnd": f"{_CSRC}/ballistics.cu",
    "replay": f"{_CSRC}/ballistics.cu",
    "replay_bnd": f"{_CSRC}/ballistics.cu",
}


class PhaseFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def make_signal(n, fs, seed):
    """Tonal mix + noise under a slow envelope (the tests' signal)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / fs
    base = (0.4 * np.sin(2 * np.pi * 55 * t)
            + 0.25 * np.sin(2 * np.pi * 440 * t + 0.3)
            + 0.15 * np.sin(2 * np.pi * 5200 * t + 1.1)
            + 0.1 * r.standard_normal(n))
    base = base * (0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)) ** 2)
    out = np.stack([base, np.roll(base, 17) * 0.9
                    + 0.05 * r.standard_normal(n)], axis=1)
    return (out * 0.5).astype(np.float32)


def cuda_ms(fn, reps=10):
    """Device milliseconds per call of ``fn`` over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def median_of(fn, runs=5):
    fn()                                   # warm
    torch.cuda.synchronize()
    return statistics.median(fn() for _ in range(runs))


def count_syncs(fn):
    """Run ``fn`` with PyTorch's sync debug mode on; returns ``(result,
    number of host synchronisations it reported)``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def compare(what, got, ref, limit, relative=True):
    """Print and check ``max |got - ref|`` (over ``max |ref|`` when
    ``relative``) against ``limit``; returns the max abs difference."""
    d = (got - ref).abs()
    mx = d.max().item()
    val = mx / ref.abs().max().item() if relative else mx
    print(f"  {what} {tuple(got.shape)}: max abs {mx:.3e}"
          + (f", / max |plain| {val:.3e}" if relative else ""))
    check(np.isfinite(val) and val <= limit, f"{what}: {val} > {limit}")
    return mx


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes, rate=FP32_FLOPS):
    """The least time the card could take: ``{"bound_ms", "bound_by"}``."""
    t_ops, t_bytes = flops / rate * 1e3, n_bytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def product_bounds(flops, n_bytes, tf32):
    """``(bound, bound on the fp32 cores)`` of a product kernel: the first
    at the 3xTF32 rate (three TF32 products a multiply-add) where
    ``tf32``, else the second."""
    fp32 = bound(flops, n_bytes)
    return (bound(3 * flops, n_bytes, TF32_FLOPS) if tf32 else fp32), fp32


def product_flops(rows, L, S, filters=1):
    """Operations of ``[x | s] @ [T ; Wt]`` per filter, T's zero triangle
    skipped (2 per multiply-add)."""
    return 2.0 * rows * filters * (L * (L + 1) / 2 + S * L)


def kweight_bounds(rows, L, S, n_bytes):
    """``(bound, bound on the fp32 cores)`` of K4: ``x @ T`` in 3xTF32 on
    the tensor cores and the states term ``s @ Wt`` on the fp32 cores,
    their times added; the second all on the fp32 cores."""
    x_ops, s_ops = 2.0 * rows * L * (L + 1) / 2, 2.0 * rows * S * L
    t_ops = (3 * x_ops / TF32_FLOPS + s_ops / FP32_FLOPS) * 1e3
    t_bytes = n_bytes / HBM_BYTES * 1e3
    return ({"bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"},
            bound(x_ops + s_ops, n_bytes))


def detector_targets(xb, params, hop, dev):
    """The multiband detector's per-step targets of the band energies
    ``xb`` as the chain forms them, padded to whole 128-step blocks, with
    the bands' rate factors and zero incoming states: ``(m, ca, cr,
    att0)``."""
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import multiband as mb

    t = xb.shape[1]
    stats, _ = mb._fused_stats_from_ctrl(
        xb, t, FS, (params.low_thresh, params.mid_thresh, params.high_thresh),
        (params.low_ratio, params.mid_ratio, params.high_ratio), hop, None,
        mb.detector_lookpad(FS, hop) // hop)
    # whole 128-step blocks (992256 = 7752 blocks at 180 s: no padding)
    m = torch.nn.functional.pad(stats["max_att"], (0, -t % bal.BLOCK))
    ca = torch.tensor([hop / max(a * FS / 1000.0, 1.0)
                       for a, _ in mb.BAND_BALLISTICS_MS], device=dev)
    cr = torch.tensor([hop / max(r * FS / 1000.0, 1.0)
                       for _, r in mb.BAND_BALLISTICS_MS], device=dev)
    return m.contiguous(), ca, cr, torch.zeros(3, device=dev)


def yardstick(a, b):
    """``library_ms``: one torch.matmul of the product's operands."""
    return median_of(lambda: cuda_ms(lambda: torch.matmul(a, b)))


def device_profile(fn, calls):
    """``fn`` run ``calls`` times (after a warm call) under torch.profiler
    (CUPTI): ``({device activity name: ms per call}, wall ms per call)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / calls)
    return by_name, wall


# kernel_ms' profiler windows: how many, and those that showed none of
# the kernels asked for (see PERF.md, open questions)
WINDOWS = {"profiled": 0, "empty": []}


def kernel_ms(fn, name, calls=10):
    """Device time per call of the port's kernels ``pam::<name>_kernel``
    (each name of a tuple) launched by ``fn``: the kernels alone, without
    the wrapper's host work or allocations."""
    names = (name,) if isinstance(name, str) else name
    # now and then the profiler hands back a window with no device
    # activity at all, twice in a row at worst so far (an open question):
    # such a window is printed and profiled again
    for attempt in range(5):
        by_name, _ = device_profile(fn, calls)
        WINDOWS["profiled"] += 1
        got = [v for k, v in by_name.items()
               if any(f"pam::{n}_kernel" in k for n in names)]
        if got:
            return sum(got)
        WINDOWS["empty"].append(names)
        print(f"  the profiler saw no kernel of {names} (try {attempt + 1}; "
              f"{len(by_name)} device activities: {sorted(by_name)})")
    raise PhaseFailed(f"the profiler saw no kernel of {names}")


def profile_calls(fn, calls=5, top=12):
    """Print the device time per call of ``fn``, its wall per call, the
    device's idle share of the wall and the ``top`` device activities."""
    by_name, wall = device_profile(fn, calls)
    device = sum(by_name.values())
    check(device > 0.0, "the profiler recorded no device time")
    print(f"    device {device:.3f} ms per call, wall {wall:.3f} ms per call "
          f"(profiler on), device idle {100.0 * (1 - device / wall):.1f} % "
          f"of the wall")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.4f} ms {100.0 * ms / device:5.1f} %  {name[:90]}")


def check_bitwise(what, got, ref):
    same = torch.equal(got, ref)
    n_diff = int((got != ref).sum()) if got.shape == ref.shape else -1
    print(f"  {what} {tuple(got.shape)}: bitwise equal {same}")
    check(same, f"{what}: not bitwise equal ({n_diff} elements differ)")


def setup_card():
    """Refuse without a GPU; turn TF32 off for torch's own products; print
    and return the card's name and power limit as nvidia-smi gives them."""
    check(torch.cuda.is_available(), "phase 0: torch.cuda.is_available() "
                                     "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card)
    sys.path.insert(0, ROOT)
    return card


def main_path_operands(dev):
    """The seeded track and what the main path gives its kernels, built as
    the chain builds them: the track ``x``, the chain, its rows, the EQ and
    K-weighting operators and states, K1's and K4's arguments (K4 also at
    the streamed chunk), the multiband compressor's input ``xf`` and the
    band kernels' arguments."""
    from types import SimpleNamespace

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        MasteringParams,
    )
    from python_audio_mastering_tpu_torch.ops import iir
    from python_audio_mastering_tpu_torch.ops import multiband as mb
    from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

    x = make_signal(SECONDS * FS, FS, seed=0)            # (N, 2)
    nb = -(-x.shape[0] // L)
    params = MasteringParams.from_settings(SETTINGS)
    mb_params = MasteringParams.from_settings(MB_SETTINGS)
    chain = MasteringChain(ChainConfig.gpu_default(FS)).to(dev)
    xrows = torch.nn.functional.pad(torch.from_numpy(x.T.copy()).to(dev),
                                    (0, nb * L - x.shape[0])).reshape(2, nb, L)
    eq = chain.eq_ops(params)
    s_eq, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=eq)
    mono = xrows.mean(dim=0, keepdim=True).contiguous()
    kw = chain.kweight_ops()
    s_kw, _, _ = iir.sosfilt_states_rows(None, mono, ops=kw)
    xf = chain.front(xrows, mb_params)
    sos = mb._crossover_sos(FS, 250.0, 4000.0)
    (s_lp, s_hp), _ = iir.sosfilt_states_multi_rows(
        sos, xf, ops_list=chain.crossover_ops())
    return SimpleNamespace(
        x=x, nb=nb, params=params, mb_params=mb_params, chain=chain,
        hop=chain.config.comp_hop, xrows=xrows, eq=eq, s_eq=s_eq, mono=mono,
        kw=kw, s_kw=s_kw,
        k1_args=(xrows, s_eq, eq.t, eq.w, params.saturation, params.width),
        k4_chunk=tuple(v[:, :CHUNK_BLOCKS].contiguous()
                       for v in (mono, s_kw)),
        xf=xf, sos=sos, s_lp=s_lp, s_hp=s_hp,
        band_args=(xf, s_lp, s_hp, *sos))


def kernel_times():
    """``--kernel-times`` (see the module docstring)."""
    setup_card()
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    o = main_path_operands(torch.device("cuda"))
    kw, h, hop = o.kw, K4_HOPS[0], o.hop
    xb = cmb.band_energies(*o.band_args, hop=hop)
    m, ca, cr, att0 = detector_targets(xb, o.mb_params, hop, xb.device)
    cols = torch.ones((3, xb.shape[1]), device=xb.device)
    times = {
        "front_chain": kernel_ms(lambda: cmb.front_chain(*o.k1_args, True),
                                 "front_chain"),
        "kweight_cells": kernel_ms(lambda: cmb.kweight_cells(
            o.mono, o.s_kw, kw.t, kw.w, h), "kweight_cells"),
        "kweight_cells_chunk": kernel_ms(lambda: cmb.kweight_cells(
            *o.k4_chunk, kw.t, kw.w, h), "kweight_cells"),
        "band_energies": kernel_ms(lambda: cmb.band_energies(
            *o.band_args, hop=hop), "band_energies"),
        "band_gain_apply": kernel_ms(lambda: cmb.band_gain_apply(
            *o.band_args[:3], cols, *o.sos, hop=hop, emit_mono=True),
            "band_gain_apply"),
        "replay_bnd_fixed_point": kernel_ms(
            lambda: bal._run_collapse(m, ca, cr, att0), "replay_bnd"),
    }
    cmb.reset_launch_counts()
    _, ctrl = bal._run_collapse(m, ca, cr, att0)
    torch.cuda.synchronize()
    print(json.dumps({"kernel_times_ms": times,
                      "replay_bnd_launches":
                          cmb.launch_counts()["replay_bnd"],
                      "fixed_point_ctrl": ctrl.tolist(), "checkout": ROOT}))
    return 0


def main():
    # phase 0 ---------------------------------------------------------------
    setup_card()
    print(f"phase 0 ok: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        MasteringChain,
        engine,
        master,
    )
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        master_streamed,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import _kernels
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import loudness as loud

    dev = torch.device("cuda")

    # phase 1 ---------------------------------------------------------------
    t0 = time.perf_counter()
    kl = _kernels.library()
    print(f"phase 1 ok: built {kl.path.name} in {kl.build_seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in kl.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    o = main_path_operands(dev)
    x, nb, params, chain = o.x, o.nb, o.params, o.chain
    cfg = chain.config
    xrows, eq, s_eq, k1_args = o.xrows, o.eq, o.s_eq, o.k1_args
    kernels = {}

    # phase 2 ---------------------------------------------------------------
    err = 0.0
    for emit in (False, True):
        got = cmb.front_chain(*k1_args, emit_mono=emit)
        ref = cmb.front_chain_ref(*k1_args, emit_mono=emit)
        torch.cuda.synchronize()
        for what, g, r in zip(("y", "mono"), got if emit else (got,),
                              ref if emit else (ref,)):
            d = (g - r).abs()
            mx, rms = d.max().item(), d.pow(2).mean().sqrt().item()
            print(f"phase 2 front_chain emit_mono={emit} {what} "
                  f"{tuple(g.shape)}: max abs {mx:.3e} rms {rms:.3e}")
            check(np.isfinite(mx) and mx <= 1e-4,
                  f"front_chain max abs {mx} > 1e-4")
            err = max(err, mx)
    kernels["front_chain"] = {"max_abs_err": err}
    print("phase 2 ok", flush=True)

    # phase 3 ---------------------------------------------------------------
    mono, kw, s_kw = o.mono, o.kw, o.s_kw
    h = int(np.gcd(loud._gating_geometry(FS)[0], L))
    check(h == K4_HOPS[0], f"the chain's bucket is {h}, not {K4_HOPS[0]}")
    k4_args = (mono, s_kw, kw.t, kw.w, h)
    err = 0.0
    for hh in K4_HOPS:
        err = max(err, compare(f"phase 3 kweight_cells h={hh}",
                               cmb.kweight_cells(*k4_args[:4], hh),
                               cmb.kweight_cells_ref(*k4_args[:4], hh), 1e-4))
    kernels["kweight_cells"] = {"max_abs_err": err}
    print("phase 3 ok", flush=True)

    # phase 4 ---------------------------------------------------------------
    cmb.reset_launch_counts()
    res = master(x, params, cfg, return_result=True)   # no device argument
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    check(res.audio.device.type == "cuda",
          f"master() without a device ran on {res.audio.device}")
    y = res.audio.cpu().numpy()
    check(y.shape == x.shape, f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    peak = float(np.abs(y).max())
    check(peak <= 1.0, f"|y| max {peak} > 1")
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    print(f"phase 4 master() (no device argument, output on "
          f"{res.audio.device}): shape {y.shape} peak {peak:.4f} measured "
          f"{float(res.measured_lufs):.4f} LUFS gain "
          f"{float(res.applied_gain_db):.4f} dB; oracle output loudness "
          f"{lufs_out:.4f} LUFS; launches {counts}")
    check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"output loudness {lufs_out} not within 0.15 LU of -14")
    for name in NO_MB_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched by master()")
        kernels[name]["launches"] = counts[name]
    cpu = MasteringChain(cfg)(x, params, return_result=True)
    d_cpu = float(np.abs(y - cpu.audio.numpy()).max())
    d_lufs = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 4 card vs CPU plain path: max abs {d_cpu:.3e}, "
          f"|dLUFS| {d_lufs:.3e}")
    check(d_cpu < 2e-4, f"card vs CPU max abs {d_cpu} >= 2e-4")
    check(d_lufs < 1e-3, f"card vs CPU |dLUFS| {d_lufs} >= 1e-3")
    print("phase 4 ok", flush=True)

    # phase 5 ---------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        wavio.write_wav(src, x, FS, float_format=True)
        msgs = []
        job = {**SETTINGS, "input_file": src, "output_file": dst}
        cmb.reset_launch_counts()
        ok = engine.process_audio(job, msgs.append)   # no device argument
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        streamed_counts = cmb.launch_counts()
        out, fs_out = wavio.read_wav(dst)
        d_eng = float(np.abs(out - y).max())
        print(f"phase 5 process_audio (no device argument): {msgs[-1]!r}; "
              f"launches {streamed_counts}; max abs vs master() "
              f"{d_eng:.3e}")
        check(fs_out == FS and out.shape == x.shape, "process_audio output")
        check(all(streamed_counts[k] > 0 for k in NO_MB_KERNELS),
              "process_audio did not launch every kernel")
        check(d_eng < 2e-4, f"process_audio vs master() {d_eng} >= 2e-4")
        cmb.reset_launch_counts()
        out_s, _, _ = master_streamed(x, params, cfg)   # no device argument
        counts_s = cmb.launch_counts()
        d_str = float(np.abs(out_s - y).max())
        print(f"phase 5 master_streamed (no device argument): launches "
              f"{counts_s}; max abs vs master() {d_str:.3e}")
        check(all(counts_s[k] > 0 for k in NO_MB_KERNELS),
              "master_streamed without a device did not run on the card")
        check(d_str < 2e-4, f"master_streamed vs master() {d_str} >= 2e-4")
        print("phase 5 ok", flush=True)

        # phase 6 -----------------------------------------------------------
        x_dev = torch.from_numpy(x).to(dev)

        def master_ms():
            return cuda_ms(lambda: chain(x_dev, params), reps=1)

        def engine_s():
            t0 = time.perf_counter()
            engine.process_audio(job)
            return time.perf_counter() - t0

        t_master = median_of(master_ms)
        t_engine = median_of(engine_s)
        print(f"phase 6 master() {t_master:.3f} ms for {SECONDS} s "
              f"(x{SECONDS * 1e3 / t_master:.0f} realtime, input on the "
              f"card); process_audio wall {t_engine:.3f} s (WAV read, "
              f"upload, chain, readback, WAV write)")
    s_k1, s_k4 = s_eq.shape[2], s_kw.shape[2]
    shapes = {
        "front_chain": (
            cmb.front_chain, cmb.front_chain_ref, k1_args + (True,),
            (xrows, s_eq, eq.t, eq.w.T.contiguous()),
            product_bounds(product_flops(2 * nb, L, s_k1),
                           nbytes(xrows, s_eq, eq.t, eq.w) + nbytes(xrows)
                           + 4 * nb * L, tf32=True)),
        "kweight_cells": (
            cmb.kweight_cells, cmb.kweight_cells_ref, k4_args,
            (mono, s_kw, kw.t, kw.w.T.contiguous()),
            kweight_bounds(nb, L, s_k4, nbytes(mono, s_kw, kw.t, kw.w)
                           + 4 * nb * (L // h)))}
    for name, (kern, plain, args, (rows, st, t_op, wt), (bnd_, fp32_)) in \
            shapes.items():
        ms = kernel_ms(lambda: kern(*args), name)
        plain_ms = median_of(lambda: cuda_ms(lambda: plain(*args)))
        lib_ms = yardstick(
            torch.cat([rows.reshape(-1, L), st.reshape(-1, st.shape[2])], 1),
            torch.cat([t_op, wt], 0))
        kernels[name].update(ms=ms, plain_ms=plain_ms, **bnd_,
                             library_ms=lib_ms)
        print(f"phase 6 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (torch.matmul, product only) {lib_ms:.4f} ms, bound "
              f"{bnd_['bound_ms']:.4f} ms ({bnd_['bound_by']}; on the fp32 "
              f"cores {fp32_['bound_ms']:.4f} ms)")
    chunk = o.k4_chunk
    k4_chunk = kernel_ms(lambda: cmb.kweight_cells(*chunk, kw.t, kw.w, h),
                         "kweight_cells")
    c_bnd, _ = kweight_bounds(CHUNK_BLOCKS, L, s_k4,
                              nbytes(*chunk, kw.t, kw.w)
                              + 4 * CHUNK_BLOCKS * (L // h))
    print(f"phase 6 kweight_cells at the streamed chunk {tuple(chunk[0].shape)}"
          f": kernel {k4_chunk:.4f} ms, bound {c_bnd['bound_ms']:.4f} ms "
          f"({c_bnd['bound_by']})")
    print("phase 6 ok", flush=True)

    multiband_phases(o, kernels)

    record = [{"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], **kernels[name]}
              for name in NO_MB_KERNELS + MB_KERNELS]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multiband_phases(o, kernels):
    """Phases 7-13: the multiband chain on the same track (``o`` from
    :func:`main_path_operands`)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import MasteringChain, MasteringParams
    from python_audio_mastering_tpu_torch import engine
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import ballistics as bal
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb

    x, chain, params, hop, nb = o.x, o.chain, o.mb_params, o.hop, o.nb
    cfg = chain.config
    dev = o.xrows.device
    xf, sos, s_lp, s_hp = o.xf, o.sos, o.s_lp, o.s_hp
    band_args = o.band_args
    for name in MB_KERNELS:
        kernels[name] = {}

    # phase 7 ---------------------------------------------------------------
    # the chain's hop, then hop 3, whose buckets cross the 64-column tiles
    err = 0.0
    for h in (hop, 3):
        got = cmb.band_energies(*band_args, hop=h)
        err = max(err, compare(f"phase 7 band_energies hop={h}", got,
                               cmb.band_energies_ref(*band_args, hop=h),
                               1e-4))
        if h == hop:
            xb = got
    kernels["band_energies"]["max_abs_err"] = err
    print("phase 7 ok", flush=True)

    # the track's own detector targets and the gain columns
    t = xb.shape[1]
    m, ca, cr, att0 = detector_targets(xb, params, hop, dev)
    att, _ = bal.ballistics_rates_bt(m, ca, cr, att0)
    g = 10.0 ** (-att[:, :t] / 20.0)
    cols = torch.stack([g[1], g[0] - g[1], g[2] - g[1]]).contiguous()

    # phase 8 ---------------------------------------------------------------
    err = 0.0
    for emit in (False, True):
        got = cmb.band_gain_apply(*band_args[:3], cols, *sos, hop=hop,
                                  emit_mono=emit)
        ref = cmb.band_gain_apply_ref(*band_args[:3], cols, *sos, hop=hop,
                                      emit_mono=emit)
        for what, gg, rr in zip(("y", "mono"), got if emit else (got,),
                                ref if emit else (ref,)):
            err = max(err, compare(f"phase 8 band_gain_apply emit_mono={emit}"
                                   f" {what}", gg, rr, 1e-4))
    kernels["band_gain_apply"]["max_abs_err"] = err
    print("phase 8 ok", flush=True)

    # phase 9 ---------------------------------------------------------------
    print(f"phase 9 targets {tuple(m.shape)}: {int((m > 0).sum())} steps "
          f"above threshold")
    hmax = torch.maximum(att0, m.amax(dim=1)).contiguous()
    lo, hi = bal.pass1_hull(m, ca, cr, hmax)
    lo_p, hi_p = bal.pass1_hull_ref(m, ca, cr, hmax)
    check_bitwise("phase 9 K5 pass1_hull lo", lo, lo_p)
    check_bitwise("phase 9 K5 pass1_hull hi", hi, hi_p)
    check_bitwise("phase 9 K5 pass1_runs",
                  bal.pass1_runs(m, ca, cr, att0, lo, hi),
                  bal.pass1_runs_ref(m, ca, cr, att0, lo, hi))
    nblk = lo.shape[1]
    hull_stats = bal.hull_runs(lo, hi)
    for band, (n_coll, n_runs, longest) in zip(("low", "mid", "high"),
                                               hull_stats):
        print(f"phase 9 K5 hull, {band} band: {n_coll} of {nblk} blocks "
              f"collapsed ({100.0 * n_coll / nblk:.1f} %), {n_runs} runs of "
              f"non-collapsed blocks, the longest {longest} blocks "
              f"({longest * bal.BLOCK} steps)")
    walked = sum(nblk - n for n, _, _ in hull_stats)
    bnd = bal.pass1_bnd(m, ca, cr, att0)
    check_bitwise("phase 9 K5 pass1_bnd vs its plain twin (full T)", bnd,
                  bal.pass1_runs_ref(m, ca, cr, att0, lo_p, hi_p))
    cut = m[:, :K5_PLAIN_STEPS].contiguous()
    check_bitwise(f"phase 9 K5 pass1_bnd vs the serial walk pass1_bnd_ref "
                  f"(first {K5_PLAIN_STEPS} steps)",
                  bal.pass1_bnd(cut, ca, cr, att0),
                  bal.pass1_bnd_ref(cut, ca, cr, att0))
    kernels["pass1_bnd"]["max_abs_err"] = 0.0
    incomes = torch.cat([att0[:, None], bnd[:, :-1]], dim=1).contiguous()
    check_bitwise("phase 9 replay", bal.replay(m, ca, cr, incomes),
                  bal.replay_ref(m, ca, cr, incomes))
    kernels["replay"]["max_abs_err"] = 0.0
    idx = bal._frozen_index(m)
    s = torch.zeros_like(bnd)
    ck, cp = bal.new_ctrl(dev), bal.new_ctrl(dev)
    for k in range(bal.FIXPOINT_ITERS):
        s_k = bal.replay_bnd(m, ca, cr, att0, idx, s, ck)
        s_p = bal.replay_bnd_ref(m, ca, cr, att0, idx, s, cp)
        check_bitwise(f"phase 9 replay_bnd round {k + 1}", s_k, s_p)
        check(torch.equal(ck, cp), f"replay_bnd ctrl {ck.tolist()} != "
                                   f"plain {cp.tolist()}")
        s = s_k
    # every round in one launch, against the plain loop of one-round calls:
    # the track's targets (held in the grid's shared memory), then a
    # bursty timeline of 3 x 65 536 blocks, more than the ~59 000 blocks
    # that the H100's shared memory holds, whose rounds read m from device
    # memory
    gen = torch.Generator(device=dev).manual_seed(5)
    m_long = (torch.rand((3, K7_LONG_T), generator=gen, device=dev) * 12.0
              * (torch.rand(K7_LONG_T, generator=gen, device=dev) < 0.5))
    m_long[:, K7_LONG_T // 3: K7_LONG_T // 2] = 0.0   # read through
    for what, mm in (("the track's targets", m), ("a long timeline", m_long)):
        idx_m = bal._frozen_index(mm)
        s0 = torch.zeros((3, mm.shape[1] // bal.BLOCK), device=dev)
        ck, cp = bal.new_ctrl(dev), bal.new_ctrl(dev)
        check_bitwise(f"phase 9 replay_bnd, {bal.FIXPOINT_ITERS} rounds in one "
                      f"launch, {what}",
                      bal.replay_bnd(mm, ca, cr, att0, idx_m, s0, ck,
                                     rounds=bal.FIXPOINT_ITERS),
                      bal.replay_bnd_ref(mm, ca, cr, att0, idx_m, s0, cp,
                                         rounds=bal.FIXPOINT_ITERS))
        check(torch.equal(ck, cp), f"replay_bnd ctrl {ck.tolist()} != "
                                   f"plain {cp.tolist()}")
        print(f"phase 9 replay_bnd, {what}: ctrl {ck.tolist()}")
    del m_long
    kernels["replay_bnd"]["max_abs_err"] = 0.0
    collapse, ctrl = bal._run_collapse(m, ca, cr, att0)
    rounds, certified = int(ctrl[bal.ROUND]), int(ctrl[bal.CNT]) == 0
    print(f"phase 9 fixed point: {rounds} rounds, certified {certified} "
          f"(ctrl {ctrl.tolist()})")
    check_bitwise("phase 9 serial == collapse", bal._run(m, ca, cr, att0),
                  collapse)
    forced, fctrl = bal._run_collapse(m, ca, cr, att0, iters=1)
    check_bitwise(f"phase 9 forced fallback (iters=1, certified "
                  f"{int(fctrl[bal.CNT]) == 0}) == collapse", forced,
                  collapse)
    print("phase 9 ok", flush=True)

    # phase 10 --------------------------------------------------------------
    x_dev = torch.from_numpy(x).to(dev)
    chain(x_dev, params)                       # first call builds operators
    cmb.reset_launch_counts()
    res, syncs = count_syncs(lambda: chain(x_dev, params, return_result=True))
    counts = cmb.launch_counts()
    y = res.audio.cpu().numpy()
    check(y.shape == x.shape, f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    peak = float(np.abs(y).max())
    check(peak <= 1.0, f"|y| max {peak} > 1")
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    print(f"phase 10 multiband master(): shape {y.shape} peak {peak:.4f} "
          f"measured {float(res.measured_lufs):.4f} LUFS gain "
          f"{float(res.applied_gain_db):.4f} dB; oracle output loudness "
          f"{lufs_out:.4f} LUFS; launches {counts}; host synchronisations "
          f"{syncs}")
    check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"output loudness {lufs_out} not within 0.15 LU of -14")
    for name in NO_MB_KERNELS + MB_COUNTED:
        check(counts[name] > 0, f"kernel {name} was not launched by the "
                                f"multiband master()")
    check(counts["replay_bnd"] == 1, f"replay_bnd launched "
                                     f"{counts['replay_bnd']} times, not once")
    launched = {**counts, "pass1_bnd": sum(counts[k] for k in K5_LAUNCHES)}
    for name in MB_KERNELS:
        kernels[name]["launches"] = launched[name]
    kernels["pass1_bnd"]["launches_by_kernel"] = {k: counts[k]
                                                  for k in K5_LAUNCHES}
    t0 = time.perf_counter()
    cpu = MasteringChain(cfg)(x, params, return_result=True)
    d = np.abs(y - cpu.audio.numpy())
    d_max, d_rms = float(d.max()), float(np.sqrt(np.mean(d ** 2)))
    d_lufs = abs(float(res.measured_lufs) - float(cpu.measured_lufs))
    print(f"phase 10 card vs CPU plain path ({time.perf_counter() - t0:.1f} s"
          f" on the CPU): max abs {d_max:.3e}, rms {d_rms:.3e}, |dLUFS| "
          f"{d_lufs:.3e}; elements over 2e-4: {int((d > 2e-4).sum())}")
    check(d_max < 5e-3, f"card vs CPU max abs {d_max} >= 5e-3")
    check(d_rms < 5e-5, f"card vs CPU rms {d_rms} >= 5e-5")
    check(d_lufs < 1e-3, f"card vs CPU |dLUFS| {d_lufs} >= 1e-3")
    print("phase 10 ok", flush=True)

    # phase 11 --------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        wavio.write_wav(src, x, FS, float_format=True)
        msgs = []
        job = {**MB_SETTINGS, "input_file": src, "output_file": dst}
        cmb.reset_launch_counts()
        ok = engine.process_audio(job, msgs.append)   # no device argument
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        streamed_counts = cmb.launch_counts()
        out, fs_out = wavio.read_wav(dst)
        d_eng = float(np.abs(out - y).max())
        print(f"phase 11 multiband process_audio (no device argument): "
              f"{msgs[-1]!r}; launches {streamed_counts}; max abs vs "
              f"master() {d_eng:.3e}")
        check(fs_out == FS and out.shape == x.shape, "process_audio output")
        check(all(streamed_counts[k] > 0 for k in NO_MB_KERNELS + MB_COUNTED),
              "process_audio did not launch every kernel")
        check(d_eng < 2e-4, f"process_audio vs master() {d_eng} >= 2e-4")
        print("phase 11 ok", flush=True)

        # phase 12 ----------------------------------------------------------
        def engine_s():
            t0 = time.perf_counter()
            engine.process_audio(job)
            return time.perf_counter() - t0

        t_master = median_of(lambda: cuda_ms(lambda: chain(x_dev, params),
                                             reps=1))
        t_engine = median_of(engine_s)
    print(f"phase 12 multiband master() {t_master:.3f} ms for {SECONDS} s "
          f"(x{SECONDS * 1e3 / t_master:.0f} realtime, input on the card); "
          f"process_audio wall {t_engine:.3f} s; fixed point {rounds} "
          f"rounds, {syncs} host synchronisations per master()")
    for mode in ("serial", "collapse", "serial", "collapse"):
        t_mode = median_of(lambda: cuda_ms(
            lambda: bal.ballistics_rates_bt(m, ca, cr, att0, mode=mode)))
        print(f"phase 12 ballistics_rates_bt mode={mode} at full T: "
              f"{t_mode:.4f} ms")
    ctrl0 = bal.new_ctrl(dev)
    zero = torch.zeros_like(bnd)
    xrows_b, s_lp_b, s_hp_b = (v.reshape(-1, v.shape[2])
                               for v in band_args[:3])
    t2, wt2 = cmb.crossover_operands(*sos, L, dev)
    zeros = torch.zeros_like(wt2[0])
    band_a = torch.cat([xrows_b, s_lp_b, s_hp_b], 1)
    band_b = torch.cat([torch.cat([t2[0], t2[1]], 1),
                        torch.cat([wt2[0], zeros], 1),
                        torch.cat([zeros, wt2[1]], 1)], 0)
    s_x = s_lp.shape[2]
    rows_b = xrows_b.shape[0]
    band_flops = product_flops(rows_b, L, s_x, filters=2)
    band_in = nbytes(xf, s_lp, s_hp, t2, wt2)
    b_, t_ = m.shape
    step_flops = 4.0 * b_ * t_
    # K2 and K3 run three TF32 products per multiply-add on the tensor cores
    k2_bnd, k2_fp32 = product_bounds(band_flops, band_in + nbytes(xb),
                                     tf32=True)
    k3_bnd, k3_fp32 = product_bounds(band_flops, band_in + nbytes(cols, xf)
                                     + 4 * nb * L, tf32=True)
    fp32_bound = {"band_energies": k2_fp32, "band_gain_apply": k3_fp32}
    timed = {
        "band_energies": (
            lambda: cmb.band_energies(*band_args, hop=hop),
            lambda: cmb.band_energies_ref(*band_args, hop=hop),
            k2_bnd, True),
        "band_gain_apply": (
            lambda: cmb.band_gain_apply(*band_args[:3], cols, *sos, hop=hop,
                                        emit_mono=True),
            lambda: cmb.band_gain_apply_ref(*band_args[:3], cols, *sos,
                                            hop=hop, emit_mono=True),
            k3_bnd, True),
        # K5's two launches; operations: two steps per step of the hull
        # pass, one per step of the walked blocks
        "pass1_bnd": (
            lambda: bal.pass1_runs(m, ca, cr, att0,
                                   *bal.pass1_hull(m, ca, cr, hmax)),
            lambda: bal.pass1_runs_ref(m, ca, cr, att0,
                                       *bal.pass1_hull_ref(m, ca, cr, hmax)),
            bound(2 * step_flops + 4.0 * walked * bal.BLOCK,
                  nbytes(m, ca, cr, att0, bnd)), False),
        "replay": (
            lambda: bal.replay(m, ca, cr, incomes),
            lambda: bal.replay_ref(m, ca, cr, incomes),
            bound(step_flops, nbytes(m, ca, cr, incomes, m)), False),
        # the whole fixed point, one launch from a fresh (active) ctrl;
        # bytes: m read once, and each round run reads a block's income
        # index and state and writes its state (16 bytes)
        "replay_bnd": (
            lambda: bal.replay_bnd(m, ca, cr, att0, idx, zero, ctrl0.clone(),
                                   rounds=bal.FIXPOINT_ITERS),
            lambda: bal.replay_bnd_ref(m, ca, cr, att0, idx, zero,
                                       ctrl0.clone(),
                                       rounds=bal.FIXPOINT_ITERS),
            bound(step_flops * rounds, nbytes(m, ca, cr, att0, ctrl0)
                  + 16 * rounds * zero.numel()), False),
    }
    for name, (kern, plain, bnd_, product) in timed.items():
        ms = kernel_ms(kern, K5_LAUNCHES if name == "pass1_bnd" else name)
        plain_ms = median_of(lambda: cuda_ms(plain, reps=1))
        lib_ms = yardstick(band_a, band_b) if product else None
        kernels[name].update(ms=ms, plain_ms=plain_ms, **bnd_,
                             library_ms=lib_ms)
        print(f"phase 12 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              + (f", library (torch.matmul, product only) {lib_ms:.4f} ms"
                 if product else ", library none")
              + f", bound {bnd_['bound_ms']:.4f} ms ({bnd_['bound_by']}"
              + (f"; on the fp32 cores {fp32_bound[name]['bound_ms']:.4f} ms"
                 if name in fp32_bound else "") + ")")
    k2_h3 = kernel_ms(lambda: cmb.band_energies(*band_args, hop=3),
                      "band_energies")
    print(f"phase 12 band_energies hop=3 alone: {k2_h3:.4f} ms")
    for name, fn in (("pass1_hull", lambda: bal.pass1_hull(m, ca, cr, hmax)),
                     ("pass1_runs", lambda: bal.pass1_runs(m, ca, cr, att0,
                                                           lo, hi))):
        print(f"phase 12 K5 {name} alone: {kernel_ms(fn, name):.4f} ms")
    k7_one = kernel_ms(lambda: bal.replay_bnd(m, ca, cr, att0, idx, zero,
                                              ctrl0.clone()), "replay_bnd")
    print(f"phase 12 replay_bnd: the fixed point's {rounds} rounds in one "
          f"launch {kernels['replay_bnd']['ms']:.4f} ms; one round alone "
          f"{k7_one:.4f} ms")
    print("phase 12 ok", flush=True)

    # phase 13 --------------------------------------------------------------
    no_mb = MasteringParams.from_settings(SETTINGS)
    for what, p in (("multiband on", params), ("multiband off", no_mb)):
        print(f"phase 13 profile of master(), {what}, 180 s, input on the "
              f"card:")
        profile_calls(lambda: chain(x_dev, p))
    for mode in ("serial", "collapse"):
        print(f"phase 13 profile of ballistics_rates_bt mode={mode}, the "
              f"track's targets {tuple(m.shape)}:")
        profile_calls(lambda: bal.ballistics_rates_bt(m, ca, cr, att0,
                                                      mode=mode), top=6)
    print(f"phase 13 kernel timings: {WINDOWS['profiled']} profiler windows, "
          f"{len(WINDOWS['empty'])} without the kernel {WINDOWS['empty']}")
    print("phase 13 ok", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(kernel_times() if sys.argv[1:] == ["--kernel-times"]
                 else main())
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
