"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``python_audio_mastering_tpu_torch``, never jax) through
its two entry points on a seeded 180 s 44.1 kHz stereo track with the
bench settings minus multiband, after building its CUDA kernels from the
sources in the checkout and checking each against its plain PyTorch
version at the shapes the chain gives it.  Phases:

  0  device, torch/CUDA versions, TF32 flags (refuses without a GPU)
  1  build the kernels (nvcc, sm_90a)
  2  front_chain kernel vs plain, (2, 20672, 384), emit_mono off and on:
     max abs <= 1e-4
  3  kweight_cells kernel vs plain, (1, 20672, 384):
     max |diff| / max |plain| <= 1e-4
  4  master() on the card: finite, |y| <= 1, BS.1770 oracle loudness
     within 0.15 LU of -14, both kernels launched, and within 2e-4 max
     abs / 1e-3 LU of the port's plain path on the CPU
  5  engine.process_audio on a temp WAV: equals one-shot master() within
     2e-4
  6  timings (CUDA events, warm, median of 5)

Exits non-zero at the first failed phase.  The last two lines of output
are the kernel record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 44100
SECONDS = 180
L = 384
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
REPLACES = {
    "front_chain": "python_audio_mastering_tpu/ops/pallas_multiband.py:228",
    "kweight_cells": "python_audio_mastering_tpu/ops/pallas_multiband.py:312",
}
SOURCES = {
    "front_chain": "python_audio_mastering_tpu_torch/csrc/front_chain.cu",
    "kweight_cells": "python_audio_mastering_tpu_torch/csrc/kweight_cells.cu",
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


def main():
    # phase 0 ---------------------------------------------------------------
    if not torch.cuda.is_available():
        print("phase 0 FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card)
    print(f"phase 0 ok: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.bs1770_ref import integrated_loudness as oracle_lufs

    from python_audio_mastering_tpu_torch import (
        ChainConfig,
        MasteringChain,
        MasteringParams,
        engine,
    )
    from python_audio_mastering_tpu_torch.io import wavio
    from python_audio_mastering_tpu_torch.ops import _kernels, iir
    from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
    from python_audio_mastering_tpu_torch.ops import loudness as loud
    from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

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

    x = make_signal(SECONDS * FS, FS, seed=0)            # (N, 2)
    n = x.shape[0]
    nb = -(-n // L)
    params = MasteringParams.from_settings(SETTINGS)
    cfg = ChainConfig.gpu_default(FS)
    chain = MasteringChain(cfg).to(dev)
    xrows = torch.nn.functional.pad(torch.from_numpy(x.T.copy()).to(dev),
                                    (0, nb * L - n)).reshape(2, nb, L)
    kernels = {}

    # phase 2 ---------------------------------------------------------------
    eq = chain.eq_ops(params)
    s_eq, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=eq)
    k1_args = (xrows, s_eq, eq.t, eq.w, params.saturation, params.width)
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
    mono = xrows.mean(dim=0, keepdim=True).contiguous()
    kw = chain.kweight_ops()
    s_kw, _, _ = iir.sosfilt_states_rows(None, mono, ops=kw)
    h = int(np.gcd(loud._gating_geometry(FS)[0], L))
    k4_args = (mono, s_kw, kw.t, kw.w, h)
    got = cmb.kweight_cells(*k4_args)
    ref = cmb.kweight_cells_ref(*k4_args)
    torch.cuda.synchronize()
    d = (got - ref).abs().max().item()
    rel = d / ref.abs().max().item()
    print(f"phase 3 kweight_cells {tuple(mono.shape)} h={h}: max abs "
          f"{d:.3e}, max abs / max |plain| {rel:.3e}")
    check(np.isfinite(rel) and rel <= 1e-4, f"kweight_cells rel {rel} > 1e-4")
    kernels["kweight_cells"] = {"max_abs_err": d}
    print("phase 3 ok", flush=True)

    # phase 4 ---------------------------------------------------------------
    cmb.reset_launch_counts()
    res = chain(x, params, return_result=True)
    torch.cuda.synchronize()
    counts = cmb.launch_counts()
    y = res.audio.cpu().numpy()
    check(y.shape == x.shape, f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    peak = float(np.abs(y).max())
    check(peak <= 1.0, f"|y| max {peak} > 1")
    lufs_out = oracle_lufs(y.astype(np.float64).mean(axis=1), FS)
    print(f"phase 4 master(): shape {y.shape} peak {peak:.4f} measured "
          f"{float(res.measured_lufs):.4f} LUFS gain "
          f"{float(res.applied_gain_db):.4f} dB; oracle output loudness "
          f"{lufs_out:.4f} LUFS; launches {counts}")
    check(abs(lufs_out - SETTINGS["lufs"]) <= 0.15,
          f"output loudness {lufs_out} not within 0.15 LU of -14")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by master()")
        kernels[name]["launches"] = cnt
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
        ok = engine.process_audio(job, msgs.append, device=dev)
        check(ok, f"process_audio failed: {msgs[-1] if msgs else ''}")
        streamed_counts = cmb.launch_counts()
        out, fs_out = wavio.read_wav(dst)
        d_eng = float(np.abs(out - y).max())
        print(f"phase 5 process_audio: {msgs[-1]!r}; launches "
              f"{streamed_counts}; max abs vs master() {d_eng:.3e}")
        check(fs_out == FS and out.shape == x.shape, "process_audio output")
        check(all(c > 0 for c in streamed_counts.values()),
              "process_audio did not launch every kernel")
        check(d_eng < 2e-4, f"process_audio vs master() {d_eng} >= 2e-4")
        print("phase 5 ok", flush=True)

        # phase 6 -----------------------------------------------------------
        x_dev = torch.from_numpy(x).to(dev)

        def master_ms():
            return cuda_ms(lambda: chain(x_dev, params), reps=1)

        def engine_s():
            t0 = time.perf_counter()
            engine.process_audio(job, device=dev)
            return time.perf_counter() - t0

        t_master = median_of(master_ms)
        t_engine = median_of(engine_s)
        print(f"phase 6 master() {t_master:.3f} ms for {SECONDS} s "
              f"(x{SECONDS * 1e3 / t_master:.0f} realtime, input on the "
              f"card); process_audio wall {t_engine:.3f} s (WAV read, "
              f"upload, chain, readback, WAV write)")
    shapes = {"front_chain": (cmb.front_chain, cmb.front_chain_ref,
                              k1_args + (True,)),
              "kweight_cells": (cmb.kweight_cells, cmb.kweight_cells_ref,
                                k4_args)}
    for name, (kern, plain, args) in shapes.items():
        ms = median_of(lambda: cuda_ms(lambda: kern(*args)))
        plain_ms = median_of(lambda: cuda_ms(lambda: plain(*args)))
        kernels[name].update(ms=ms, plain_ms=plain_ms)
        print(f"phase 6 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print("phase 6 ok", flush=True)

    record = [{"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], **kernels[name]}
              for name in ("front_chain", "kweight_cells")]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
