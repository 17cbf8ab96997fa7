"""The tail kernel K9 (``gain_limit``) on the card at an album's shape: its
compiler report, its time against its bound and against the plain ops it
replaces, and bit-for-bit agreement with them.

    python3 scripts/k9_probe.py [--tracks 12] [--seconds 420] [--reps 20]

Builds the port's kernels from this checkout; prints ptxas's report
(registers, spills) for ``csrc/gain_limit.cu``; makes an album's rows
``(2, T, nb·384)`` float32 on the card (T tracks padded to ``--seconds`` at
44.1 kHz, hot enough that a quarter of the samples cross the threshold,
T distinct gains); for each variant, with and without the gain, times K9
and the plain tail (the gain multiply, the ``(T, n, C)`` view and the
limiter, as ``MasteringChain.forward_tracks`` ran them before K9) with
CUDA events over ``--reps`` calls each, in turns, and checks that both give
the same bits.  Prints the card's name and power limit, and ms, TB/s and
the share of 3.35 TB/s for each.  Needs an NVIDIA GPU.
"""

import argparse
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from python_audio_mastering_tpu_torch.ops import _kernels  # noqa: E402
from python_audio_mastering_tpu_torch.ops import gain_limit as k9  # noqa: E402,E501
from python_audio_mastering_tpu_torch.ops.waveshaper import (  # noqa: E402
    soft_limiter,
    soft_limiter_legacy,
)

HBM = 3.35e12
FS, BLOCK, THR = 44100, 384, 0.98


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return f"{torch.cuda.get_device_name(0)} ({out})"


def ptxas_report():
    log = _kernels.library().compiler_log
    section = log.split("== gain_limit.cu\n", 1)[-1].split("\n== ", 1)[0]
    return [line.strip() for line in section.splitlines()
            if re.search(r"registers|spill", line)]


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_ulps(a, b):
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=420.0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print("card:", card(), "torch", torch.__version__, "CUDA",
          torch.version.cuda, flush=True)
    print("ptxas gain_limit.cu:", *ptxas_report(), sep="\n  ")
    n = int(round(args.seconds * FS))
    m = -(-n // BLOCK) * BLOCK
    t, c = args.tracks, 2
    g = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn((c, t, m), device=dev, generator=g) * 0.5
    gain = torch.linspace(0.8, 2.0, t, device=dev)
    n_bytes = 4 * (2 * c * t * n + t)
    print(f"album: {t} tracks x {n} frames x {c} channels, rows of {m}; "
          f"{n_bytes / 1e9:.3f} GB moved, bound {n_bytes / HBM * 1e3:.4f} "
          "ms", flush=True)
    for variant in ("worker", "legacy"):
        for gained in (True, False):
            gg = gain if gained else None
            got = k9.gain_limit(xr, gg, n, THR, variant)
            want = k9.gain_limit_ref(xr, gg, n, THR, variant)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            ulps = 0 if same else max_ulps(got, want)
            del got, want

            def plain():
                x4 = xr.reshape(c, t, m // BLOCK, BLOCK)
                if gg is not None:
                    x4 = x4 * gg.view(1, t, 1, 1)
                y = x4.reshape(c, t, m)[:, :, :n].permute(1, 2, 0)
                lim = (soft_limiter_legacy if variant == "legacy"
                       else soft_limiter)
                return lim(y, threshold=THR)

            def kernel():
                return k9.gain_limit(xr, gg, n, THR, variant)

            ms = {"kernel": [], "plain": []}
            for fn in ("kernel", "plain", "plain", "kernel"):
                ms[fn].append(time_ms(kernel if fn == "kernel" else plain,
                                      args.reps))
            k_ms = min(ms["kernel"])
            moved = n_bytes if gained else n_bytes - 4 * t
            print(f"{variant} gain={gained}: bitwise {same} (max ulps "
                  f"{ulps}); K9 {ms['kernel']} ms, {moved / k_ms / 1e9:.3f} "
                  f"TB/s, {100 * moved / HBM * 1e3 / k_ms:.1f} % of its "
                  f"bound; plain {ms['plain']} ms", flush=True)
    print("card:", card())


if __name__ == "__main__":
    main()
