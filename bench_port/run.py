"""Run one cell of ``BENCHMARK.json`` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic mix (``traffic/<mix>.json``) is rendered on the card
from ``--seed``: a few albums of tracks, padded to one batch each.  The
mix's ``entry`` names the entry under test (``entries/<entry>.py``).  By
default it is the port's batched album entry,
``parallel.batch.make_album_fn(config)`` → ``MasteringChain.
forward_tracks``: a whole album ``(T, N, C)`` on the card mastered in one
call, each track's loudness measured over its own length;
``album_job_streamed`` is the worker's album job, host tracks to host
outputs through ``parallel.batch.master_album_streamed``.  Set-up makes
each album the entry's input and warms every padded length and settings
dict of the schedule once.  Then a closed loop with one client: the next
album is dispatched when the previous one's output has been synchronised
(or has reached the host), for ``--seconds``.

``--trace 0`` prints the cell's end-to-end metrics: ``setup_s`` (from
the harness's start to the first timed call: imports, CUDA init, the
kernel library's load, track generation, warm-up; the library's first
nvcc build in a fresh checkout is left out and printed apart, on an
earlier line, as ``build_s``),
``audio_rtf`` (unpadded audio seconds completed over the window's
seconds) and ``album_p95_ms`` (the 95th percentile of the albums' times
from dispatch to synchronised output).  ``--trace 1`` records
``trace_albums`` albums under ``torch.profiler`` instead and prints the
per-layer metrics that ``metrics/*.py`` read from that record.

Either way the window's output is then judged against the plain
reference (``correctness``), and the last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` when traced) and, last, ``checks``: each number
compared beside its limit, also the last lines of standard error.  The
run exits non-zero and prints no result without a CUDA device, with
fewer devices than the cell asks for, when the port is not inside this
checkout, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernel library in its own package's _build/)
_CACHE = ROOT / "bench_port" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
# load from one process with few threads: the host's cores are shared,
# and a thread pool spinning beside the issuing thread is noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import (  # noqa: E402
    correctness,
    device_trace,
    registry,
    roofline,
    traffic,
)

PORT = "python_audio_mastering_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "python_audio_mastering_tpu")


class RunRefused(RuntimeError):
    """A run that may print no result."""


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds, each
    module's top-level name compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def import_port():
    """The port, refused unless it is the one inside this checkout."""
    import importlib

    try:
        mod = importlib.import_module(PORT)
    except ImportError as e:
        raise RunRefused(f"the port {PORT} cannot be imported: {e}") from e
    where = Path(mod.__file__).resolve()
    if ROOT not in where.parents:
        raise RunRefused(f"{PORT} was loaded from {where}, outside the "
                         f"checkout {ROOT}")
    return mod


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi gave nothing"


def count_syncs(fn, torch):
    """``fn()`` under PyTorch's sync debug mode: the host
    synchronisations it reported."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


class Program:
    """The system under test at a cell's configuration, on ``device``:
    the entry its traffic mix names and the schedule's albums rendered
    there and made that entry's input."""

    def __init__(self, cell, seed, device, wrap=None):
        import torch

        self.torch = torch
        import_port()
        from python_audio_mastering_tpu_torch import (
            ChainConfig,
            MasteringParams,
        )
        from python_audio_mastering_tpu_torch.ops import cuda_multiband

        self.entry = registry.entry(cell.traffic)
        registry.reference(cell.config)       # a missing one fails here
        self.reference = registry.reference_name(cell.config)
        self.wire = cell.traffic.get("transfer")
        self.cell = cell
        self.counters = cuda_multiband
        self.cuda = torch.device(device).type == "cuda"
        self.build_s = 0.0
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
            from python_audio_mastering_tpu_torch.ops import _kernels

            lib = _kernels.library()
            self.build_s = float(lib.build_seconds)
            log(f"build_s {self.build_s!r} ({lib.path.name})")
        self.config = ChainConfig(**cell.config["chain"])
        self.fs = self.config.sample_rate
        self.channels = int(cell.config["channels"])
        self.plans = traffic.schedule(cell.traffic, self.fs, seed)
        self.batches = [self.entry.inputs(
            traffic.render(p, self.fs, self.channels, device), p,
            cell.traffic) for p in self.plans]
        self.params = [MasteringParams.from_settings(p.settings)
                       for p in self.plans]
        fn = self.entry.build(self.config, cell.traffic, device)
        self.fn = wrap(fn) if wrap else fn

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def call(self, k):
        """Album ``k`` of the schedule through the entry."""
        p = self.plans[k]
        return self.fn(self.batches[k], self.params[k], p.lengths)

    def warm(self):
        """One call for every padded length and settings dict."""
        seen = set()
        for k, p in enumerate(self.plans):
            if p.key() not in seen:
                seen.add(p.key())
                self.call(k)
                self.sync()

    def chain_for_reference(self):
        """The configuration's whole ``chain`` dict, as its reference
        reads it."""
        return dict(self.cell.config["chain"])

    def frames(self, k):
        """The frames of each track of album ``k`` that the entry's
        kernels process (the roofline counts' album shape)."""
        return self.entry.frames(self.plans[k], self.cell.config,
                                 self.cell.traffic)

    def track_items(self, k, y, indices):
        """``(input, output, settings)`` of album ``k``'s tracks
        ``indices`` on the host, unpadded."""
        p = self.plans[k]
        return [(self.entry.track_in(self.batches[k], i, p.lengths[i]),
                 self.entry.track_out(y, i, p.lengths[i]), p.settings)
                for i in indices]

    def memory_peak(self):
        return (int(self.torch.cuda.max_memory_allocated())
                if self.cuda else 0)

    def device_info(self):
        t = self.torch
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu", "kind": t.cuda.get_device_name(0),
                "count": 1}


def timed_window(prog, seconds, reservoir):
    """The closed loop for ``seconds``; returns the values of the
    end-to-end metrics and the albums attempted and failed."""
    lat, audio, done, failed = [], 0.0, 0, 0
    t_start = t_end = time.perf_counter()
    while t_end - t_start < seconds:
        k = done % len(prog.plans)
        t0 = time.perf_counter()
        try:
            y = prog.call(k)
            prog.sync()
        except (RuntimeError, ValueError) as e:
            failed += 1
            log(f"album {done} failed: {e!r}")
            y = None
        t_end = time.perf_counter()
        done += 1
        if y is not None:
            lat.append(t_end - t0)
            audio += prog.plans[k].audio_seconds(prog.fs)
            reservoir.offer((k, y))
        del y
    window = t_end - t_start
    values = {"audio_rtf": audio / window,
              "album_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                               if lat else math.inf)}
    log(f"window {window!r} s, {done} albums, {len(lat)} completed, "
        f"album median {float(np.median(lat)) * 1e3 if lat else math.nan!r}"
        f" ms")
    return values, done, failed


def traced_window(prog, cell, reservoir):
    """``trace_albums`` albums under ``torch.profiler``; returns the
    per-layer metrics, the device's busy and window seconds and the
    breakdown."""
    torch = prog.torch
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(cell.traffic["trace_albums"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if prog.cuda else [])
    prog.sync()
    prog.counters.reset_launch_counts()
    with profile(activities=acts) as prof:
        with record_function(f"{device_trace.OWN_SPAN}window"):
            t0 = time.perf_counter()
            for j in range(n):
                k = j % len(prog.plans)
                with record_function(f"{device_trace.OWN_SPAN}album"):
                    y = prog.call(k)
                    prog.sync()
                reservoir.offer((k, y))
                del y
            window_s = time.perf_counter() - t0
    launches = {name: c / n
                for name, c in prog.counters.launch_counts().items()}
    syncs = count_syncs(lambda: prog.call(0), torch) if prog.cuda else None
    shapes = [roofline.album_shape(cell.config, prog.frames(j % len(
        prog.plans)), len(prog.plans[0].tracks), prog.channels,
        prog.params[0].multiband, prog.params[0].lufs_enabled)
        for j in range(n)]
    ctx, win = device_trace.read(prof, n, window_s, launches, syncs, shapes)
    metrics = {}
    for name in cell.per_layer:
        mod = registry.metric(name)
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": mod.UNIT}
    for note in dict.fromkeys(ctx.notes):
        log(note)
    log(f"traced {n} albums: {len(ctx.names)} device activities, "
        f"launches a call {launches}")
    extra = {"busy_s": ctx.busy_s, "window_s": window_s}
    breakdown = {"device_ops": ctx.device_ops(),
                 "idle_gaps": ctx.idle_gaps(win)}
    return metrics, extra, breakdown, n


def run_cell(cell, seed, seconds, trace, device="cuda", wrap=None):
    """One run of ``cell``; returns the result object.  ``wrap``, for
    tests, wraps the album entry."""
    prog = Program(cell, seed, device, wrap)
    if prog.cuda:
        log(card_line())
    prog.warm()
    setup_s = time.perf_counter() - T0 - prog.build_s
    reservoir = correctness.Reservoir(seed + 1)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": prog.device_info()}
    if trace:
        metrics, extra, breakdown, n = traced_window(prog, cell, reservoir)
        result.update(attempted=n, metrics=metrics)
        result["device"].update(extra)
        result["breakdown"] = breakdown
    else:
        values, done, failed = timed_window(prog, seconds, reservoir)
        values["setup_s"] = setup_s
        result.update(attempted=done, failed=failed, metrics={
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end})
    result["device"]["memory_peak_bytes"] = prog.memory_peak()
    log(f"setup_s {setup_s!r}; memory_peak_bytes "
        f"{result['device']['memory_peak_bytes']}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}")

    ok, checks = False, {}
    if reservoir.item is not None:
        k, y = reservoir.item
        idx = correctness.pick_tracks(prog.plans[k].lengths,
                                      int(cell.traffic["check_tracks"]),
                                      seed + 2)
        items = prog.track_items(k, y, idx)
        chain = prog.chain_for_reference()
        how = dict(reference=prog.reference, wire=prog.wire)
        del y, prog
        reservoir.item = None
        t_ref = time.perf_counter()
        workers = len(items) if device != "cpu" else 1
        ok, checks, per_track = correctness.judge(cell.limits, chain, items,
                                                  workers, **how)
        log(f"reference: album {k}, tracks {idx}, "
            f"{time.perf_counter() - t_ref:.1f} s")
        for i, r in zip(idx, per_track):
            log(f"track {i}: " + ", ".join(f"{a} {b!r}" for a, b in
                                           r.items()))
    result["correct"] = bool(ok and result["failed"] == 0)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = registry.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        log(f"bench_port: no cell {args.workload!r}: {e!r}")
        return 1
    import torch

    if not torch.cuda.is_available():
        log("bench_port: torch.cuda.is_available() is False")
        return 1
    if torch.cuda.device_count() < cell.chips:
        log(f"bench_port: {torch.cuda.device_count()} CUDA devices, the "
            f"cell asks for {cell.chips}")
        return 1
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except RunRefused as e:
        log(f"bench_port: {e}")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"bench_port: forbidden modules loaded: {bad}")
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
