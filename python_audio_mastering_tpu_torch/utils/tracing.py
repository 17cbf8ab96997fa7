"""Host-side tracing spans and counters.

Counterpart of ``python_audio_mastering_tpu.utils.tracing``: named spans
on the host clock, kept in a process-wide buffer (:func:`get_trace`,
:func:`trace_summary`), thread-safe counters, and :func:`profiler_trace`,
a ``torch.profiler`` trace written to a directory (the JAX package's
``xla_trace``).

    with span("eq", sync=y):
        y = eq(x)
    print(trace_summary())

PyTorch returns before the card has run what it was asked to, so a span
that should include the device's time names what to wait for: ``sync``
takes a tensor or a device (the span closes after
``torch.cuda.synchronize`` of that card; nothing to wait for on the CPU)
or a callable.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import torch

__all__ = ["span", "get_trace", "clear_trace", "trace_summary",
           "profiler_trace", "Counter", "counters"]

_local = threading.local()
_global_lock = threading.Lock()
_global_trace: list[dict] = []


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _wait(sync):
    """Wait for ``sync``: a callable is called; a tensor's or a device's
    card is synchronised."""
    if callable(sync):
        sync()
        return
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def span(name: str, sync=None, **attrs):
    """Record a named span (nested spans get ``outer/inner`` names).

    ``sync``: a tensor, a device or a callable to wait for before the span
    closes (see the module docstring), or None to time the host alone.
    The record holds ``dur_ms`` and ``attrs``."""
    stack = _stack()
    rec = {"name": "/".join(s["name"] for s in stack) + "/" + name
           if stack else name,
           "start": time.perf_counter(), **attrs}
    stack.append(rec)
    try:
        yield rec
    finally:
        if sync is not None:
            _wait(sync)
        rec["dur_ms"] = (time.perf_counter() - rec["start"]) * 1000.0
        del rec["start"]
        stack.pop()
        with _global_lock:
            _global_trace.append(rec)


def get_trace() -> list[dict]:
    with _global_lock:
        return list(_global_trace)


def clear_trace():
    with _global_lock:
        _global_trace.clear()


def trace_summary() -> str:
    """Aggregate by span name: count, total and mean duration."""
    agg: dict[str, list[float]] = {}
    for rec in get_trace():
        agg.setdefault(rec["name"], []).append(rec.get("dur_ms", 0.0))
    lines = [f"{name:40s} n={len(ds):4d} total={sum(ds):9.2f}ms "
             f"mean={sum(ds) / len(ds):8.2f}ms"
             for name, ds in sorted(agg.items(),
                                    key=lambda kv: -sum(kv[1]))]
    return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Wrap a region in a ``torch.profiler`` trace (host, and the card's
    kernels where there is one), written to ``log_dir`` as a Chrome/
    TensorBoard trace file when the region ends."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class Counter:
    """A tiny thread-safe metric counter."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1):
        with self._lock:
            self.value += by


class _Counters:
    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def __call__(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {k: c.value for k, c in self._counters.items()}

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


counters = _Counters()
