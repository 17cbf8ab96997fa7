"""Named spans at the port's stage boundaries.

``span(name)`` marks a region of the host's work; nested spans get
``outer/inner`` paths.  Where a span lands:

* under a running ``torch.profiler``: a ``record_function`` named
  ``pam.<path>`` (``pam.chain/multiband/states``), in the same record as
  the device's kernels and copies and on the same clock, inside the range
  of the span that encloses it;
* inside :func:`recording`: a host record ``{"name": path, "dur_ms": ...,
  **attrs}`` on the host clock, read back by :func:`get_trace` and
  :func:`trace_summary`;
* otherwise nowhere: the span checks two flags and keeps nothing, so it
  costs next to nothing on a worker's hot path.

    with recording():
        with span("eq", sync=torch.cuda.synchronize):
            y = eq(x)
    print(trace_summary())

PyTorch returns before the card has run what it was asked to, so a
recorded span that should include the device's time names what to wait
for: ``sync`` takes a tensor or a device (the span closes after
``torch.cuda.synchronize`` of that card; nothing to wait for on the CPU)
or a callable.  It is waited for only inside :func:`recording`: no span
synchronises a run that records nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "recording", "get_trace", "trace_summary", "PREFIX"]

PREFIX = "pam."       # the profiler's name of a span: PREFIX + its path


class _State(threading.local):
    """One thread's open spans and its last recording."""

    def __init__(self):
        self.stack: list[str] = []
        self.records: list[dict] = []
        self.recording = False


_state = _State()


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
    """A named span (see the module docstring).  Yields its host record
    inside :func:`recording` (``dur_ms`` is set when it closes), else
    None.  ``sync``: what a recorded span waits for before it closes."""
    st = _state
    profiled = _profiler._is_profiler_enabled
    if not (profiled or st.recording):
        yield None
        return
    st.stack.append(name)
    path = "/".join(st.stack)
    rec = {"name": path, **attrs} if st.recording else None
    t0 = time.perf_counter()
    try:
        with (_profiler.record_function(PREFIX + path) if profiled
              else contextlib.nullcontext()):
            yield rec
            if rec is not None and sync is not None:
                _wait(sync)
    finally:
        st.stack.pop()
        if rec is not None:
            rec["dur_ms"] = (time.perf_counter() - t0) * 1000.0
            st.records.append(rec)


@contextlib.contextmanager
def recording():
    """Keep this thread's spans opened inside as host records, which
    :func:`get_trace` returns until the next recording starts."""
    st = _state
    st.records, st.recording = [], True
    try:
        yield
    finally:
        st.recording = False


def get_trace() -> list[dict]:
    """This thread's records of its last :func:`recording`, in the order
    the spans closed."""
    return list(_state.records)


def trace_summary() -> str:
    """Aggregate :func:`get_trace` by span name: count, total and mean
    duration."""
    agg: dict[str, list[float]] = {}
    for rec in get_trace():
        agg.setdefault(rec["name"], []).append(rec["dur_ms"])
    lines = [f"{name:40s} n={len(ds):4d} total={sum(ds):9.2f}ms "
             f"mean={sum(ds) / len(ds):8.2f}ms"
             for name, ds in sorted(agg.items(),
                                    key=lambda kv: -sum(kv[1]))]
    return "\n".join(lines)
