"""Faults of the lookahead true-peak limiter that the quality cell's check
has to fail, and their fail shares on the card.

    python3 scripts/quality_faults.py [--workload worker_quality.album12_loud]
        [--out chiprun_out/quality_faults.json]

Each fault takes the album entry ``fn(batch, params, lengths)`` and
returns it broken, in the form of ``bench_port/faults.py``.  Each runs
the chain's own limiter hook, ``models.chain.lookahead_limiter``, with
other arguments, so it takes whatever route the limiter takes (on the
card K10 ``lookahead_limit``, on the CPU the plain stages):

* ``sample_peak``: ``true_peak=False``, the envelope the sample peak, not
  the 4x interpolated true peak;
* ``look_one``: ``lookahead_ms=0``, a look-ahead of one sample instead of
  1.5 ms;
* ``instant_release``: a ``release_ms`` so short that the release's
  ``rho`` is 0: the gain returns at once after a peak;
* ``padded_length``: each track limited over the album's padded length,
  reading the EQ's ring-out and the padding after its end, where its
  one-shot ``master()`` replicates its last sample (the batched album
  path did this before each track was limited to its own end).

The script runs ``bench_port/calibrate.py``'s reading of every track that
a run can check (``calibrate.read_tracks``: the cell's albums on the
card, each track against the plain reference its configuration names)
with these faults beside ``bench_port.faults``' own, and prints
``calibrate.summary``: each output's share of 2 000 seeds on which a
run's check fails it, at the cell's ``check_tracks``.  Needs an NVIDIA
GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

__all__ = ["FAULTS", "sample_peak", "look_one", "instant_release",
           "padded_length"]

WORKLOAD = "worker_quality.album12_loud"


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _under(owner, name, make):
    """A fault that runs the entry with ``owner.name`` replaced by
    ``make(original, batch)``."""
    def fault(fn):
        def broken(batch, params, lengths):
            with _patched(owner, name, make(getattr(owner, name), batch)):
                return fn(batch, params, lengths)
        return broken
    return fault


def _limited_with(**wrong):
    """A fault that runs the chain's limiter hook with the keywords
    ``wrong``."""
    from python_audio_mastering_tpu_torch.models import chain

    def make(limit, _):
        return lambda x, sample_rate, **kwargs: limit(
            x, sample_rate, **{**kwargs, **wrong})
    return _under(chain, "lookahead_limiter", make)


def sample_peak(fn):
    return _limited_with(true_peak=False)(fn)


def look_one(fn):
    # look = max(1, int(lookahead_ms · fs / 1000)): 1 at 0 ms
    return _limited_with(lookahead_ms=0.0)(fn)


def instant_release(fn):
    # rho = exp(-1 / (release_ms · fs / 1000)): exp(-22 676) is 0
    return _limited_with(release_ms=1e-6)(fn)


def padded_length(fn):
    from python_audio_mastering_tpu_torch.models import chain

    def make(limit, batch):
        frames = batch.shape[1]

        def over_padding(x, sample_rate, **kwargs):
            # the chain hands each track over as a view of the album's
            # rows, whose padding follows it in memory
            full = x.as_strided((frames, x.shape[1]), x.stride(),
                                x.storage_offset())
            return limit(full, sample_rate, **kwargs)[:x.shape[0]]
        return over_padding

    return _under(chain, "lookahead_limiter", make)(fn)


FAULTS = {f.__name__: f for f in (sample_peak, look_one, instant_release,
                                  padded_length)}


def main(argv=None):
    from bench_port import calibrate, faults, registry
    from bench_port.run import card_line, log

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default=WORKLOAD)
    ap.add_argument("--out", default="chiprun_out/quality_faults.json")
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    t0 = time.perf_counter()
    own = faults.faults_for
    with _patched(faults, "FAULTS", {**faults.FAULTS, **FAULTS}), \
            _patched(faults, "faults_for",
                     lambda traffic: own(traffic) + list(FAULTS)):
        tracks = calibrate.read_tracks(cell)
    out = {"workload": args.workload, "card": card_line(), "tracks": tracks,
           "summary": calibrate.summary(cell, tracks),
           "seconds": time.perf_counter() - t0}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    log(json.dumps({k: out[k] for k in ("summary", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
