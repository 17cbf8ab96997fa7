"""Faults planted under the album entry, which the comparison that decides
``correct`` has to fail.

Each fault takes the album entry ``fn(batch, params, lengths)`` and
returns it broken; ``run.Program(..., wrap=fault)`` runs a cell with it.
The faults an album cell can have:

* ``half_left_out``: the second half of the album's tracks returned as
  they came in;
* ``loud``: every output 0.05 dB loud, as a wrong loudness gain makes it;
* ``no_limiter``: the chain's soft limiter skipped;
* ``no_band_gain``: the multiband compressor's ratios set to 1, so the
  bands are split and summed with no gain applied (``multiband`` cells
  only).

``calibrate.py`` reads them at a cell's own size on the card, the tests
in ``tests/test_bench_port_correct.py`` on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["FAULTS", "half_left_out", "loud", "no_limiter", "no_band_gain",
           "faults_for"]


def half_left_out(fn):
    def broken(batch, params, lengths):
        y = fn(batch, params, lengths).clone()
        half = y.shape[0] // 2
        y[half:] = batch[half:]
        return y
    return broken


def loud(fn):
    def broken(batch, params, lengths):
        return fn(batch, params, lengths) * 10.0 ** (0.05 / 20.0)
    return broken


@contextlib.contextmanager
def _patched(owner, name, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _chain_class():
    from python_audio_mastering_tpu_torch.models.chain import MasteringChain

    return MasteringChain


def no_limiter(fn):
    chain = _chain_class()

    def broken(batch, params, lengths):
        with _patched(chain, "limiter", lambda self, x: x):
            return fn(batch, params, lengths)
    return broken


def no_band_gain(fn):
    chain = _chain_class()
    multiband = chain.__dict__["multiband"]

    def unity(p):
        return dataclasses.replace(p, low_ratio=1.0, mid_ratio=1.0,
                                   high_ratio=1.0)

    def flat(self, xrows, params, *args, **kwargs):
        params = ([unity(p) for p in params] if xrows.ndim == 4
                  else unity(params))
        return multiband(self, xrows, params, *args, **kwargs)

    def broken(batch, params, lengths):
        with _patched(chain, "multiband", flat):
            return fn(batch, params, lengths)
    return broken


FAULTS = {f.__name__: f for f in (half_left_out, loud, no_limiter,
                                  no_band_gain)}


def faults_for(traffic):
    """The names of the faults a cell with this traffic mix can have."""
    mb = bool(traffic["settings"].get("multiband"))
    return [n for n in FAULTS if mb or n != "no_band_gain"]
