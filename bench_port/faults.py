"""Faults planted under the album entry, which the comparison that decides
``correct`` has to fail.

Each fault takes the entry ``fn(x, params, lengths)`` and returns it
broken; ``run.Program(..., wrap=fault)`` runs a cell with it.  A fault
has a form for each entry (``entries/``): the album on the card takes and
returns a ``(T, N, C)`` tensor, the streamed album job takes a list of
host tracks and returns ``(outs, measured, meters)``.  The faults a
cell can have:

* ``half_left_out``: the second half of the album's tracks returned as
  they came in;
* ``loud``: every output 0.05 dB loud, as a wrong loudness gain makes it
  (the streamed job: its loudness gains 0.05 dB high, before its
  limiter);
* ``no_limiter``: the chain's soft limiter skipped: K9 ``gain_limit``
  applies the gain and unfolds with no limiter on the card, and
  ``MasteringChain.limiter`` returns its input (the CPU path and the
  streamed job's pass B);
* ``no_band_gain``: the multiband compressor's ratios set to 1, so the
  bands are split and summed with no gain applied (``multiband`` cells
  only);
* ``state_reset``: the streamed job's carried state (the EQ, crossover,
  ballistics, detector and K-weighting states) dropped at every chunk
  boundary (streamed cells only).

``calibrate.py`` reads them at a cell's own size on the card, the tests
in ``tests/test_bench_port_correct.py`` on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["FAULTS", "half_left_out", "loud", "no_limiter", "no_band_gain",
           "state_reset", "faults_for"]

LOUD_DB = 0.05
STREAMED = "album_job_streamed"      # the entry that carries state


def _streamed(batch):
    """Whether ``batch`` is the streamed job's input, a list of host
    tracks (the album on the card is one tensor)."""
    return isinstance(batch, list)


def half_left_out(fn):
    def broken(batch, params, lengths):
        y = fn(batch, params, lengths)
        if _streamed(batch):
            outs = list(y[0])
            half = len(outs) // 2
            outs[half:] = batch[half:]
            return (outs, *y[1:])
        y = y.clone()
        half = y.shape[0] // 2
        y[half:] = batch[half:]
        return y
    return broken


@contextlib.contextmanager
def _patched(owner, name, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def loud(fn):
    import python_audio_mastering_tpu_torch.ops.loudness as loudness

    factor = 10.0 ** (LOUD_DB / 20.0)
    gain_for_target = loudness.__dict__["gain_for_target"]

    def high(*args, **kwargs):
        return gain_for_target(*args, **kwargs) * factor

    def broken(batch, params, lengths):
        if _streamed(batch):
            with _patched(loudness, "gain_for_target", high):
                return fn(batch, params, lengths)
        return fn(batch, params, lengths) * factor
    return broken


def no_limiter(fn):
    import python_audio_mastering_tpu_torch.models.chain as chain_mod

    chain = chain_mod.MasteringChain

    def unlimited(xr, gain, n, threshold, variant="worker", **kwargs):
        if gain is not None:
            xr = xr * gain.view(1, xr.shape[1], 1)
        return xr[:, :, :n].permute(1, 2, 0).contiguous()

    def broken(batch, params, lengths):
        with _patched(chain, "limiter", lambda self, x: x), \
                _patched(chain_mod, "gain_limit", unlimited):
            return fn(batch, params, lengths)
    return broken


def no_band_gain(fn):
    from python_audio_mastering_tpu_torch.models.chain import (
        MasteringChain as chain,
    )

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


def state_reset(fn):
    import python_audio_mastering_tpu_torch.parallel.streaming as streaming

    fx_chunk = streaming.__dict__["_fx_chunk"]

    def fresh(chunk, tracks_params, config, state, *args, **kwargs):
        return fx_chunk(chunk, tracks_params, config, streaming.StreamState(),
                        *args, **kwargs)

    def broken(batch, params, lengths):
        with _patched(streaming, "_fx_chunk", fresh):
            return fn(batch, params, lengths)
    return broken


FAULTS = {f.__name__: f for f in (half_left_out, loud, no_limiter,
                                  no_band_gain, state_reset)}


def faults_for(traffic):
    """The names of the faults a cell with this traffic mix can have."""
    mb = bool(traffic["settings"].get("multiband"))
    streamed = traffic.get("entry") == STREAMED
    return [n for n in FAULTS if (mb or n != "no_band_gain")
            and (streamed or n != "state_reset")]
