"""The comparison that decides ``correct``.

After the window, one album that the window completed is drawn from the
seed (a reservoir over the completed albums, so the draw does not
depend on how many there were); of it, the longest track, one from the
other half of the album and ``check_tracks − 2`` more, drawn from the
seed (:func:`pick_tracks`), are mastered again by the plain reference
that the configuration names (``reference/<name>.py``;
``reference.chain`` by default, float64) from the same input and
settings.  Where the traffic mix's wire is ``pcm16`` the deployment's
output is 16-bit, and the reference's output is rounded as the wire
rounds it (:func:`round_pcm16`) before it is compared; so is the
control's.  Each number is the worst over those tracks:

* ``rms_err``: the RMS of the program's output minus the reference's,
  over the RMS of the reference's;
* ``med_err``: the median of the absolute difference over the same RMS,
  which the few stretches where the ballistics' branch flips on rounding
  (pydub's step jumps where the state meets its target) leave alone;
* ``max_err``: the largest absolute difference of a sample (full scale
  1.0);
* ``lufs_err``: the gap in LU between the two outputs' loudness, both
  measured by the reference's meter.

``cells/<cell>.json`` gives the limit of each number that the cell
compares; a number without one is printed and not compared.  A
non-finite output reads ``inf``.
"""

from __future__ import annotations

import math
import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from bench_port import registry
from bench_port.reference.chain import integrated_loudness

__all__ = ["Reservoir", "pick_tracks", "readings", "judge", "round_pcm16",
           "NUMBERS", "WIRES"]

NUMBERS = ("rms_err", "med_err", "max_err", "lufs_err")
WIRES = (None, "float32", "pcm16")    # a traffic mix's ``transfer``
PCM16_SCALE = 32767.0


class Reservoir:
    """One item drawn uniformly from a stream of unknown length, from
    ``seed``."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self._seen = 0
        self.item = None

    def offer(self, item):
        self._seen += 1
        if self._rng.randrange(self._seen) == 0:
            self.item = item


def pick_tracks(lengths, k, seed):
    """The longest track, one drawn from the half of the album (by
    position) that does not hold it, and ``k − 2`` more from the rest,
    all drawn from ``seed``: a fault that leaves either half of the batch
    alone meets a checked track on every seed."""
    n = len(lengths)
    longest = max(range(n), key=lambda i: lengths[i])
    rng = random.Random(seed)
    half = n // 2
    other = list(range(half, n) if longest < half else range(half))
    picks = [longest]
    if k > 1 and other:
        picks.append(rng.choice(other))
    rest = [i for i in range(n) if i not in picks]
    return picks + rng.sample(rest, max(0, min(k - len(picks), len(rest))))


def readings(y, ref, fs, alt=None):
    """The numbers of one track: the program's (or the control's) output
    ``y`` against the reference's ``ref``, both ``(n, C)``.  ``alt``: the
    reference with the samples at which its limiter's branch is rounding
    on the other branch; there the nearer of the two counts."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    if y.shape != ref.shape or not np.isfinite(y).all():
        return {k: math.inf for k in NUMBERS}
    d = y - ref
    if alt is not None and alt is not ref:
        d2 = y - np.asarray(alt, np.float64)
        d = np.where(np.abs(d2) < np.abs(d), d2, d)
    rms_ref = math.sqrt(float(np.mean(ref * ref))) or 1.0
    lufs_y = integrated_loudness(y.mean(axis=1), fs)
    lufs_r = integrated_loudness(ref.mean(axis=1), fs)
    gap = (abs(lufs_y - lufs_r) if math.isfinite(lufs_y)
           and math.isfinite(lufs_r) else
           (0.0 if lufs_y == lufs_r else math.inf))
    ad = np.abs(d)
    return {"rms_err": math.sqrt(float(np.mean(d * d))) / rms_ref,
            "med_err": float(np.median(ad)) / rms_ref,
            "max_err": float(ad.max()),
            "lufs_err": gap}


def worst(per_track):
    return {k: max(r[k] for r in per_track) for k in NUMBERS}


def round_pcm16(y):
    """``y`` as the pcm16 wire hands it back: the signal in float32,
    ``clip(round(y·32767), −32768, 32767)/32767`` (half to even, the
    product in float32), as float32: the port's ``requantize_pcm16`` on
    the card and its dequantization on the host, written again here."""
    q = np.round(np.asarray(y, np.float32) * np.float32(PCM16_SCALE))
    return (np.clip(q, -32768.0, 32767.0) / np.float32(PCM16_SCALE)).astype(
        np.float32)


def _wire(wire):
    if wire not in WIRES:
        raise ValueError(f"transfer {wire!r}: one of {WIRES}")
    return round_pcm16 if wire == "pcm16" else (lambda y: y)


def track_readings(x, y, settings, chain, control=False, faults=None,
                   reference=registry.DEFAULT_REFERENCE, wire=None):
    """One track's numbers: the program's output ``y`` against the
    reference's (``reference/<reference>.py``), with ``control`` the
    control's (the reference in TF32) too, and with ``faults`` (``{name:
    output}``) each faulted output's: ``{"program": ..., ["control":
    ...,] [name: ...]}``.  ``wire``, the traffic mix's ``transfer``:
    ``"pcm16"`` rounds the reference's and the control's outputs as the
    wire rounds the program's."""
    fs = int(chain["sample_rate"])
    master_track = registry.load_module("reference", reference).master_track
    rounded = _wire(wire)
    ref, _, alt = master_track(x, settings, chain)
    ref, alt = rounded(ref), (None if alt is ref else rounded(alt))
    out = {"program": readings(y, ref, fs, alt)}
    if control:
        ctl, _, _ = master_track(x, settings, chain, "tf32")
        out["control"] = readings(rounded(ctl), ref, fs, alt)
    for name, yf in (faults or {}).items():
        out[name] = readings(yf, ref, fs, alt)
    return out


def map_tracks(tasks, workers, **how):
    """``track_readings(*task, **how)`` of each task ``(x, y, settings,
    chain, control[, faults])``, in ``workers`` spawned processes (in this
    one for 1)."""
    if workers <= 1:
        return [track_readings(*t, **how) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = [pool.submit(track_readings, *t, **how) for t in tasks]
        return [f.result() for f in futs]


def judge(limits, chain, items, workers=1,
          reference=registry.DEFAULT_REFERENCE, wire=None):
    """``items``: ``(x (n, C), y (n, C), settings)`` of each track
    checked; ``reference`` and ``wire`` as :func:`track_readings` takes
    them.  Returns ``(correct, checks, per_track)``: ``checks`` maps each
    compared number to its value and limit, in the order of
    :data:`NUMBERS`."""
    per_track = [r["program"] for r in map_tracks(
        [(x, y, s, chain, False) for x, y, s in items], workers,
        reference=reference, wire=wire)]
    w = worst(per_track) if per_track else {}
    checks = {k: {"value": w[k], "limit": limits[k]} for k in NUMBERS
              if k in limits and k in w}
    ok = bool(per_track) and all(math.isfinite(c["value"])
                                 and c["value"] <= c["limit"]
                                 for c in checks.values())
    return ok, checks, per_track
