"""The plain reference of both mastering chains, in NumPy and SciPy.

A straightforward implementation of the chain's semantics, written
against the upstream project's two chains (the cloud worker's
``worker/audio_mastering_engine.py`` and the monolith's ``main.py:94-192``)
and independent of the code under test: it imports nothing of the port,
designs every filter again from the settings and runs each recurrence
sample by sample (``scipy.signal.sosfilt``, the compressor's ballistics as
a Python loop), in float64.

    worker:  saturate → 4-band EQ → width → [3-band compressor] →
             BS.1770 gated loudness → gain → rational soft limiter
    legacy:  tanh saturate → 4 serial EQ blends → width → [3 real bands,
             compressed] → loudness → gain → tanh limiter

Semantics the reference holds the program to, beyond the upstream's:

* the worker EQ's coefficients are the float32 cascade (the chain
  designs them in float64 and rounds them to its float32 signal type
  before it filters);
* the compressor's detector runs at the control rate ``hop``: the
  channel-mean squared band summed over ``hop`` samples a step, a
  lookback window of the band's attack rounded up to whole steps before
  each step (partial at the start), pydub's gain computer, and pydub's
  ballistics with the rates per step (``hop / frames``); step ``k``'s
  gain applies to samples ``[k·hop, (k+1)·hop)``;
* the loudness is measured on the channel mean (the upstream worker's
  mono downmix) over the 100 ms cells that lie inside the track;
* the legacy peaks' band-passes have zero width (the upstream's Q = 1
  band edges coincide), so they pass nothing and the peaks are the
  identity.

``precision="tf32"`` computes the control instead: every filter's input
rounded to TF32 (10 mantissa bits, as a single TF32 tensor-core product
rounds its operand), each filter's result and every pointwise stage in
float32.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal

__all__ = ["master_track", "integrated_loudness", "round_tf32",
           "EQ_PRESETS", "PRECISIONS"]

PRECISIONS = ("float64", "tf32")

# the upstream worker engine's genre presets (audio_mastering_engine.py:15-20)
EQ_PRESETS = {
    "techno": (4.0, 3.0, 1.0, 3.0),
    "dubstep": (5.0, 4.0, 2.0, 3.5),
    "pop": (2.0, 0.0, 3.5, 2.5),
    "rock": (1.5, -2.0, 2.5, 1.0),
}
_EQ_KEYS = ("bass_boost", "mid_cut", "presence_boost", "treble_boost")
# the compressor's defaults (short and long settings spellings) and its
# fixed per-band (attack, release) in ms
_MB_KEYS = (("low_thresh", "low_band_threshold", -25.0),
            ("low_ratio", "low_band_ratio", 6.0),
            ("mid_thresh", "mid_band_threshold", -20.0),
            ("mid_ratio", "mid_band_ratio", 3.0),
            ("high_thresh", "high_band_threshold", -15.0),
            ("high_ratio", "high_band_ratio", 4.0))
BAND_MS = ((10.0, 200.0), (5.0, 150.0), (1.0, 50.0))
CROSSOVERS_HZ = (250.0, 4000.0)
# BS.1770 K-weighting at any rate (the tan-based designs that reproduce
# the 48 kHz tables): shelf gain, Q, corner; high pass Q, corner
_KW_SHELF = (3.999843853973347, 0.7071752369554196, 1681.974450955533)
_KW_HP = (0.5003270373238773, 38.13547087602444)
_KW_SHELF_VB_EXP = 0.4996667741545416
_ABS_GATE, _REL_GATE, _OFFSET = -70.0, -10.0, -0.691
_TINY = float(np.finfo(np.float32).tiny)
# the legacy tanh limiter jumps by thr − thr·tanh(thr) (0.2422 at 0.98)
# where |x| crosses its threshold: within this much of it, which branch
# a float32 chain takes is rounding, and either output is the chain's
LIMITER_FLIP = 4e-3


def round_tf32(x):
    """``x`` rounded to TF32 (float32 with 10 mantissa bits), to nearest
    even, as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


class _Arith:
    """Where the reference and its control differ: the type of every
    stage and the operand of every filter."""

    def __init__(self, precision):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.tf32 = precision == "tf32"
        self.dtype = np.float32 if self.tf32 else np.float64

    def cast(self, x):
        return np.asarray(x, dtype=self.dtype)

    def filt(self, sos, x):
        """``sos`` over axis 0 of ``x``, zero initial state."""
        if self.tf32:
            x = round_tf32(x)
        return self.cast(signal.sosfilt(sos, np.asarray(x, np.float64),
                                        axis=0))


# ---------------------------------------------------------------- design

def _row(b0, b1, b2, a0, a1, a2):
    return [b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0]


def _upstream_w0(fs, hz):
    # the upstream engine's w0 = 2π·fc/nyquist (its corners sit at twice
    # the named frequency), clamped under π
    return min(2.0 * math.pi * (hz / (0.5 * fs)), 0.999 * math.pi)


def _shelf(fs, hz, gain_db, kind, q=0.707):
    a = 10.0 ** (gain_db / 20.0)
    w0 = _upstream_w0(fs, hz)
    cw, alpha, sa = math.cos(w0), math.sin(w0) / (2.0 * q), math.sqrt(a)
    if kind == "low":
        return _row(a * ((a + 1) - (a - 1) * cw + 2 * sa * alpha),
                    2 * a * ((a - 1) - (a + 1) * cw),
                    a * ((a + 1) - (a - 1) * cw - 2 * sa * alpha),
                    (a + 1) + (a - 1) * cw + 2 * sa * alpha,
                    -2 * ((a - 1) + (a + 1) * cw),
                    (a + 1) + (a - 1) * cw - 2 * sa * alpha)
    return _row(a * ((a + 1) + (a - 1) * cw + 2 * sa * alpha),
                -2 * a * ((a - 1) + (a + 1) * cw),
                a * ((a + 1) + (a - 1) * cw - 2 * sa * alpha),
                (a + 1) - (a - 1) * cw + 2 * sa * alpha,
                2 * ((a - 1) - (a + 1) * cw),
                (a + 1) - (a - 1) * cw - 2 * sa * alpha)


def _peak(fs, hz, gain_db, q=1.0):
    a = 10.0 ** (gain_db / 20.0)
    w0 = _upstream_w0(fs, hz)
    cw, alpha = math.cos(w0), math.sin(w0) / (2.0 * q)
    return _row(1 + alpha * a, -2 * cw, 1 - alpha * a, 1 + alpha / a,
                -2 * cw, 1 - alpha / a)


def worker_eq_sos(fs, eq):
    """The worker EQ cascade, float32 coefficients held in float64."""
    bass, mid, presence, treble = eq
    sos = np.array([_shelf(fs, 250.0, bass, "low"),
                    _peak(fs, 1000.0, -mid),
                    _peak(fs, 4000.0, presence),
                    _shelf(fs, 8000.0, treble, "high")])
    return sos.astype(np.float32).astype(np.float64)


def kweight_sos(fs):
    """The 2-section K-weighting cascade at ``fs``."""
    g, q, fc = _KW_SHELF
    k = math.tan(math.pi * fc / fs)
    vh = 10.0 ** (g / 20.0)
    vb = vh ** _KW_SHELF_VB_EXP
    a0 = 1.0 + k / q + k * k
    shelf = [(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0,
             (vh - vb * k / q + k * k) / a0, 1.0, 2.0 * (k * k - 1.0) / a0,
             (1.0 - k / q + k * k) / a0]
    q, fc = _KW_HP
    k = math.tan(math.pi * fc / fs)
    d = 1.0 + k / q + k * k
    hp = [1.0, -2.0, 1.0, 1.0, 2.0 * (k * k - 1.0) / d,
          (1.0 - k / q + k * k) / d]
    return np.array([shelf, hp])


def _butter(order, hz, kind, fs):
    return signal.butter(order, hz, kind, fs=fs, output="sos")


# ---------------------------------------------------------------- stages

def _width(ar, x, w):
    if x.shape[1] != 2:
        return x
    mid = (x[:, 0] + x[:, 1]) * ar.cast(0.5)
    side = (x[:, 0] - x[:, 1]) * ar.cast(0.5 * w)
    return np.stack([mid + side, mid - side], axis=1)


def _worker_front(ar, x, fs, s):
    mix = (s["saturation"] / 100.0) ** 2
    x = ar.cast((1.0 - mix) * x + mix * np.tanh((1.0 + 4.0 * mix) * x))
    x = ar.filt(worker_eq_sos(fs, s["eq"]), x)
    return _width(ar, x, s["width"])


def _legacy_front(ar, x, fs, s):
    if s["saturation"] != 0.0:
        g = 1.0 + 4.0 * s["saturation"] / 100.0
        x = ar.cast(np.tanh(g * x) / g)
    if x.shape[1] == 2:
        bass, mid, presence, treble = s["eq"]
        nyq = 0.5 * fs

        def shelf(x, sos, gain_db):
            g = 10.0 ** (gain_db / 20.0)
            f = ar.filt(sos, x)
            if gain_db > 0:
                return ar.cast(x + f * (g - 1.0))
            return ar.cast(x * g + f * (1.0 - g))

        def peak(x, hz, gain_db, q=1.0):
            lo, hi = hz / nyq / math.sqrt(q), hz / nyq * math.sqrt(q)
            if lo == hi:       # zero width: the band-pass passes nothing
                return x
            f = ar.filt(signal.butter(2, [lo, min(hi, 0.999999)], "bandpass",
                                      output="sos"), x)
            return ar.cast(x + f * (10.0 ** (gain_db / 20.0) - 1.0))

        x = shelf(x, _butter(5, 250.0, "lowpass", fs), bass)
        x = peak(x, 1000.0, -mid)
        x = peak(x, 4000.0, presence)
        x = shelf(x, _butter(5, 8000.0, "highpass", fs), treble)
    return _width(ar, x, s["width"])


def _bands(ar, x, fs, variant):
    lo_hz, hi_hz = CROSSOVERS_HZ
    low = ar.filt(_butter(4, lo_hz, "lowpass", fs), x)
    high = ar.filt(_butter(4, hi_hz, "highpass", fs), x)
    if variant == "legacy":
        mid = ar.filt(_butter(4, hi_hz, "lowpass", fs),
                      ar.filt(_butter(4, lo_hz, "highpass", fs), x))
    else:
        mid = x - low - high
    return low, mid, high


def detector_targets(bands, fs, hop, thresholds, ratios):
    """Each band's attenuation target (dB) a control step, ``(3, t)``
    float64: windowed mean squares of the channel-mean squared band,
    pydub's gain computer."""
    n = bands[0].shape[0]
    t = -(-n // hop)
    out = []
    for b, (att_ms, _), th, ratio in zip(bands, BAND_MS, thresholds, ratios):
        e = np.mean(np.asarray(b, np.float64) ** 2, axis=1)
        xb = np.pad(e, (0, t * hop - n)).reshape(t, hop).sum(axis=1)
        csum = np.concatenate([[0.0], np.cumsum(xb)])
        look = max(0, int(att_ms * fs / 1000.0))
        look_eff = look if hop == 1 else max(hop, -(-look // hop) * hop)
        wb = min(look if hop == 1 else look_eff // hop, t)
        hi = csum[:t]
        lo = np.concatenate([np.zeros(wb), hi[:t - wb]])
        cnt = np.clip(np.arange(t, dtype=np.float64) * hop, 1,
                      max(look_eff, 1))
        rms = np.sqrt(np.maximum((hi - lo) / cnt, 0.0))
        with np.errstate(divide="ignore"):
            over = 20.0 * np.log10(np.maximum(rms, 1e-30)
                                   / 10.0 ** (th / 20.0))
        over = np.where(rms > 0, np.maximum(over, 0.0), 0.0)
        out.append((1.0 - 1.0 / ratio) * over)
    return np.stack(out)


def ballistics(m, ca, cr):
    """pydub's ballistics of one band's targets, one step at a time:
    attack toward the target while at or under it, release by a share of
    the target while over it."""
    att, out = 0.0, []
    push = out.append
    for mk in m.tolist():
        if att <= mk:
            att = att + mk * ca
            if att > mk:
                att = mk
        else:
            att = att - mk * cr
            if att < 0.0:
                att = 0.0
        push(att)
    return np.asarray(out)


def _compress(ar, x, fs, variant, hop, s):
    bands = _bands(ar, x, fs, variant)
    m = detector_targets(bands, fs, hop, s["thresholds"], s["ratios"])
    n = x.shape[0]
    g = []
    for row, (att_ms, rel_ms) in zip(m, BAND_MS):
        ca = hop / max(att_ms * fs / 1000.0, 1.0)
        cr = hop / max(rel_ms * fs / 1000.0, 1.0)
        att = ballistics(row, ca, cr)
        g.append(ar.cast(np.repeat(10.0 ** (-att / 20.0), hop)[:n])[:, None])
    low, mid, high = bands
    return ar.cast(low * g[0] + mid * g[1] + high * g[2])


def integrated_loudness(mono, fs, ar=None):
    """BS.1770 gated loudness (LUFS) of a mono signal, over its whole
    100 ms cells; −inf where no block passes the gates."""
    ar = ar or _Arith("float64")
    kw = np.asarray(ar.filt(kweight_sos(fs), mono), np.float64)
    cell = int(round(0.1 * fs))
    n_cells = kw.shape[0] // cell
    if n_cells < 4:
        return -math.inf
    cells = np.mean(kw[:n_cells * cell].reshape(n_cells, cell) ** 2, axis=1)
    blocks = (cells[:-3] + cells[1:-2] + cells[2:-1] + cells[3:]) / 4.0

    def lufs(ms):
        return _OFFSET + 10.0 * np.log10(np.maximum(ms, _TINY))

    lb = lufs(blocks)
    gate = lb > _ABS_GATE
    if not gate.any():
        return -math.inf
    gate &= lb > lufs(blocks[gate].mean()) + _REL_GATE
    if not gate.any():
        return -math.inf
    return float(lufs(blocks[gate].mean()))


def _limit(ar, x, variant, thr):
    """The variant's limiter, and where the legacy one's branch is
    decided by rounding (``| |x| − thr | <`` :data:`LIMITER_FLIP`), the
    other branch's value (elsewhere the output itself)."""
    over = np.flatnonzero(np.abs(x) > thr)
    xs = x.reshape(-1)
    y = x.copy()
    ys = y.reshape(-1)
    v = xs[over]
    if variant == "legacy":
        ys[over] = np.tanh(v) * thr
    else:
        d = np.abs(v) - thr
        ys[over] = np.sign(v) * (thr + d / np.sqrt(1.0 + (d / 0.02) ** 2))
    y = ar.cast(y)
    alt = y
    if variant == "legacy":
        near = np.flatnonzero(np.abs(np.abs(xs) - thr) < LIMITER_FLIP)
        if near.size:
            alt = y.copy()
            a = alt.reshape(-1)
            v = xs[near]
            a[near] = np.where(np.abs(v) > thr, v, np.tanh(v) * thr)
    return y, alt


def resolve_settings(settings):
    """The settings dict (the job payload's) as the sliders the chain
    reads: ``saturation``, ``eq`` (bass, mid_cut, presence, treble),
    ``width``, ``lufs`` (None: no normalisation), ``multiband``,
    ``thresholds``, ``ratios``."""
    s = dict(settings)
    preset = s.get("preset")
    eq = list(EQ_PRESETS[preset]) if preset and preset != "None" \
        else [0.0] * 4
    for i, k in enumerate(_EQ_KEYS):
        if s.get(k) is not None:
            eq[i] = float(s[k])
    mb = {}
    for short, long_, default in _MB_KEYS:
        v = s.get(short, s.get(long_))
        mb[short] = default if v is None else float(v)
    return {"saturation": float(s.get("saturation") or 0.0),
            "eq": tuple(eq), "width": float(s.get("width", 1.0)),
            "lufs": None if s.get("lufs") is None else float(s["lufs"]),
            "multiband": bool(s.get("multiband",
                                    s.get("use_multiband", False))),
            "thresholds": (mb["low_thresh"], mb["mid_thresh"],
                           mb["high_thresh"]),
            "ratios": (mb["low_ratio"], mb["mid_ratio"], mb["high_ratio"])}


def master_track(x, settings, chain, precision="float64"):
    """Master one track ``x`` ``(n, C)`` with the settings dict and the
    chain's deployment (a configuration's ``chain`` dict: ``variant``,
    ``sample_rate``, ``comp_hop``, ``limiter_threshold``; its
    ``limiter_mode``, where given, must be ``"reference"``, the soft
    limiter: another limiter is another reference's).  Returns ``(y (n,
    C), measured LUFS, alt)``: ``alt`` is ``y`` with the samples at which
    the limiter's branch is rounding (:func:`_limit`) on the other
    branch."""
    mode = chain.get("limiter_mode", "reference")
    if mode != "reference":
        raise ValueError(f"limiter_mode {mode!r}: this reference masters "
                         "with the soft limiter (\"reference\") only")
    ar = _Arith(precision)
    fs, variant = int(chain["sample_rate"]), chain["variant"]
    s = resolve_settings(settings)
    x = ar.cast(x)
    front = _legacy_front if variant == "legacy" else _worker_front
    y = front(ar, x, fs, s)
    if s["multiband"]:
        y = _compress(ar, y, fs, variant, int(chain["comp_hop"]), s)
    measured = math.nan
    if s["lufs"] is not None:
        measured = integrated_loudness(y.mean(axis=1), fs, ar)
        gain = (10.0 ** ((s["lufs"] - measured) / 20.0)
                if math.isfinite(measured) else 1.0)
        y = ar.cast(y * gain)
    y, alt = _limit(ar, y, variant, float(chain["limiter_threshold"]))
    return y, measured, alt
