"""Typed configuration: the settings-dict wire contract as plain dataclasses.

Counterpart of ``python_audio_mastering_tpu.config``.  The settings dict
arrives with two key spellings for the multiband knobs (the GUI's
``low_band_threshold`` and the worker's ``low_thresh``);
:meth:`MasteringParams.from_settings` accepts both, the short spelling
winning when both are present.

The port keeps no ``mb_kernel`` or ``layout`` field: a kernel is chosen by
the device of the tensor it is given (see ``ops.cuda_multiband``).

A slider of :class:`MasteringParams` may hold a 0-d tensor (the
automaster's fit differentiates the chain through them);
:meth:`MasteringParams.to_settings` detaches such values into floats.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MasteringParams", "ChainConfig", "CompressorBandParams",
           "settings_from_params", "PARAM_RANGES"]

# GUI slider ranges (mastering_gui.py:95-112), as in the JAX package.
PARAM_RANGES = {
    "saturation": (0.0, 100.0),
    "bass_boost": (-6.0, 6.0),
    "mid_cut": (-6.0, 6.0),  # GUI range is 0..6 but rock preset uses -2.0
    "presence_boost": (-6.0, 6.0),
    "treble_boost": (-6.0, 6.0),
    "width": (0.0, 2.0),
    "lufs": (-24.0, -6.0),
    "low_thresh": (-40.0, 0.0), "low_ratio": (1.0, 12.0),
    "mid_thresh": (-40.0, 0.0), "mid_ratio": (1.0, 12.0),
    "high_thresh": (-40.0, 0.0), "high_ratio": (1.0, 12.0),
}


def _num(v):
    """A slider value as a Python float (a tensor detached first)."""
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)

# (short worker key, GUI/long key, default) — as in the JAX package.
_MB_KEYS = [
    ("low_thresh", "low_band_threshold", -25.0),
    ("low_ratio", "low_band_ratio", 6.0),
    ("mid_thresh", "mid_band_threshold", -20.0),
    ("mid_ratio", "mid_band_ratio", 3.0),
    ("high_thresh", "high_band_threshold", -15.0),
    ("high_ratio", "high_band_ratio", 4.0),
]


@dataclasses.dataclass
class CompressorBandParams:
    """One band's threshold/ratio (ballistics are fixed per band slot)."""

    threshold_db: float
    ratio: float


@dataclasses.dataclass
class MasteringParams:
    """All per-job mastering parameters (the settings-dict schema, typed)."""

    saturation: float = 0.0
    bass_boost: float = 0.0
    mid_cut: float = 0.0
    presence_boost: float = 0.0
    treble_boost: float = 0.0
    width: float = 1.0
    lufs: float = -14.0
    low_thresh: float = -25.0
    low_ratio: float = 6.0
    mid_thresh: float = -20.0
    mid_ratio: float = 3.0
    high_thresh: float = -15.0
    high_ratio: float = 4.0
    multiband: bool = False
    lufs_enabled: bool = True

    @classmethod
    def from_settings(cls, settings, preset=None):
        """Build from a settings dict (both key spellings).

        ``preset`` (or ``settings['preset']``) applies EQ_PRESETS values
        verbatim, overridden by explicit EQ keys in ``settings``.
        """
        from python_audio_mastering_tpu_torch.models.presets import EQ_PRESETS

        s = dict(settings or {})
        preset = preset or s.pop("preset", None)
        kwargs = {}
        if preset and preset != "None":
            p = EQ_PRESETS[preset]
            kwargs.update({k: p[k] for k in
                           ("bass_boost", "mid_cut", "presence_boost",
                            "treble_boost")})
        for key in ("saturation", "bass_boost", "mid_cut", "presence_boost",
                    "treble_boost", "width"):
            if s.get(key) is not None:
                kwargs[key] = float(s[key])
        lufs = s.get("lufs")
        kwargs["lufs_enabled"] = lufs is not None
        if lufs is not None:
            kwargs["lufs"] = float(lufs)
        kwargs["multiband"] = bool(s.get("multiband",
                                         s.get("use_multiband", False)))
        for short, long_, _ in _MB_KEYS:
            if s.get(short) is not None:
                kwargs[short] = float(s[short])
            elif s.get(long_) is not None:
                kwargs[short] = float(s[long_])
        return cls(**kwargs)

    def has_tensors(self):
        """True when a slider holds a tensor (the automaster's route)."""
        return any(isinstance(getattr(self, f.name), torch.Tensor)
                   for f in dataclasses.fields(self))

    def to_settings(self):
        """Back to the wire format (short multiband spelling); tensor
        sliders become floats."""
        out = {
            "saturation": _num(self.saturation),
            "bass_boost": _num(self.bass_boost),
            "mid_cut": _num(self.mid_cut),
            "presence_boost": _num(self.presence_boost),
            "treble_boost": _num(self.treble_boost),
            "width": _num(self.width),
            "lufs": _num(self.lufs) if self.lufs_enabled else None,
            "multiband": bool(self.multiband),
        }
        for short, _, _ in _MB_KEYS:
            out[short] = _num(getattr(self, short))
        return out

    def band_params(self):
        """The compressor's (low, mid, high) band sliders."""
        return (CompressorBandParams(self.low_thresh, self.low_ratio),
                CompressorBandParams(self.mid_thresh, self.mid_ratio),
                CompressorBandParams(self.high_thresh, self.high_ratio))


def settings_from_params(params):
    """``params.to_settings()``: the wire settings dict."""
    return params.to_settings()


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static chain configuration (the fields this port reads)."""

    sample_rate: int = 44100
    variant: str = "worker"          # "worker" | "legacy" (monolith service)
    dtype: str = "float32"
    # IIR execution: "auto" | "scan" | "blocked" (see channel_major and
    # ops.iir.uses_scan)
    filter_method: str = "auto"
    block_size: int = 512
    comp_hop: int = 1
    comp_block_ctrl: int | None = None
    comp_overlap_ctrl: int | None = None
    # "auto"/"pallas" exact (collapse), "scan" exact (serial), "blocked"
    # the block-parallel approximation of comp_block_ctrl-step blocks
    comp_ballistics: str = "auto"
    measure_downmix: str = "reference_mono_mean"   # | "bs1770"
    limiter_threshold: float = 0.98
    limiter_mode: str = "reference"  # | "lookahead_truepeak" (quality)
    # the streamed runners keep input, pass-A chunks and outputs on the
    # device while they fit; past it they stream and spill to the host
    device_budget_bytes: int = 6 << 30

    def torch_dtype(self):
        return getattr(torch, self.dtype)

    def channel_major(self, n_frames: int) -> bool:
        """The JAX package's gate of its rows body (``_master_cm`` and the
        streamed runners' rows chunk): the worker variant, a
        blocked-capable ``filter_method`` and at least ``4 ·
        block_size`` frames.  Where it fails, the JAX package runs its
        row-major body, in which each filter stage picks the exact scan or
        the blocked filter by ``ops.iir.uses_scan``; the port keeps its
        rows body and switches those stages to the scan kernel
        (``models.chain.MasteringChain.stage_scans``).  JAX's ``layout``
        knob is not ported."""
        return (self.variant == "worker"
                and self.filter_method in ("auto", "blocked")
                and n_frames >= 4 * self.block_size)

    @classmethod
    def gpu_default(cls, sample_rate=44100):
        """The JAX package's ``tpu_default`` knobs: blocked filters, block
        384, hop-8 detector, 2048-step ballistics control blocks."""
        return cls(sample_rate=sample_rate, filter_method="blocked",
                   block_size=384, comp_hop=8, comp_block_ctrl=2048)

    @classmethod
    def gpu_fast(cls, sample_rate=44100):
        """The JAX package's ``tpu_fast`` knobs: block 384, hop-16
        detector, 1024-step ballistics control blocks with an overlap of
        1102 (the block-parallel execution reads them, ``comp_ballistics=
        "blocked"``; the default exact ballistics do not)."""
        return cls(sample_rate=sample_rate, filter_method="blocked",
                   block_size=384, comp_hop=16, comp_block_ctrl=1024,
                   comp_overlap_ctrl=1102)
