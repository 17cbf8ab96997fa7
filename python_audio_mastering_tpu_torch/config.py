"""Typed configuration: the settings-dict wire contract as plain dataclasses.

Counterpart of ``python_audio_mastering_tpu.config``.  The settings dict
arrives with two key spellings for the multiband knobs (the GUI's
``low_band_threshold`` and the worker's ``low_thresh``);
:meth:`MasteringParams.from_settings` accepts both, the short spelling
winning when both are present.

The port keeps no ``mb_kernel`` or ``layout`` field: a kernel is chosen by
the device of the tensor it is given (see ``ops.cuda_multiband``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MasteringParams", "ChainConfig"]

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

    def to_settings(self):
        """Back to the wire format (short multiband spelling)."""
        out = {
            "saturation": float(self.saturation),
            "bass_boost": float(self.bass_boost),
            "mid_cut": float(self.mid_cut),
            "presence_boost": float(self.presence_boost),
            "treble_boost": float(self.treble_boost),
            "width": float(self.width),
            "lufs": float(self.lufs) if self.lufs_enabled else None,
            "multiband": bool(self.multiband),
        }
        for short, _, _ in _MB_KEYS:
            out[short] = float(getattr(self, short))
        return out


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static chain configuration (the fields this port reads)."""

    sample_rate: int = 44100
    variant: str = "worker"          # "worker" | "legacy" (not ported yet)
    dtype: str = "float32"
    block_size: int = 512
    comp_hop: int = 1
    comp_block_ctrl: int | None = None
    comp_overlap_ctrl: int | None = None
    comp_ballistics: str = "auto"
    measure_downmix: str = "reference_mono_mean"   # | "bs1770"
    limiter_threshold: float = 0.98
    limiter_mode: str = "reference"  # | "lookahead_truepeak" (not ported yet)

    def torch_dtype(self):
        return getattr(torch, self.dtype)

    @classmethod
    def gpu_default(cls, sample_rate=44100):
        """The JAX package's ``tpu_default`` knobs: block 384, hop-8
        detector, 2048-step ballistics control blocks."""
        return cls(sample_rate=sample_rate, block_size=384, comp_hop=8,
                   comp_block_ctrl=2048)
