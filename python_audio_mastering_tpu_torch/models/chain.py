"""The worker-variant mastering chain over the rows form, in PyTorch.

Counterpart of ``python_audio_mastering_tpu.models.chain`` (the
rows-resident body ``_master_cm``):

    saturate → 4-band EQ → stereo width → [3-band multiband compressor] →
    BS.1770 gated loudness → gain → soft limiter

The signal is folded into rows ``(C, nb, L)`` of ``L = block_size``
samples, zero-padded to a block multiple.  Kernels carry the path:
``front_chain`` (saturate + EQ + width in one pass), the multiband
compressor's ``band_energies``, ballistics and ``band_gain_apply``
(``ops.multiband``), and ``kweight_cells`` (the loudness meter's
K-weighted cell energies).  The loudness meter's mono downmix comes from
the last kernel before it: ``band_gain_apply`` with multiband on,
``front_chain`` without.  The per-block filter states between kernels
come from plain-torch states passes (``ops.iir``).  On a CUDA tensor the
kernels launch; on a CPU tensor their plain versions run.  Nothing in the
chain is random.

Signals shorter than ``4 · block_size`` take the same rows body, padded to
a block multiple (the JAX package sends them to a separate row-major
body); the result is the same filter, cut back to the input length.

:class:`MasteringChain` holds the float64-built operators as buffers: the
K-weighting ``T``/``G``/``W``/``A^L`` and a small cache of EQ operators
keyed by the EQ coefficients.  :func:`master` is a thin function over it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops.biquad import (
    reference_peak_sos,
    reference_shelf_sos,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import front_chain
from python_audio_mastering_tpu_torch.ops.loudness import (
    gain_for_target,
    integrated_loudness_rows,
    kweight_sos,
)
from python_audio_mastering_tpu_torch.ops.multiband import (
    crossover_ops,
    multiband_compress_rows,
)
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    saturate,
    soft_limiter,
)

__all__ = ["master", "MasterResult", "MasteringChain", "eq_sos",
           "check_supported", "check_fp32_matmul", "require_device"]

_EQ_CACHE_SIZE = 16


@dataclasses.dataclass
class MasterResult:
    """Chain output and the loudness it measured and corrected."""

    audio: Any
    measured_lufs: Any   # loudness before normalization
    applied_gain_db: Any


def eq_sos(params: MasteringParams, sample_rate: int):
    """The worker EQ as one 4-section cascade, float64 ``(4, 6)``.

    low shelf @250 (bass), peak @1k (−mid_cut), peak @4k (presence), high
    shelf @8k (treble), with the reference's doubled-w0 quirk.
    """
    return np.concatenate([
        reference_shelf_sos(sample_rate, 250.0, params.bass_boost, "low"),
        reference_peak_sos(sample_rate, 1000.0, -float(params.mid_cut)),
        reference_peak_sos(sample_rate, 4000.0, params.presence_boost),
        reference_shelf_sos(sample_rate, 8000.0, params.treble_boost, "high"),
    ], axis=0)


def check_supported(params: MasteringParams, config: ChainConfig):
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    if config.variant != "worker":
        raise NotImplementedError(
            f"variant={config.variant!r}: the legacy chain is ROADMAP "
            "queue 1 item 5")
    if config.limiter_mode != "reference":
        raise NotImplementedError(
            f"limiter_mode={config.limiter_mode!r} (the 'quality' key): the "
            "lookahead true-peak limiter is ROADMAP queue 1 item 5")


def require_device(device, what: str):
    """The ``torch.device`` an entry point runs on.  Every entry point
    defaults to ``"cuda"``; without a card that request raises, naming the
    missing device, and never runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(device)!r} requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return dev


def check_fp32_matmul(device):
    """The loudness gating and the kernels' plain twins multiply in
    float32 on the card and must do so in full precision: refuse to run
    with TF32 matmuls enabled (TF32 keeps ~3 decimal digits)."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


class MasteringChain(nn.Module):
    """The worker chain for one :class:`ChainConfig`.

    Buffers: the K-weighting blocked operators (float64-built; ``T``/``W``
    cast to the config dtype, ``G``/``A^L`` kept float64 for the states
    pass), moved with the module by ``.to(device)``.  EQ operators
    depend on the sliders and are cached per EQ coefficient set and device
    (the last few); the boundary-prefix operators of both filters are kept
    beside them.  The crossover operators are built per device at first
    use.
    """

    def __init__(self, config: ChainConfig):
        super().__init__()
        self.config = config
        dt = config.torch_dtype()
        kw = iir.blocked_ops(kweight_sos(config.sample_rate),
                             config.block_size, "cpu", dt)
        for name in ("t", "g", "w", "al"):
            self.register_buffer(f"kw_{name}", getattr(kw, name).clone())
        self._kw_al64 = kw.al64
        self._kw_k = kw.k
        self._kw_prefix = {}
        self._eq_cache = collections.OrderedDict()
        self._xover = {}

    @property
    def device(self):
        return self.kw_t.device

    def kweight_ops(self):
        return iir.BlockedOps(self.kw_t, self.kw_g, self.kw_w, self.kw_al,
                              self._kw_al64, self._kw_k, self._kw_prefix)

    def eq_ops(self, params: MasteringParams):
        """EQ operators for ``params``.  The coefficients are rounded to
        the working dtype first (the JAX chain casts its EQ sos to float32
        before building its operators), then built in float64."""
        dt = self.config.torch_dtype()
        sos = eq_sos(params, self.config.sample_rate)
        sos = sos.astype(self.config.dtype).astype(np.float64)
        key = (sos.tobytes(), self.device)
        ops = self._eq_cache.get(key)
        if ops is None:
            ops = iir.blocked_ops(sos, self.config.block_size, self.device, dt)
            self._eq_cache[key] = ops
            if len(self._eq_cache) > _EQ_CACHE_SIZE:
                self._eq_cache.popitem(last=False)
        else:
            self._eq_cache.move_to_end(key)
        return ops

    def crossover_ops(self):
        """The multiband crossovers' blocked operators on this chain's
        device (built at first use)."""
        ops = self._xover.get(self.device)
        if ops is None:
            ops = crossover_ops(self.config.sample_rate,
                                self.config.block_size, self.device)
            self._xover[self.device] = ops
        return ops

    def multiband(self, xrows, params: MasteringParams, state=None,
                  return_state: bool = False, emit_mono: bool = False):
        """The 3-band compressor over rows
        (``ops.multiband.multiband_compress_rows``) with this chain's
        config and crossover operators.  ``state``/``return_state``: the
        carried multiband state dict of streaming."""
        cfg = self.config
        return multiband_compress_rows(
            xrows, cfg.sample_rate,
            thresholds_db=(params.low_thresh, params.mid_thresh,
                           params.high_thresh),
            ratios=(params.low_ratio, params.mid_ratio, params.high_ratio),
            hop=cfg.comp_hop, ballistics=cfg.comp_ballistics, state=state,
            return_state=return_state, emit_mono=emit_mono,
            ops=self.crossover_ops())

    def front(self, xrows, params: MasteringParams, state=None,
              return_state: bool = False, emit_mono: bool = False):
        """saturate → EQ → width over rows (``chain._front``).

        The EQ states come from the SATURATED signal; the kernel reads the
        raw one and saturates as it loads.  ``state``/``return_state``:
        the carried EQ ``zi`` (scipy layout ``(K, 2, C)``) of streaming.
        ``emit_mono``: also return the channel-mean rows ``(nb, L)``.

        Returns ``y``, ``(y, ym)`` with ``emit_mono``, and ``eq_zf``
        appended with ``return_state``.
        """
        c = xrows.shape[0]
        ops = self.eq_ops(params)
        xs = saturate(xrows, params.saturation)
        s_in, eq_zf, _ = iir.sosfilt_states_rows(
            None, xs, zi=state, return_state=return_state, ops=ops)
        emit = emit_mono and c > 1
        y = front_chain(xrows, s_in, ops.t, ops.w, params.saturation,
                        params.width, emit_mono=emit)
        if emit:
            y, ym = y
        elif emit_mono:
            ym = y[0]  # mono input: the signal is its own downmix
        if emit_mono:
            return (y, ym, eq_zf) if return_state else (y, ym)
        return (y, eq_zf) if return_state else y

    def forward(self, audio, params: MasteringParams,
                return_result: bool = False):
        """Master ``(N, C)`` or ``(N,)`` audio (numpy or tensor) on this
        module's device.  Returns the mastered tensor, or a
        :class:`MasterResult` with ``return_result``."""
        cfg = self.config
        check_supported(params, cfg)
        check_fp32_matmul(self.device)
        x = torch.as_tensor(audio).to(device=self.device,
                                      dtype=cfg.torch_dtype())
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"audio must be (N, C) or (N,) with N > 0, got "
                             f"shape {tuple(torch.as_tensor(audio).shape)}")
        n, c = x.shape
        L = cfg.block_size
        nb = -(-n // L)
        xr = torch.nn.functional.pad(x.T, (0, nb * L - n)).reshape(c, nb, L)

        want_mono = (params.lufs_enabled and c > 1
                     and cfg.measure_downmix == "reference_mono_mean")
        meter_rows = None
        if params.multiband:
            xr = self.multiband(self.front(xr, params), params,
                                emit_mono=want_mono)
            if want_mono:
                xr, meter_rows = xr
        elif want_mono:
            xr, meter_rows = self.front(xr, params, emit_mono=True)
        else:
            xr = self.front(xr, params)

        if params.lufs_enabled:
            measured = integrated_loudness_rows(
                meter_rows[None] if meter_rows is not None else xr,
                cfg.sample_rate, downmix=cfg.measure_downmix,
                valid_frames=n, ops=self.kweight_ops())
            gain = gain_for_target(measured, params.lufs)
            xr = xr * gain
            gain_db = 20.0 * torch.log10(gain)
        else:
            measured = torch.tensor(float("nan"), dtype=xr.dtype,
                                    device=xr.device)
            gain_db = torch.zeros((), dtype=xr.dtype, device=xr.device)

        y = soft_limiter(xr, threshold=cfg.limiter_threshold)
        y = y.reshape(c, nb * L).T[:n]
        if squeeze:
            y = y[:, 0]
        if return_result:
            return MasterResult(audio=y, measured_lufs=measured,
                                applied_gain_db=gain_db)
        return y


def master(audio, params: MasteringParams, config: ChainConfig,
           return_result: bool = False, device="cuda"):
    """Run the mastering chain on ``(N, C)`` or ``(N,)`` float audio.

    ``device``: where to run, the card unless the caller passes
    ``device="cpu"``; raises when no card is there (see
    :func:`require_device`).  Every length takes the rows body: a signal
    shorter than ``4 · block_size`` is padded to whole blocks like any
    other.
    """
    device = require_device(device, "master")
    chain = MasteringChain(config).to(device)
    return chain(audio, params, return_result=return_result)
