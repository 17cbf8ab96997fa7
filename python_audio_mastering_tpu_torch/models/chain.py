"""The mastering chain over the rows form, in PyTorch, both variants.

Counterpart of ``python_audio_mastering_tpu.models.chain`` (the
rows-resident body ``_master_cm``, and for ``variant="legacy"`` the body
of its ``master``):

    saturate → 4-band EQ → stereo width → [3-band multiband compressor] →
    BS.1770 gated loudness → gain → soft limiter (or, in quality mode,
    the lookahead true-peak limiter of ``ops.limiter``)

The legacy chain (the reference's monolith service, main.py:94-192) has
its own stages: ``tanh(g·x)/g`` saturation, an EQ of four serial blends
of the signal with a Butterworth filter of it (:meth:`MasteringChain.
legacy_eq`, plain torch: no TPU kernel computes it), the legacy
multiband split and a tanh limiter.  One-shot (:func:`master`, and the
album of ``parallel.batch.master_album``) it runs that EQ; the streamed
runner runs the worker EQ cascade behind the legacy saturation instead,
as the JAX streamed runner does (a quirk of the reference, ROADMAP queue
3): there the front is one ``front_chain`` launch with the legacy
exciter.

The signal is folded into rows ``(C, nb, L)`` of ``L = block_size``
samples, zero-padded to a block multiple.  Kernels carry the path:
``front_chain`` (saturate + EQ + width in one pass), the multiband
compressor's ``band_energies``, ballistics and ``band_gain_apply``
(``ops.multiband``), and ``kweight_cells`` (the loudness meter's
K-weighted cell energies).  On a CUDA float32 signal with the reference
limiter, ``gain_limit`` (``ops.gain_limit``) ends it: each track's
loudness gain, the soft limiter and the unfold to ``(T, N, C)`` in one
pass; elsewhere (the CPU, float64, the lookahead limiter) those stay
separate plain ops, and the lookahead limiter runs track by track, each
cut to its own length (:meth:`MasteringChain.limiter`).  The loudness
meter's mono downmix comes from the last kernel before it:
``band_gain_apply`` with multiband on, ``front_chain`` without.  The
per-block filter states between kernels come from plain-torch states
passes (``ops.iir``).  On a CUDA tensor the kernels launch; on a CPU
tensor their plain versions run.  Nothing in the chain is random.  The
stages open ``utils.tracing`` spans: ``chain`` (the whole of
:meth:`MasteringChain.forward_tracks`), ``front``, ``multiband``,
``loudness`` and ``limiter``, and inside them the ops' ``states`` and
``detector`` and the lookahead limiter's ``truepeak``, ``attack`` and
``release``.

An album chunk ``(C, T, nb, L)`` takes the same body with T sequences of
params (:meth:`MasteringChain.front`, :meth:`MasteringChain.multiband`):
the kernels compute each block from that block and its incoming state,
so the tracks fold into their block axis and each launches once for all
of them (``parallel.batch``).

The exact filter path.  Where the JAX package leaves its rows body
(``ChainConfig.channel_major`` fails: ``filter_method="scan"``, the legacy
variant, or fewer than ``4 · block_size`` frames) it runs a row-major
body in which each filter stage picks the exact scan or the blocked
filter by ``iir.sosfilt``'s rule.  The port keeps its one rows body and
switches each stage the same way (:meth:`MasteringChain.stage_scans`): a
stage that JAX scans runs the scan kernel K8 (``ops.sos_scan``) over the
same rows tensor, each ``(channel, track)`` a contiguous run of ``nb·L``
samples whose zero padding lies after its last valid sample, followed by
the plain torch the JAX body runs there (saturation before the EQ scan,
the width, the multiband detector and gain apply, the K-weighted cell
sums); a stage that JAX runs blocked stays on the rows kernels.

:class:`MasteringChain` holds the float64-built operators as buffers: the
K-weighting ``T``/``G``/``W``/``A^L`` and a small cache of EQ operators
keyed by the EQ coefficients.  :func:`master` is a thin function over it.

Sliders given as tensors (``models.automaster`` differentiates the chain
through them) take the chain's tensor route: the EQ is designed from them
in the graph (``ops.biquad`` on tensors), its operators are built in the
graph (``iir.blocked_ops_traced``; the EQ cache is neither read nor
written), the exciter, width and legacy blends keep them as tensors, and
``front_chain`` and ``kweight_cells`` run under autograd (their forward is
the kernel, their backward plain torch).  Nothing on this route calls
``float()`` on a slider or builds a cache key.  The multiband compressor
has no gradient in the port (the automaster leaves it off, as JAX's latent
space does): tensor sliders with multiband on are refused.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops._kernels import upload
from python_audio_mastering_tpu_torch.ops.biquad import (
    butter_sos,
    reference_peak_sos,
    reference_shelf_sos,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import front_chain
from python_audio_mastering_tpu_torch.ops.gain_limit import gain_limit
from python_audio_mastering_tpu_torch.ops.limiter import lookahead_limiter
from python_audio_mastering_tpu_torch.ops.lookahead_limit import (
    MAX_LOOK,
    look_frames,
)
from python_audio_mastering_tpu_torch.ops.loudness import (
    _gating_geometry,
    block_cell_energies_rows,
    gain_for_target,
    kweight_sos,
    loudness_from_cells,
)
from python_audio_mastering_tpu_torch.ops.multiband import (
    BALLISTICS,
    VARIANTS,
    crossover_ops,
    multiband_compress_rows,
)
from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    exciter,
    exciter_coefs,
    saturate_legacy,
    soft_limiter,
    soft_limiter_legacy,
)
from python_audio_mastering_tpu_torch.utils.tracing import span

__all__ = ["master", "make_master_fn", "MasterResult", "MasteringChain",
           "cached_chain", "eq_sos", "apply_eq", "legacy_eq_sos",
           "check_supported", "check_fp32_matmul", "require_device"]

_EQ_CACHE_SIZE = 16
_EQ_SECTIONS = 4   # the worker EQ's cascade (eq_sos)
_LIMITER_MODES = ("reference", "lookahead_truepeak")


@dataclasses.dataclass
class MasterResult:
    """Chain output and the loudness it measured and corrected."""

    audio: Any
    measured_lufs: Any   # loudness before normalization
    applied_gain_db: Any


def eq_sos(params: MasteringParams, sample_rate: int):
    """The worker EQ as one 4-section cascade, float64 ``(4, 6)``.

    low shelf @250 (bass), peak @1k (−mid_cut), peak @4k (presence), high
    shelf @8k (treble), with the reference's doubled-w0 quirk.  A numpy
    array, or a tensor in the graph when a gain is a tensor.
    """
    gains = (params.bass_boost, params.mid_cut, params.presence_boost,
             params.treble_boost)
    like = next((g for g in gains if isinstance(g, torch.Tensor)), None)
    if like is not None:
        gains = tuple(g if isinstance(g, torch.Tensor)
                      else torch.tensor(float(g), dtype=torch.float64,
                                        device=like.device) for g in gains)
    bass, mid, presence, treble = gains
    rows = [reference_shelf_sos(sample_rate, 250.0, bass, "low"),
            reference_peak_sos(sample_rate, 1000.0, -mid),
            reference_peak_sos(sample_rate, 4000.0, presence),
            reference_shelf_sos(sample_rate, 8000.0, treble, "high")]
    return (np.concatenate(rows, axis=0) if like is None
            else torch.cat(rows, dim=0))


def apply_eq(x, params, config, zi=None):
    """The worker EQ over ``(N,)`` or ``(N, C)`` audio (JAX ``apply_eq``):
    one cascade in the signal's dtype through ``iir.sosfilt`` with the
    config's ``filter_method`` and ``block_size`` (the exact scan, K8, or
    the blocked filter).  Returns ``(y, zf)``."""
    x = torch.as_tensor(x)
    sos = torch.as_tensor(eq_sos(params, config.sample_rate)).to(
        device=x.device, dtype=x.dtype)
    return iir.sosfilt(sos, x, zi=zi, method=config.filter_method,
                       block_size=config.block_size)


@functools.lru_cache(maxsize=8)
def legacy_eq_sos(sample_rate: int):
    """The legacy EQ's four static Butterworth filters, float64 (main.py:
    118-154): the 250 Hz order-5 low-pass and 8 kHz order-5 high-pass of
    the shelves, the order-2 band-passes around 1 kHz and 4 kHz (Q 1) of
    the peaks.  The sliders set only the blends."""
    def band(fc, q=1.0):
        normal = fc / (0.5 * sample_rate)
        e1, e2 = normal / np.sqrt(q), normal * np.sqrt(q)
        return butter_sos(2, [min(e1, e2), min(max(e1, e2), 0.999999)],
                          "bandpass")

    return (butter_sos(5, 250.0 / (0.5 * sample_rate), "lowpass"),
            band(1000.0), band(4000.0),
            butter_sos(5, 8000.0 / (0.5 * sample_rate), "highpass"))


def _db_gain(gain_db, dtype=torch.float32):
    """``10^(gain_db/20)`` in ``dtype`` (the signal's), as the JAX chain
    computes it; of a tensor gain, a tensor."""
    if isinstance(gain_db, torch.Tensor):
        return 10.0 ** (gain_db.to(dtype) / 20.0)
    return float(10.0 ** (torch.tensor(float(gain_db), dtype=dtype) / 20.0))


def check_supported(params: MasteringParams, config: ChainConfig):
    """Raise ``ValueError`` for a variant, a filter method, a ballistics
    execution or a limiter mode that does not exist, and for the quality
    limiter at a sample rate whose look-ahead K10 cannot take."""
    if config.variant not in VARIANTS:
        raise ValueError(f"unknown variant {config.variant!r}: one of "
                         f"{VARIANTS}")
    if config.filter_method not in iir.METHODS:
        raise ValueError(f"unknown filter_method {config.filter_method!r}: "
                         f"one of {iir.METHODS}")
    if config.comp_ballistics not in BALLISTICS:
        raise ValueError(f"unknown comp_ballistics "
                         f"{config.comp_ballistics!r}: one of {BALLISTICS}")
    if config.limiter_mode not in _LIMITER_MODES:
        raise ValueError(f"unknown limiter_mode {config.limiter_mode!r}: "
                         f"one of {_LIMITER_MODES}")
    # the chain's lookahead limiter looks 1.5 ms ahead (its default); K10
    # takes at most MAX_LOOK frames, so a rate past ~910 kHz is refused
    if (config.limiter_mode == "lookahead_truepeak"
            and look_frames(config.sample_rate, 1.5) > MAX_LOOK):
        raise ValueError(f"limiter_mode 'lookahead_truepeak' at "
                         f"{config.sample_rate} Hz: the limiter's 1.5 ms "
                         f"look-ahead is over the kernel's {MAX_LOOK} "
                         f"frames")


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
    """The loudness gating, the kernels' plain twins, the true-peak
    interpolator and the resampler multiply in float32 on the card and
    must do so in full precision: refuse to run with TF32 matmuls enabled
    (TF32 keeps ~3 decimal digits)."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


class MasteringChain(nn.Module):
    """The mastering chain for one :class:`ChainConfig`.

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
        self._legacy_eq = {}

    @property
    def device(self):
        return self.kw_t.device

    def kweight_ops(self):
        return iir.BlockedOps(self.kw_t, self.kw_g, self.kw_w, self.kw_al,
                              self._kw_al64, self._kw_k, self._kw_prefix)

    def eq_ops(self, params: MasteringParams):
        """EQ operators for ``params``.  The coefficients are rounded to
        the working dtype first (the JAX chain casts its EQ sos to float32
        before building its operators), then built in float64.  Tensor
        gains: built in the graph on this chain's device, not cached."""
        dt = self.config.torch_dtype()
        sos = eq_sos(params, self.config.sample_rate)
        if isinstance(sos, torch.Tensor):
            sos = sos.to(self.device).to(dt).to(torch.float64)
            return iir.blocked_ops_traced(sos, self.config.block_size, dt)
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
        device (built at first use; the legacy split's three)."""
        ops = self._xover.get(self.device)
        if ops is None:
            ops = crossover_ops(self.config.sample_rate,
                                self.config.block_size, self.device,
                                variant=self.config.variant,
                                dtype=self.config.torch_dtype())
            self._xover[self.device] = ops
        return ops

    def legacy_eq_ops(self):
        """The legacy EQ's four filters' blocked operators on this chain's
        device (float64-built; built at first use)."""
        ops = self._legacy_eq.get(self.device)
        if ops is None:
            ops = tuple(iir.blocked_ops(s, self.config.block_size,
                                        self.device, self.config.torch_dtype())
                        for s in legacy_eq_sos(self.config.sample_rate))
            self._legacy_eq[self.device] = ops
        return ops

    def stage_scans(self, n_frames: int):
        """``(eq, crossovers, kweighting)``: which filter stages of a
        signal (or chunk) of ``n_frames`` take the exact scan, as the JAX
        package's ``master()`` picks them: none in its rows body
        (``config.channel_major(n_frames)``); else, in its row-major body,
        each by ``iir.sosfilt``'s rule (:func:`iir.uses_scan`), the EQ at
        the config's block, the crossovers and the K-weighting at the
        default 512."""
        cfg = self.config
        if cfg.channel_major(n_frames):
            return False, False, False
        m = cfg.filter_method
        fixed = iir.uses_scan(m, n_frames, iir.DEFAULT_BLOCK)
        return iir.uses_scan(m, n_frames, cfg.block_size), fixed, fixed

    def legacy_eq(self, xrows, params, scan: bool = False):
        """The legacy EQ (JAX ``_apply_eq_legacy``) over stereo rows ``(2,
        nb, L)`` (or ``(2·T, nb, L)``, T tracks of one setting): four serial
        stages, each a blend of its input with one filter of it: blocked
        (float64 states pass, float32 ``x @ T + s_in @ Wᵀ``) or, with
        ``scan``, the scan kernel over each row's ``nb·L`` samples.  The
        shelves blend ``x + F·(g−1)`` for a boost and ``x·g + F·(1−g)`` for
        a cut (a host branch on the slider; a ``where`` for a tensor
        slider, as JAX's), the peaks ``x + F·(g−1)``."""
        if scan:
            stages = legacy_eq_sos(self.config.sample_rate)
        else:
            stages = self.legacy_eq_ops()
        shelf_lo, peak_1k, peak_4k, shelf_hi = stages

        def filtered(x, stage):
            if scan:
                r = x.shape[0]
                return sos_scan(x.reshape(r, -1), [stage])[0][0].reshape(
                    x.shape)
            return iir.sosfilt_blocked_rows(None, x, return_state=False,
                                            ops=stage)[0]

        def shelf(x, ops, gain_db):
            g = _db_gain(gain_db, x.dtype)
            if isinstance(gain_db, torch.Tensor):
                f = filtered(x, ops)
                return torch.where(gain_db > 0, x + f * (g - 1.0),
                                   x * g + f * (1.0 - g))
            if float(gain_db) > 0:
                return x + filtered(x, ops) * (g - 1.0)
            return x * g + filtered(x, ops) * (1.0 - g)

        def peak(x, ops, gain_db):
            return x + filtered(x, ops) * (_db_gain(gain_db, x.dtype) - 1.0)

        x = shelf(xrows, shelf_lo, params.bass_boost)
        x = peak(x, peak_1k, -params.mid_cut)
        x = peak(x, peak_4k, params.presence_boost)
        return shelf(x, shelf_hi, params.treble_boost)

    @span("multiband")
    def multiband(self, xrows, params, state=None,
                  return_state: bool = False, emit_mono: bool = False,
                  scan: bool = False):
        """The 3-band compressor over rows
        (``ops.multiband.multiband_compress_rows``) with this chain's
        config and crossover operators; an album's ``(C, T, nb, L)`` takes
        a sequence of T params.  ``state``/``return_state``: the carried
        multiband state dict of streaming.  ``scan``: the exact crossovers
        (see :meth:`stage_scans`)."""
        cfg = self.config
        tp = params if xrows.ndim == 4 else [params]

        def sliders(*names):
            return tuple([float(getattr(p, k)) for p in tp] for k in names)

        return multiband_compress_rows(
            xrows, cfg.sample_rate,
            thresholds_db=sliders("low_thresh", "mid_thresh", "high_thresh"),
            ratios=sliders("low_ratio", "mid_ratio", "high_ratio"),
            hop=cfg.comp_hop, block_ctrl=cfg.comp_block_ctrl,
            overlap_ctrl=cfg.comp_overlap_ctrl,
            ballistics=cfg.comp_ballistics, state=state,
            return_state=return_state, emit_mono=emit_mono,
            ops=None if scan else self.crossover_ops(), variant=cfg.variant,
            scan=scan)

    def front_groups(self, tracks_params, legacy_eq: bool = False,
                     scan: bool = False):
        """The tracks of an album grouped by their front settings (EQ
        sliders, saturation, width), which ``front_chain`` takes one of per
        launch: ``[(params, track indices, EQ operators), ...]``.  A run
        computes them once and holds the operators to its end.
        ``legacy_eq``: groups of the one-shot legacy front, and ``scan``:
        of the scanned front (no EQ operators: the first's filters are
        static, the second needs none).  Tensor sliders group by the
        params object (the automaster's shared θ is one group, a θ per
        track one group a track), their operators built in the graph."""
        groups = {}
        no_ops = legacy_eq or scan
        if tracks_params[0].has_tensors():
            for i, p in enumerate(tracks_params):
                groups.setdefault(id(p), (p, []))[1].append(i)
            return [(p, idx, None if no_ops else self.eq_ops(p))
                    for p, idx in groups.values()]
        for i, p in enumerate(tracks_params):
            if legacy_eq:
                eq = (float(p.bass_boost), float(p.mid_cut),
                      float(p.presence_boost), float(p.treble_boost))
            else:
                eq = eq_sos(p, self.config.sample_rate).astype(
                    self.config.dtype).tobytes()
            key = (eq, float(p.saturation), float(p.width))
            groups.setdefault(key, (p, []))[1].append(i)
        return [(p, idx, None if no_ops else self.eq_ops(p))
                for p, idx in groups.values()]

    def _front_group(self, x4, params, ops, zi, return_state, emit,
                     legacy_eq=False, scan=False):
        """:meth:`front` of ``(C, T, nb, L)`` tracks that share ``params``:
        one states pass over the ``C·T`` sequences, one kernel launch over
        ``(C, T·nb, L)``; or the one-shot legacy front (``legacy_eq``), or
        the scanned front (``scan``).  Returns ``(y, mono (T, nb, L) or
        None, zf)``."""
        c, tracks, nb, L = x4.shape
        if legacy_eq:
            return self._legacy_front_group(x4, params, emit, scan)
        coefs = exciter_coefs(params.saturation, self.config.variant,
                              self.config.torch_dtype())
        if scan:
            return self._scan_front_group(x4, params, coefs, zi,
                                          return_state, emit)
        xs = exciter(x4, coefs).reshape(c * tracks, nb, L)
        s_in, zf, _ = iir.sosfilt_states_rows(
            None, xs, zi=zi, return_state=return_state, ops=ops)
        y = front_chain(x4.reshape(c, tracks * nb, L),
                        s_in.reshape(c, tracks * nb, -1), ops.t, ops.w,
                        coefs, params.width, emit_mono=emit)
        ym = None
        if emit:
            y, ym = y
            ym = ym.reshape(tracks, nb, L)
        return y.reshape(x4.shape), ym, zf

    def _scan_front_group(self, x4, params, coefs, zi, return_state, emit):
        """The scanned front of ``(C, T, nb, L)`` tracks that share
        ``params`` (JAX ``master``'s row-major body): the exciter, the EQ
        cascade by the scan kernel over the ``C·T`` runs of ``nb·L``
        samples (``zi`` ``(K, 2, C·T)``), the width, plain torch around
        it.  Returns ``(y, mono or None, zf)``."""
        c, tracks, nb, L = x4.shape
        xs = exciter(x4, coefs).reshape(c * tracks, nb * L)
        sos = eq_sos(params, self.config.sample_rate)
        if isinstance(sos, torch.Tensor):
            sos = sos.to(self.device)
        y, (zf,) = sos_scan(xs, [sos], [zi])
        y = stereo_width(y[0].reshape(x4.shape), params.width,
                         channel_axis=0)
        return y, (y.mean(dim=0) if emit else None), (
            zf if return_state else zi)

    def _legacy_front_group(self, x4, params, emit, scan=False):
        """The one-shot legacy front of ``(C, T, nb, L)`` tracks that share
        ``params`` (JAX ``master``, legacy): ``saturate_legacy`` → the
        legacy EQ (stereo only; other inputs pass unprocessed; scanned with
        ``scan``) → width, plain torch.  Returns ``(y, mono or None,
        None)``."""
        c, tracks, nb, L = x4.shape
        x = saturate_legacy(x4, params.saturation)
        if c == 2:
            x = self.legacy_eq(x.reshape(c * tracks, nb, L), params,
                               scan=scan).reshape(x4.shape)
        y = stereo_width(x, params.width, channel_axis=0)
        return y, (y.mean(dim=0) if emit else None), None

    @span("front")
    def front(self, xrows, params, state=None, return_state: bool = False,
              emit_mono: bool = False, groups=None, legacy_eq: bool = False,
              scan: bool = False):
        """saturate → EQ → width over rows (``chain._front``).

        The EQ states come from the SATURATED signal; the kernel reads the
        raw one and saturates as it loads (with the legacy chain's exciter
        for a legacy config).  ``state``/``return_state``: the carried EQ
        ``zi`` (scipy layout ``(K, 2, C)``) of streaming.  ``emit_mono``:
        also return the channel-mean rows ``(nb, L)``.

        An album's ``(C, T, nb, L)`` takes a sequence of T params (``zi``
        ``(K, 2, C·T)``, mono ``(T, nb, L)``) and launches the kernel once
        per group of :meth:`front_groups` (pass ``groups`` to reuse them),
        on a gathered copy of the group's tracks when there are several.

        ``legacy_eq``: the one-shot legacy front instead
        (:meth:`_legacy_front_group`), which carries no state.  ``scan``:
        the EQ by the scan kernel (:meth:`_scan_front_group`, or the
        legacy EQ's filters scanned).

        Returns ``y``, ``(y, ym)`` with ``emit_mono``, and ``eq_zf``
        appended with ``return_state``.
        """
        album = xrows.ndim == 4
        x4 = xrows if album else xrows[:, None]
        c, tracks, nb, L = x4.shape
        groups = groups or self.front_groups(params if album else [params],
                                             legacy_eq, scan)
        emit = emit_mono and c > 1
        if len(groups) == 1:
            p, _, ops = groups[0]
            y, ym, eq_zf = self._front_group(x4, p, ops, state, return_state,
                                             emit, legacy_eq, scan)
        else:
            y = torch.empty_like(x4)
            ym = x4.new_empty((tracks, nb, L)) if emit else None
            stateless = legacy_eq     # the one-shot legacy front
            k = None if stateless else _EQ_SECTIONS
            zi4 = (None if state is None or stateless
                   else state.reshape(k, 2, c, tracks))
            zf4 = (x4.new_empty((k, 2, c, tracks))
                   if return_state and not stateless else None)
            for p, idx, ops in groups:
                sel = upload(idx, torch.int64, x4.device)
                zi = (None if zi4 is None else
                      zi4[:, :, :, sel].reshape(k, 2, c * len(idx)))
                yg, ymg, zfg = self._front_group(
                    x4[:, sel].contiguous(), p, ops, zi, return_state, emit,
                    legacy_eq, scan)
                y[:, sel] = yg
                if emit:
                    ym[sel] = ymg
                if zf4 is not None:
                    zf4[:, :, :, sel] = zfg.reshape(k, 2, c, len(idx))
            eq_zf = state if zf4 is None else zf4.reshape(k, 2, c * tracks)
        if emit_mono and not emit:
            ym = y[0]  # mono input: the signal is its own downmix
        y = y.reshape(xrows.shape)
        if emit_mono and not album:
            ym = ym[0]
        if emit_mono:
            return (y, ym, eq_zf) if return_state else (y, ym)
        return (y, eq_zf) if return_state else y

    def limiter(self, x):
        """The config's limiter: the variant's soft limiter at the config's
        threshold, pointwise on any shape; in quality mode the lookahead
        true-peak limiter of ``ops.limiter`` over the whole track ``x``
        ``(N, C)``, or over each row of ``(T, N, C)``, every row a whole
        track (the look-ahead replicates a track's own last sample)."""
        cfg = self.config
        if cfg.limiter_mode == "lookahead_truepeak":
            if x.ndim == 3:
                return torch.stack([lookahead_limiter(t, cfg.sample_rate)
                                    for t in x])
            return lookahead_limiter(x, cfg.sample_rate)
        lim = soft_limiter_legacy if cfg.variant == "legacy" \
            else soft_limiter
        return lim(x, threshold=cfg.limiter_threshold)

    def forward(self, audio, params: MasteringParams,
                return_result: bool = False, valid_frames=None):
        """Master ``(N, C)`` or ``(N,)`` audio (numpy or tensor) on this
        module's device.  ``valid_frames``: the loudness is measured over
        the first ``valid_frames`` samples only (a zero-padded track).
        Returns the mastered tensor, or a :class:`MasterResult` with
        ``return_result``."""
        x = torch.as_tensor(audio)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"audio must be (N, C) or (N,) with N > 0, got "
                             f"shape {tuple(torch.as_tensor(audio).shape)}")
        y, measured, gain_db = self.forward_tracks(
            x[None], params,
            None if valid_frames is None else [valid_frames])
        y, measured, gain_db = y[0], measured[0], gain_db[0]
        if squeeze:
            y = y[:, 0]
        if return_result:
            return MasterResult(audio=y, measured_lufs=measured,
                                applied_gain_db=gain_db)
        return y

    @span("chain")
    def forward_tracks(self, batch, params, valid_frames=None):
        """Master a batch ``(T, N, C)`` of tracks in one pass, the tracks
        folded into the kernels' block axis as an album chunk is: the
        front kernel launches once per group of equal front settings (once
        for a shared ``params``), the loudness kernel once for all.

        ``params``: one :class:`MasteringParams` for every track, or T of
        them (tensor sliders too: the automaster's batch).
        ``valid_frames``: T lengths; each track's loudness is measured over
        its first ones (all N when None), and in quality mode each track is
        limited to its own end, as its one-shot :func:`master` limits it,
        with zeros after it.  Returns ``(y (T, N, C), measured_lufs (T,),
        applied_gain_db (T,))``.
        """
        cfg = self.config
        x = torch.as_tensor(batch).to(device=self.device,
                                      dtype=cfg.torch_dtype())
        tracks, n, c = x.shape
        tp = ([params] * tracks if isinstance(params, MasteringParams)
              else list(params))
        first = tp[0]
        for p in tp:
            check_supported(p, cfg)
        check_fp32_matmul(self.device)
        if first.multiband and any(p.has_tensors() for p in tp):
            raise ValueError("tensor sliders with multiband on: the "
                             "multiband compressor has no gradient in the "
                             "port")
        L = cfg.block_size
        nb = -(-n // L)
        xr = torch.nn.functional.pad(x.permute(2, 0, 1),
                                     (0, nb * L - n)).reshape(c, tracks, nb, L)

        want_mono = (first.lufs_enabled and c > 1
                     and cfg.measure_downmix == "reference_mono_mean")
        legacy = cfg.variant == "legacy"
        eq_scan, xo_scan, kw_scan = self.stage_scans(n)
        groups = self.front_groups(tp, legacy, eq_scan)
        fr = dict(groups=groups, legacy_eq=legacy, scan=eq_scan)
        meter_rows = None
        if first.multiband:
            xr = self.multiband(self.front(xr, tp, **fr), tp,
                                emit_mono=want_mono, scan=xo_scan)
            if want_mono:
                xr, meter_rows = xr
        elif want_mono:
            xr, meter_rows = self.front(xr, tp, emit_mono=True, **fr)
        else:
            xr = self.front(xr, tp, **fr)

        fused = (xr.is_cuda and xr.dtype == torch.float32
                 and cfg.limiter_mode == "reference")
        vf = ([n] * tracks if valid_frames is None
              else [min(int(v), n) for v in valid_frames])
        if first.lufs_enabled:
            with span("loudness"):
                # the kernels' mono downmix, or a mono signal, is one row
                meter = meter_rows[None] if meter_rows is not None else xr
                cell_ms, _, _ = block_cell_energies_rows(
                    meter, cfg.sample_rate, ops=self.kweight_ops(),
                    scan=kw_scan)
                cell = _gating_geometry(cfg.sample_rate)[0]
                cells = torch.arange(cell_ms.shape[1], device=self.device)
                mask = cells[None] < upload([v // cell for v in vf],
                                            torch.int64, self.device)[:, None]
                measured = loudness_from_cells(cell_ms, cell_mask=mask)
                gain = gain_for_target(measured, upload(
                    [float(p.lufs) for p in tp], xr.dtype, self.device))
                if not fused:
                    xr = xr * gain.view(1, tracks, 1, 1)
                gain_db = 20.0 * torch.log10(gain)
        else:
            gain = None
            measured = torch.full((tracks,), float("nan"), dtype=xr.dtype,
                                  device=xr.device)
            gain_db = torch.zeros((tracks,), dtype=xr.dtype,
                                  device=xr.device)

        xr = xr.reshape(c, tracks, nb * L)
        with span("limiter"):
            if fused:
                y = gain_limit(xr, gain, n, cfg.limiter_threshold,
                               cfg.variant)
            elif cfg.limiter_mode == "lookahead_truepeak":
                # each track limited to its own end, zeros after it
                y = xr.new_empty((tracks, n, c))
                for i, v in enumerate(vf):
                    y[i, :v] = self.limiter(xr[:, i, :v].T)
                    y[i, v:] = 0.0
            else:
                y = self.limiter(xr[:, :, :n].permute(1, 2, 0))
        return y, measured, gain_db


def master(audio, params: MasteringParams, config: ChainConfig,
           return_result: bool = False, valid_frames=None, device="cuda"):
    """Run the mastering chain of ``config.variant`` on ``(N, C)`` or
    ``(N,)`` float audio.

    ``valid_frames``: for a zero-padded track, the loudness is measured
    over its first ``valid_frames`` samples, so the gated LUFS equals the
    unpadded track's.  ``device``: where to run, the card unless the
    caller passes ``device="cpu"``; raises when no card is there (see
    :func:`require_device`).  Every length takes the rows body, padded to
    whole blocks; its filter stages take the exact scan where the JAX
    package's ``master()`` does (:meth:`MasteringChain.stage_scans`).
    """
    device = require_device(device, "master")
    chain = MasteringChain(config).to(device)
    return chain(audio, params, return_result=return_result,
                 valid_frames=valid_frames)


@functools.lru_cache(maxsize=8)
def cached_chain(config: ChainConfig, device) -> MasteringChain:
    """One :class:`MasteringChain` per (config, device), kept between
    calls with its operator caches (``device`` a resolved
    ``torch.device``)."""
    return MasteringChain(config).to(device)


def make_master_fn(config: ChainConfig, return_result: bool = True,
                   device="cuda"):
    """``fn(audio, params)`` for a fixed config over one cached
    :class:`MasteringChain` on ``device`` (the card unless the caller
    passes ``device="cpu"``): a :class:`MasterResult` by default, the
    mastered tensor with ``return_result=False``."""
    chain = cached_chain(config, require_device(device, "make_master_fn"))

    def fn(audio, params):
        return chain(audio, params, return_result=return_result)

    return fn
