"""The port's blocked-IIR kernels and their plain PyTorch versions.

Counterpart of ``python_audio_mastering_tpu.ops.pallas_multiband``:

* :func:`front_chain` (CUDA ``csrc/front_chain.cu``) — the exciter of
  either chain variant → EQ from per-block states → stereo width, plus
  the mono downmix;
* :func:`kweight_cells` (CUDA ``csrc/kweight_cells.cu``) — K-weighting
  from per-block states → square → ``h``-bucket sums;
* :func:`band_energies` (CUDA ``csrc/band_energies.cu``) — the crossover
  bands from per-block states → channel-mean squared energies in
  ``hop``-buckets, the multiband detector's input;
* :func:`band_gain_apply` (CUDA ``csrc/band_gain_apply.cu``) — the bands
  again → recombination with the control-rate gains, plus the mono
  downmix.

All four compute their product on the tensor cores in 3xTF32 on Hopper's
``wgmma``, through ``csrc/tf32_wgmma.cuh`` (a warp-specialised ring fed by
bulk and TMA copies, a persistent grid): ``band_energies`` and
``band_gain_apply`` the two crossover filters' product in 64 columns of
each, ``front_chain`` the EQ's in 128-column tiles and ``kweight_cells``
the K-weighting's in 64-column tiles.  Each operator is split into its
TF32 parts once, here, and laid out as the kernels read it
(:func:`pack_operator`; :func:`crossover_packed` for the band kernels,
:func:`packed_operator` for the one-filter ones).  All four add their
states term ``s_in @ Wᵀ`` in fp32 on the CUDA cores (the K-weighting's
state operator is ~70 times the signal, the crossovers' up to ~4e4, and
3xTF32 would put ~1.3e-5 and ~7e-6 of the max on the product).

Each wrapper takes its plain version (``*_ref``) for a tensor on the CPU,
and launches its kernel for a CUDA tensor or raises: there is no fallback
on the card.  Each counts its kernel launches in ``<wrapper>.launches``
(only where it launches the kernel); :func:`reset_launch_counts` and
:func:`launch_counts` read and clear them for every kernel of the port,
the ballistics kernels of ``ops.ballistics``, the scan kernel of
``ops.sos_scan``, the tail kernel of ``ops.gain_limit`` and the lookahead
limiter's of ``ops.lookahead_limit`` included.

``front_chain`` and ``kweight_cells`` also run under autograd (the
automaster differentiates the chain through them): given an input that
requires grad, or a tensor exciter coefficient or width, they go through
a ``torch.autograd.Function`` whose forward is the same kernel launch (or,
on the CPU, the same plain version) and whose backward is the VJP written
out in plain torch, fp32 ``torch.matmul`` products on the card (the JAX
package has no backward kernel: XLA differentiates its plain mirror).  The
backward never launches a kernel and never calls a plain twin; the twins
count their calls in ``<twin>.calls`` (:func:`plain_calls`) so that a run
can show it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from python_audio_mastering_tpu_torch.ops import _kernels, ballistics
from python_audio_mastering_tpu_torch.ops.gain_limit import (
    gain_limit,
    gain_limit_ref,
)
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on
from python_audio_mastering_tpu_torch.ops._kernels import (
    wants_grad as _wants_grad,
)
from python_audio_mastering_tpu_torch.ops.lookahead_limit import (
    lookahead_limit,
)
from python_audio_mastering_tpu_torch.ops.sos_scan import (
    sos_scan,
    sos_scan_ref,
)
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    exciter,
    exciter_coefs,
)

__all__ = ["front_chain", "front_chain_ref", "kweight_cells",
           "kweight_cells_ref", "band_energies", "band_energies_ref",
           "band_gain_apply", "band_gain_apply_ref", "launch_counts",
           "reset_launch_counts", "plain_calls", "counts_plain_calls"]

# csrc/tf32_wgmma.cuh: a tile holds 128 rows, every channel of a block
# among them; the wrappers take L a multiple of 128 (K1's tile width) and
# at most 16 state columns (the one-filter kernels' 16 states; the band
# kernels hold 4 states a filter, _BAND_STATES)
_TF32_TILE_ROWS = 128
_TF32_TILE_COLS = 128
_TF32_STATE_DEPTH = 16
_FRONT_COLS = 128              # K1's column tile (csrc/front_chain.cu)
_CELLS_COLS = 64               # K4's column tile (csrc/kweight_cells.cu)


def front_chain_ref(xrows, s_in_eq, t_eq, w_eq, saturation, width,
                    emit_mono: bool = False):
    """Plain version of :func:`front_chain` (same algebra)."""
    front_chain_ref.calls += 1
    c, nb, L = xrows.shape
    xs = exciter(xrows, exciter_coefs(saturation, dtype=xrows.dtype)
                 ).reshape(c * nb, L)
    y = xs @ t_eq + s_in_eq.reshape(c * nb, -1) @ w_eq.T
    y = stereo_width(y.reshape(c, nb, L), width, channel_axis=0)
    if emit_mono:
        return y, y.mean(dim=0)
    return y


def kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop):
    """Plain version of :func:`kweight_cells` (same algebra)."""
    kweight_cells_ref.calls += 1
    c, nb, L = xrows.shape
    if L % hop != 0:
        raise ValueError(f"hop {hop} must divide block size {L}")
    kx = xrows.reshape(c * nb, L) @ t_kw + s_in.reshape(c * nb, -1) @ w_kw.T
    return (kx * kx).reshape(c, nb, L // hop, hop).sum(dim=-1).reshape(
        c, nb * (L // hop))


def _check_operands(name, xrows, s_in, t, w):
    """Validate what the CUDA kernels take; returns ``(C, nb, L, S)``."""
    if xrows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xrows.device}")
    if xrows.ndim != 3 or s_in.ndim != 3:
        raise ValueError(f"{name}: rows must be (C, nb, L) and states "
                         f"(C, nb, S)")
    c, nb, L = xrows.shape
    s = s_in.shape[2]
    if L % _TF32_TILE_COLS or L == 0 or not 1 <= c <= _TF32_TILE_ROWS:
        raise ValueError(f"{name}: the kernel takes L a positive multiple "
                         f"of {_TF32_TILE_COLS} and 1...{_TF32_TILE_ROWS} "
                         f"channels, got L={L}, C={c}")
    want = {"rows": ((c, nb, L), xrows), "states": ((c, nb, s), s_in),
            "T": ((L, L), t), "W": ((L, s), w)}
    for what, (shape, ten) in want.items():
        if tuple(ten.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(ten.shape)}, "
                             f"expected {shape}")
        if ten.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {ten.dtype}")
        if ten.device != xrows.device:
            raise ValueError(f"{name}: {what} is on {ten.device}, rows on "
                             f"{xrows.device}")
    for what, ten in (("rows", xrows), ("states", s_in)):
        if not ten.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return c, nb, L, s


def _check_tf32_operands(name, xrows, t, s, filters):
    """What the tensor-core kernels take beyond :func:`_check_operands`.

    They copy the rows (by TMA) and the packed operator ``t`` (by bulk
    copies) from 16-byte boundaries, and take at most ``16 / filters``
    states a filter.  Row offsets are 64-bit and row indices 32-bit: only
    ``C·nb >= 2^31`` rows are refused, over 1 TiB of float32 signal at
    these block sizes, which no card can address."""
    c, nb, _ = xrows.shape
    if filters * s > _TF32_STATE_DEPTH:
        raise ValueError(f"{name}: the kernel takes at most "
                         f"{_TF32_STATE_DEPTH // filters} states a filter, "
                         f"got {s}")
    if c * nb >= 2 ** 31:
        raise ValueError(f"{name}: {c * nb} rows, the kernel addresses fewer "
                         f"than 2^31")
    for what, ten in (("rows", xrows), ("T", t)):
        if ten.data_ptr() % 16:
            raise ValueError(f"{name}: the {what} must start on a 16-byte "
                             f"boundary (the kernel copies 16-byte chunks)")


def front_chain(xrows, s_in_eq, t_eq, w_eq, saturation, width,
                emit_mono: bool = False):
    """Fused chain front over rows form: one signal read + one write.

    Args:
      xrows: ``(C, nb, L)`` RAW rows signal (pre-saturation), float32.
      s_in_eq: ``(C, nb, S)`` per-block EQ incoming states, computed from
        the SATURATED signal (``iir.sosfilt_states_rows``).
      t_eq / w_eq: the EQ's ``T (L, L)`` and ``W (L, S)`` operators.
      saturation: the exciter, ``dry·x + wet·tanh(drive·x)``: the worker's
        saturation percent, or a ``(dry, wet, drive)`` triple
        (``waveshaper.exciter_coefs``; the legacy chain's ``tanh(g·x)/g``
        is ``(0, 1/g, g)``).
      width: the width slider.
      emit_mono: also return the output's channel mean ``(nb, L)``.

    Returns ``y (C, nb, L)``, or ``(y, mono)`` with ``emit_mono``.

    Under autograd (an input that requires grad, or a tensor coefficient
    or width) it runs through :class:`_FrontChainFn`.
    """
    coefs = exciter_coefs(saturation, dtype=xrows.dtype)
    scalars = (*coefs, width)
    if (any(isinstance(v, torch.Tensor) for v in scalars)
            or _wants_grad(xrows, s_in_eq, t_eq, w_eq)):
        out = _FrontChainFn.apply(xrows, s_in_eq, t_eq, w_eq, *scalars,
                                  emit_mono)
        return out if emit_mono else out[0]
    return _front_chain_forward(xrows, s_in_eq, t_eq, w_eq, coefs, width,
                                emit_mono)


def _front_chain_forward(xrows, s_in_eq, t_eq, w_eq, coefs, width,
                         emit_mono):
    """K1's launch on a CUDA tensor (its plain version on the CPU), with
    float coefficients and width."""
    if xrows.device.type == "cpu":
        return front_chain_ref(xrows, s_in_eq, t_eq, w_eq, coefs, width,
                               emit_mono)
    c, nb, L, s = _check_operands("front_chain", xrows, s_in_eq, t_eq, w_eq)
    packed = packed_operator(t_eq, _FRONT_COLS)
    _check_tf32_operands("front_chain", xrows, packed, s, filters=1)
    y = torch.empty_like(xrows)
    mono = (torch.empty((nb, L), dtype=xrows.dtype, device=xrows.device)
            if emit_mono else None)
    wt = w_eq.T.contiguous()
    dry, wet, drive = coefs
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_front_chain(
            _ptr(xrows), _ptr(packed), _ptr(wt), _ptr(s_in_eq), _ptr(y),
            None if mono is None else _ptr(mono), c, nb, L, s, dry, wet,
            drive, float(width), stream)
    _raise_on("front_chain", err)
    front_chain.launches += 1
    return (y, mono) if emit_mono else y


def kweight_cells(xrows, s_in, t_kw, w_kw, hop):
    """Hop-bucketed K-weighted energy sums ``(C, nb·L/hop)``.

    Args:
      xrows: ``(C, nb, L)`` rows-form meter input (mono ``(1, nb, L)`` on
        the reference-parity chain), float32.
      s_in: ``(C, nb, S)`` per-block incoming K-filter states.
      t_kw / w_kw: the K-filter's ``T (L, L)`` / ``W (L, S)`` operators
        (float64-built: the K-weighting poles sit near the unit circle).
      hop: bucket width ``h``, a divisor of ``L`` (``gcd(cell, L)``).

    Under autograd it runs through :class:`_KweightCellsFn`.
    """
    if _wants_grad(xrows, s_in, t_kw, w_kw):
        return _KweightCellsFn.apply(xrows, s_in, t_kw, w_kw, int(hop))
    return _kweight_cells_forward(xrows, s_in, t_kw, w_kw, hop)


def _kweight_cells_forward(xrows, s_in, t_kw, w_kw, hop):
    """K4's launch on a CUDA tensor (its plain version on the CPU)."""
    if xrows.device.type == "cpu":
        return kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop)
    c, nb, L, s = _check_operands("kweight_cells", xrows, s_in, t_kw, w_kw)
    _check_hop(L, hop)
    packed = packed_operator(t_kw, _CELLS_COLS)
    _check_tf32_operands("kweight_cells", xrows, packed, s, filters=1)
    out = torch.empty((c, nb * (L // hop)), dtype=xrows.dtype,
                      device=xrows.device)
    wt = w_kw.T.contiguous()
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_kweight_cells(_ptr(xrows), _ptr(packed), _ptr(wt),
                                    _ptr(s_in), _ptr(out), c, nb, L, s,
                                    int(hop), stream)
    _raise_on("kweight_cells", err)
    kweight_cells.launches += 1
    return out


class _FrontChainFn(torch.autograd.Function):
    """K1 under autograd.  Forward: the kernel (one launch; the
    coefficients and width read to the host in one transfer).  Backward,
    in plain torch, with ``xs = exc(x)``, ``u = xs·T + s_in·Wᵀ`` and ``y =
    width(u)`` (the mid/side matrix, symmetric): ``du = widthᵀ(dy)`` plus
    ``dmono / C`` on each channel; ``dT = Σ_rows xsᵀ du``, ``dW = duᵀ
    s_in``, ``ds_in = du W``, ``dxs = du Tᵀ``, whose exciter derivative
    gives ``dx``, ``d dry``, ``d wet`` and ``d drive``; ``d width = Σ (dy_L
    − dy_R)·(u_L − u_R)/2``, ``u_L − u_R`` recomputed from the channel
    differences (half a forward product).  Nothing but the inputs is
    saved."""

    @staticmethod
    def forward(ctx, xrows, s_in, t, w, dry, wet, drive, width, emit_mono):
        scalars = (dry, wet, drive, width)
        tens = [v for v in scalars if isinstance(v, torch.Tensor)]
        vals = iter(torch.stack([
            v.detach().reshape(()).to(tens[0].device, torch.float64)
            for v in tens]).tolist() if tens else ())
        host = [next(vals) if isinstance(v, torch.Tensor) else float(v)
                for v in scalars]
        out = _front_chain_forward(xrows, s_in, t, w, tuple(host[:3]),
                                   host[3], emit_mono)
        ctx.set_materialize_grads(False)
        ctx.host = host
        # the dtype and shape of each tensor slider, for its gradient
        ctx.scalar_like = [(v.dtype, v.shape) if isinstance(v, torch.Tensor)
                           else None for v in scalars]
        ctx.save_for_backward(xrows, s_in, t, w)
        return out if emit_mono else (out,)

    @staticmethod
    def backward(ctx, dy, dmono=None):
        x, s_in, t, w = ctx.saved_tensors
        c, nb, L = x.shape
        dry, wet, drive, width = ctx.host
        need = ctx.needs_input_grad
        if dy is None:
            dy = x.new_zeros(x.shape)
        if dmono is not None:
            dy = dy + dmono[None] / c
        rows = x.reshape(c * nb, L)
        states = s_in.reshape(c * nb, -1)
        th = torch.tanh(rows * drive)
        xs = dry * rows + wet * th
        d_width = None
        if c == 2:
            a, b = (1.0 + width) / 2.0, (1.0 - width) / 2.0
            du = torch.stack([a * dy[0] + b * dy[1], b * dy[0] + a * dy[1]])
            if need[7]:
                xs2, st2 = xs.reshape(2, nb, L), states.reshape(2, nb, -1)
                u_diff = (xs2[0] - xs2[1]) @ t + (st2[0] - st2[1]) @ w.T
                d_width = ((dy[0] - dy[1]) * u_diff).sum() / 2.0
        else:
            du = dy
            if need[7]:
                d_width = x.new_zeros(())
        du = du.reshape(c * nb, L)
        d_t = xs.T @ du if need[2] else None
        d_w = du.T @ states if need[3] else None
        d_s = (du @ w).reshape(s_in.shape) if need[1] else None
        d_x = d_dry = d_wet = d_drive = None
        if need[0] or any(need[4:7]):
            dxs = du @ t.T
            if need[4]:
                d_dry = (dxs * rows).sum()
            if need[5]:
                d_wet = (dxs * th).sum()
            sech2 = 1.0 - th * th
            if need[6]:
                d_drive = (dxs * (wet * rows * sech2)).sum()
            if need[0]:
                d_x = (dxs * (dry + wet * drive * sech2)).reshape(x.shape)

        grads = [None if g is None or like is None
                 else g.to(like[0]).reshape(like[1])
                 for g, like in zip((d_dry, d_wet, d_drive, d_width),
                                    ctx.scalar_like)]
        return (d_x, d_s, d_t, d_w, *grads, None)


class _KweightCellsFn(torch.autograd.Function):
    """K4 under autograd.  Forward: the kernel.  Backward, in plain torch,
    with ``k = x·T + s_in·Wᵀ`` recomputed (not saved: 63 MB a call on a
    180 s stereo track): ``dk = 2·k·repeat(dcells, h)``, ``dx = dk Tᵀ``,
    ``ds_in = dk W``, and ``dT = xᵀ dk``, ``dW = dkᵀ s_in`` only where they
    are asked for (the K-filter's operators are constants in the chain)."""

    @staticmethod
    def forward(ctx, xrows, s_in, t, w, hop):
        ctx.hop = hop
        ctx.save_for_backward(xrows, s_in, t, w)
        return _kweight_cells_forward(xrows, s_in, t, w, hop)

    @staticmethod
    def backward(ctx, dcells):
        x, s_in, t, w = ctx.saved_tensors
        c, nb, L = x.shape
        need = ctx.needs_input_grad
        rows = x.reshape(c * nb, L)
        states = s_in.reshape(c * nb, -1)
        k = rows @ t + states @ w.T
        dk = 2.0 * k * dcells.reshape(c * nb, L // ctx.hop).repeat_interleave(
            ctx.hop, dim=1)
        d_x = (dk @ t.T).reshape(x.shape) if need[0] else None
        d_s = (dk @ w).reshape(s_in.shape) if need[1] else None
        d_t = rows.T @ dk if need[2] else None
        d_w = dk.T @ states if need[3] else None
        return d_x, d_s, d_t, d_w, None


@functools.lru_cache(maxsize=16)
def _crossover_operands(lp_bytes, hp_bytes, k, L, device, dtype):
    """``t2 (2, L, L)`` (``T_lp``, ``T_hp``) and ``wt2 (2, S, L)`` (the
    transposed ``W``s) of two static cascades, float64-built, cast to
    ``dtype`` on ``device``."""
    from python_audio_mastering_tpu_torch.ops.iir import \
        _blocked_operators_static

    t_lp, _, w_lp, _ = _blocked_operators_static(lp_bytes, k, L)
    t_hp, _, w_hp, _ = _blocked_operators_static(hp_bytes, k, L)
    t2 = torch.as_tensor(np.stack([t_lp, t_hp]), dtype=dtype, device=device)
    wt2 = torch.as_tensor(np.stack([w_lp.T, w_hp.T]), dtype=dtype,
                          device=device)
    return t2.contiguous(), wt2.contiguous()


def crossover_operands(sos_lp, sos_hp, L, device, dtype=torch.float32):
    """The band kernels' operators ``(t2, wt2)`` for a crossover pair
    (cached per pair, block size, device and dtype)."""
    lp = np.ascontiguousarray(sos_lp, np.float64)
    hp = np.ascontiguousarray(sos_hp, np.float64)
    if lp.shape != hp.shape:
        raise ValueError("crossover cascades must share the state size")
    return _crossover_operands(lp.tobytes(), hp.tobytes(), lp.shape[0],
                               int(L), torch.device(device), dtype)


# csrc/tf32_wgmma.cuh: an operator in k-tiles of 32 rows of T by the
# columns of a column tile (64 of each band, 128 or 64 of one filter),
# each k-tile a big and a small part of (N, 32) TF32 values (Tᵀ: a row a
# column), swizzled in 16-byte chunks as its B descriptor reads them
_BAND_COLS = 64
_BAND_K = 32
_BAND_STATES = 4               # states a filter the kernels' registers hold
_TF32_MASK = -8192             # 0xffffe000: sign, exponent, 10 bits


def split_tf32(v):
    """``(big, small)`` of float32 ``v``, bit for bit the kernels'
    ``split_tf32``: ``big`` is ``v`` rounded to TF32 (ties away from
    zero), ``small`` the TF32 cut of ``v - big``."""
    bits = v.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & _TF32_MASK).view(torch.float32)
    small = ((v - big).view(torch.int32) & _TF32_MASK).view(torch.float32)
    return big, small


def pack_operator(ts, cols):
    """The tensor-core kernels' operator from ``ts (F, L, L)`` float32
    (``T`` of each of F filters), on ``ts``' device, for column tiles of
    ``cols`` columns of each filter: for each column tile ``jt`` the
    k-tiles ``kt < (jt + 1)·cols / 32`` (the rows of the causal T with a
    nonzero column in the tile), tile after tile, each k-tile the big then
    the small part of ``B[n][k] = T_{n // cols}[32·kt + k][cols·jt + n %
    cols]`` (n < F·cols, k < 32), its 16-byte chunk ``c`` of row ``n``
    stored at chunk ``c ^ (n % 8)`` (the 128-byte swizzle).  Returns a
    flat float32 tensor of ``q·nt·(nt + 1)·F·cols·32`` values, ``nt =
    L / cols``, ``q = cols / 32``."""
    f, L, _ = ts.shape
    n_cols = f * cols
    nt, nk, q = L // cols, L // _BAND_K, cols // _BAND_K
    # (f, kt, k, jt, jj) -> (jt, kt, n = f·cols + jj, k)
    b = ts.reshape(f, nk, _BAND_K, nt, cols).permute(3, 1, 0, 4, 2)
    b = b.reshape(nt, nk, n_cols, _BAND_K)
    parts = torch.stack(split_tf32(b), dim=2)     # (jt, kt, part, n, k)
    n = torch.arange(n_cols, device=ts.device)
    chunk = torch.arange(_BAND_K // 4, device=ts.device)
    src = (chunk[None, :] ^ (n[:, None] % 8))     # stored chunk -> chunk
    idx = src[:, :, None].expand(n_cols, _BAND_K // 4, 4)
    swz = parts.reshape(nt, nk, 2, n_cols, _BAND_K // 4, 4).gather(
        4, idx.expand(nt, nk, 2, *idx.shape))
    return torch.cat([swz[jt, :q * (jt + 1)].reshape(-1)
                      for jt in range(nt)]).contiguous()


def pack_crossover_operator(t2):
    """The band kernels' operator from ``t2 (2, L, L)`` float32 (``T_lp``,
    ``T_hp``): :func:`pack_operator` in column tiles of 64 columns of each
    band, ``nt·(nt + 1)·8192`` values, ``nt = L / 64``."""
    return pack_operator(t2, _BAND_COLS)


# the one-filter kernels' packed operators, by the T tensor they were
# packed from (an entry goes with its tensor) and column tile width
_PACKED = WeakIdKeyDictionary()


def packed_operator(t, cols):
    """K1's (``cols`` 128) or K4's (64) operator for ``T (L, L)``
    (:func:`pack_operator` of one filter), on ``t``'s device.  Cached with
    the operator: per T tensor (so per device: the chain's EQ operators of
    ``MasteringChain.eq_ops`` and its K-weighting buffer are packed once)
    and column width, packed again if ``t`` was written in place.  A ``t``
    that requires grad (built in the automaster's graph every step) is
    packed on each call, on the device, outside the graph, and not
    cached."""
    if t.requires_grad:
        with torch.no_grad():
            return pack_operator(t.detach()[None], cols)
    cached = _PACKED.get(t)
    if cached is None:
        cached = _PACKED[t] = {}
    hit = cached.get(cols)
    if hit is None or hit[0] != t._version:
        hit = cached[cols] = (t._version, pack_operator(t[None], cols))
    return hit[1]


@functools.lru_cache(maxsize=16)
def _crossover_packed(lp_bytes, hp_bytes, k, L, device):
    t2, _ = _crossover_operands(lp_bytes, hp_bytes, k, L, device,
                                torch.float32)
    return pack_crossover_operator(t2)


def crossover_packed(sos_lp, sos_hp, L, device):
    """The band kernels' packed operator for a crossover pair (cached per
    pair, block size and device; :func:`pack_crossover_operator`)."""
    lp = np.ascontiguousarray(sos_lp, np.float64)
    hp = np.ascontiguousarray(sos_hp, np.float64)
    return _crossover_packed(lp.tobytes(), hp.tobytes(), lp.shape[0],
                             int(L), torch.device(device))


def _bands_ref(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp):
    """Plain band recompute ``band = rows @ T + s_in @ Wᵀ`` → low, high."""
    c, nb, L = xrows.shape
    t2, wt2 = crossover_operands(sos_lp, sos_hp, L, xrows.device,
                                 xrows.dtype)
    rows = xrows.reshape(c * nb, L)
    return tuple((rows @ t2[f] + s.reshape(c * nb, -1) @ wt2[f]).reshape(
        c, nb, L) for f, s in enumerate((s_in_lp, s_in_hp)))


def band_energies_ref(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp, hop=1):
    """Plain version of :func:`band_energies` (the JAX package's
    ``band_energies_xla``: bands materialised, bucket sums as a product
    with the 0/1 bucket matrix)."""
    from python_audio_mastering_tpu_torch.ops.multiband import _bucket_matrix

    c, nb, L = xrows.shape
    _check_hop(L, hop)
    low, high = _bands_ref(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp)
    mid = xrows - low - high
    rows = []
    for sig in (low, mid, high):
        e = (sig * sig).sum(dim=0)
        if hop > 1:
            e = e @ torch.as_tensor(_bucket_matrix(L, hop), dtype=e.dtype,
                                    device=e.device)
        rows.append(e.reshape(-1) * (1.0 / c))
    return torch.stack(rows)


def band_gain_apply_ref(xrows, s_in_lp, s_in_hp, cols, sos_lp, sos_hp,
                        hop=1, emit_mono: bool = False):
    """Plain version of :func:`band_gain_apply` (the JAX package's
    ``band_gain_apply_xla``; the upsample is a repeat, which equals its
    0/1-matrix product exactly: one nonzero term per output)."""
    c, nb, L = xrows.shape
    _check_hop(L, hop)
    low, high = _bands_ref(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp)
    g = cols.reshape(3, nb, L // hop).repeat_interleave(hop, dim=2)
    y = xrows * g[0][None] + low * g[1][None] + high * g[2][None]
    if emit_mono:
        return y, y.mean(dim=0)
    return y


def _check_hop(L, hop):
    if L % hop != 0:
        raise ValueError(f"hop {hop} must divide block size {L}")


def _check_band_operands(name, xrows, s_in_lp, s_in_hp, sos_lp, sos_hp):
    """Validate the band kernels' operands; returns ``(C, nb, L, S,
    packed, wt2)`` (:func:`crossover_packed`)."""
    c, nb, L = xrows.shape
    t2, wt2 = crossover_operands(sos_lp, sos_hp, L, xrows.device,
                                 xrows.dtype)
    _, _, _, s = _check_operands(name, xrows, s_in_lp, t2[0], wt2[0].T)
    if s > _BAND_STATES:
        raise ValueError(f"{name}: the kernel takes at most {_BAND_STATES} "
                         f"states a filter (the LR4 crossovers' 4), got {s}")
    packed = crossover_packed(sos_lp, sos_hp, L, xrows.device)
    _check_tf32_operands(name, xrows, packed, s, filters=2)
    if tuple(s_in_hp.shape) != tuple(s_in_lp.shape) or \
            s_in_hp.dtype != s_in_lp.dtype or \
            s_in_hp.device != xrows.device or not s_in_hp.is_contiguous():
        raise ValueError(f"{name}: the high-pass states must match the "
                         f"low-pass ones {tuple(s_in_lp.shape)}, contiguous "
                         f"float32 on {xrows.device}")
    return c, nb, L, s, packed, wt2


def band_energies(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp, hop=1):
    """Hop-bucketed channel-mean band energies ``(3, nb·L/hop)`` (low,
    mid, high); the band signals never reach device memory.

    Args:
      xrows: ``(C, nb, L)`` rows-form signal, float32.
      s_in_lp / s_in_hp: ``(C, nb, S)`` per-block incoming cascade states
        (``iir.sosfilt_states_multi_rows``).
      sos_lp / sos_hp: the concrete ``(K, 6)`` crossover cascades.
      hop: bucket width, a divisor of ``L``.
    """
    if xrows.device.type == "cpu":
        return band_energies_ref(xrows, s_in_lp, s_in_hp, sos_lp, sos_hp,
                                 hop)
    c, nb, L, s, packed, wt2 = _check_band_operands(
        "band_energies", xrows, s_in_lp, s_in_hp, sos_lp, sos_hp)
    _check_hop(L, hop)
    out = torch.empty((3, nb * (L // hop)), dtype=xrows.dtype,
                      device=xrows.device)
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_band_energies(_ptr(xrows), _ptr(packed), _ptr(wt2),
                                    _ptr(s_in_lp), _ptr(s_in_hp), _ptr(out),
                                    c, nb, L, s, int(hop), stream)
    _raise_on("band_energies", err)
    band_energies.launches += 1
    return out


def band_gain_apply(xrows, s_in_lp, s_in_hp, cols, sos_lp, sos_hp, hop=1,
                    emit_mono: bool = False):
    """Recombine with control-rate gains: ``y = x·gm + low·dl + high·dh``
    over rows form, one signal read and one write.

    Args:
      cols: ``(3, nb·L/hop)`` control-rate columns ``(g_mid, g_low − g_mid,
        g_high − g_mid)``, float32.
      emit_mono: also return the channel mean of ``y`` as ``(nb, L)`` rows
        (the loudness meter's downmix).  Returns ``(y, mono)``.
    """
    if xrows.device.type == "cpu":
        return band_gain_apply_ref(xrows, s_in_lp, s_in_hp, cols, sos_lp,
                                   sos_hp, hop, emit_mono)
    c, nb, L, s, packed, wt2 = _check_band_operands(
        "band_gain_apply", xrows, s_in_lp, s_in_hp, sos_lp, sos_hp)
    _check_hop(L, hop)
    want = (3, nb * (L // hop))
    if (tuple(cols.shape) != want or cols.dtype != xrows.dtype
            or cols.device != xrows.device or not cols.is_contiguous()):
        raise ValueError(f"band_gain_apply: cols must be a contiguous "
                         f"{want} {xrows.dtype} tensor on {xrows.device}, "
                         f"got {tuple(cols.shape)} {cols.dtype}")
    y = torch.empty_like(xrows)
    mono = (torch.empty((nb, L), dtype=xrows.dtype, device=xrows.device)
            if emit_mono else None)
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_band_gain_apply(
            _ptr(xrows), _ptr(packed), _ptr(wt2), _ptr(s_in_lp),
            _ptr(s_in_hp),
            _ptr(cols), _ptr(y), None if mono is None else _ptr(mono), c, nb,
            L, s, int(hop), stream)
    _raise_on("band_gain_apply", err)
    band_gain_apply.launches += 1
    return (y, mono) if emit_mono else y


front_chain.launches = 0
kweight_cells.launches = 0
front_chain_ref.calls = 0
kweight_cells_ref.calls = 0
band_energies.launches = 0
band_gain_apply.launches = 0
_WRAPPERS = (front_chain, kweight_cells, band_energies, band_gain_apply,
             ballistics.pass1_hull, ballistics.pass1_runs, ballistics.replay,
             ballistics.replay_bnd, sos_scan, gain_limit, lookahead_limit)


_PLAIN_TWINS = [front_chain_ref, kweight_cells_ref, sos_scan_ref,
                gain_limit_ref]


def counts_plain_calls(twin):
    """Decorator: count ``twin.calls`` in :func:`plain_calls` too.  For a
    plain twin in a module that imports this one (``ops.limiter``'s, whose
    stages need the meters' interpolator); the package imports it."""
    _PLAIN_TWINS.append(twin)
    return twin


def reset_launch_counts():
    """Set every kernel's launch count, and the call counts of the plain
    twins of :func:`plain_calls`, to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0
    for fn in _PLAIN_TWINS:
        fn.calls = 0


def plain_calls():
    """``{plain twin name: calls}`` since the last reset."""
    return {fn.__name__: fn.calls for fn in _PLAIN_TWINS}


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
