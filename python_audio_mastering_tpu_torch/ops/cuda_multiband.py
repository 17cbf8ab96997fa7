"""The port's blocked-IIR kernels and their plain PyTorch versions.

Counterpart of ``python_audio_mastering_tpu.ops.pallas_multiband``:

* :func:`front_chain` (CUDA ``csrc/front_chain.cu``) — saturate → EQ from
  per-block states → stereo width, plus the mono downmix;
* :func:`kweight_cells` (CUDA ``csrc/kweight_cells.cu``) — K-weighting
  from per-block states → square → ``h``-bucket sums;
* :func:`band_energies` (CUDA ``csrc/band_energies.cu``) — the crossover
  bands from per-block states → channel-mean squared energies in
  ``hop``-buckets, the multiband detector's input;
* :func:`band_gain_apply` (CUDA ``csrc/band_gain_apply.cu``) — the bands
  again → recombination with the control-rate gains, plus the mono
  downmix.

All four compute their product on the tensor cores in 3xTF32, through the
one product tile of ``csrc/tf32_product.cuh``: ``front_chain`` and
``kweight_cells`` with one filter, ``band_energies`` and
``band_gain_apply`` with the two crossover filters.  ``kweight_cells``
adds its states term ``s_in @ Wᵀ`` in fp32 on the CUDA cores (the
K-weighting's state operator is ~70 times the signal, and 3xTF32 would
put ~1.3e-5 of the max on it).

Each wrapper takes its plain version (``*_ref``) for a tensor on the CPU,
and launches its kernel for a CUDA tensor or raises: there is no fallback
on the card.  Each counts its kernel launches in ``<wrapper>.launches``
(only where it launches the kernel); :func:`reset_launch_counts` and
:func:`launch_counts` read and clear them for every kernel of the port,
the ballistics kernels of ``ops.ballistics`` included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops import _kernels, ballistics
from python_audio_mastering_tpu_torch.ops._kernels import ptr as _ptr
from python_audio_mastering_tpu_torch.ops._kernels import raise_on as _raise_on
from python_audio_mastering_tpu_torch.ops.stereo import stereo_width
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    saturate,
    saturation_coefs,
)

__all__ = ["front_chain", "front_chain_ref", "kweight_cells",
           "kweight_cells_ref", "band_energies", "band_energies_ref",
           "band_gain_apply", "band_gain_apply_ref", "launch_counts",
           "reset_launch_counts"]

# csrc/tf32_product.cuh: a tile holds 128 rows, every channel of a block
# among them, and 128 columns of one filter (64 of each of two), and its
# states tile filters·S <= 16 columns
_TF32_TILE_ROWS = 128
_TF32_TILE_COLS = 128
_TF32_STATE_DEPTH = 16


def front_chain_ref(xrows, s_in_eq, t_eq, w_eq, saturation_percent, width,
                    emit_mono: bool = False):
    """Plain version of :func:`front_chain` (same algebra)."""
    c, nb, L = xrows.shape
    xs = saturate(xrows, saturation_percent).reshape(c * nb, L)
    y = xs @ t_eq + s_in_eq.reshape(c * nb, -1) @ w_eq.T
    y = stereo_width(y.reshape(c, nb, L), width, channel_axis=0)
    if emit_mono:
        return y, y.mean(dim=0)
    return y


def kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop):
    """Plain version of :func:`kweight_cells` (same algebra)."""
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

    They copy the rows and ``T`` in 16-byte chunks, and hold ``filters·S``
    state columns in one short tile.  Row offsets are 64-bit and row
    indices 32-bit: only ``C·nb >= 2^31`` rows are refused, over 1 TiB of
    float32 signal at these block sizes, which no card can address."""
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


def front_chain(xrows, s_in_eq, t_eq, w_eq, saturation_percent, width,
                emit_mono: bool = False):
    """Fused chain front over rows form: one signal read + one write.

    Args:
      xrows: ``(C, nb, L)`` RAW rows signal (pre-saturation), float32.
      s_in_eq: ``(C, nb, S)`` per-block EQ incoming states, computed from
        the SATURATED signal (``iir.sosfilt_states_rows``).
      t_eq / w_eq: the EQ's ``T (L, L)`` and ``W (L, S)`` operators.
      saturation_percent / width: the slider values.
      emit_mono: also return the output's channel mean ``(nb, L)``.

    Returns ``y (C, nb, L)``, or ``(y, mono)`` with ``emit_mono``.
    """
    if xrows.device.type == "cpu":
        return front_chain_ref(xrows, s_in_eq, t_eq, w_eq,
                               saturation_percent, width, emit_mono)
    c, nb, L, s = _check_operands("front_chain", xrows, s_in_eq, t_eq, w_eq)
    t_eq = t_eq.contiguous()
    _check_tf32_operands("front_chain", xrows, t_eq, s, filters=1)
    y = torch.empty_like(xrows)
    mono = (torch.empty((nb, L), dtype=xrows.dtype, device=xrows.device)
            if emit_mono else None)
    wt = w_eq.T.contiguous()
    mix, drive = saturation_coefs(saturation_percent)
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_front_chain(
            _ptr(xrows), _ptr(t_eq), _ptr(wt), _ptr(s_in_eq), _ptr(y),
            None if mono is None else _ptr(mono), c, nb, L, s, mix, drive,
            float(width), stream)
    _raise_on("front_chain", err)
    front_chain.launches += 1
    return (y, mono) if emit_mono else y


_TICKETS = {}


def _tickets(device, stream, groups):
    """``kweight_cells``' row-group tickets on ``(device, stream)``: int32
    zeros, at least ``groups`` of them.  The kernel's last CTA of a group
    sets its ticket back to 0, so one buffer serves every launch on the
    stream; it is allocated again only to grow."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < groups:
        buf = _TICKETS[key] = torch.zeros(groups, dtype=torch.int32,
                                          device=device)
    return buf


def kweight_cells(xrows, s_in, t_kw, w_kw, hop):
    """Hop-bucketed K-weighted energy sums ``(C, nb·L/hop)``.

    Args:
      xrows: ``(C, nb, L)`` rows-form meter input (mono ``(1, nb, L)`` on
        the reference-parity chain), float32.
      s_in: ``(C, nb, S)`` per-block incoming K-filter states.
      t_kw / w_kw: the K-filter's ``T (L, L)`` / ``W (L, S)`` operators
        (float64-built: the K-weighting poles sit near the unit circle).
      hop: bucket width ``h``, a divisor of ``L`` (``gcd(cell, L)``).
    """
    if xrows.device.type == "cpu":
        return kweight_cells_ref(xrows, s_in, t_kw, w_kw, hop)
    c, nb, L, s = _check_operands("kweight_cells", xrows, s_in, t_kw, w_kw)
    _check_hop(L, hop)
    t_kw = t_kw.contiguous()
    _check_tf32_operands("kweight_cells", xrows, t_kw, s, filters=1)
    out = torch.empty((c, nb * (L // hop)), dtype=xrows.dtype,
                      device=xrows.device)
    wt = w_kw.T.contiguous()
    part = tickets = None
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        if _TF32_TILE_COLS % hop:
            # buckets cross column tiles: the tiles' pieces of them, and a
            # ticket a row group that finds the last tile to finish
            groups = -(-nb // (_TF32_TILE_ROWS // c))
            part = torch.empty((groups, L // _TF32_TILE_COLS,
                                _TF32_TILE_ROWS, 2), dtype=torch.float32,
                               device=xrows.device)
            tickets = _tickets(xrows.device, stream, groups)
        err = lib.pam_kweight_cells(_ptr(xrows), _ptr(t_kw), _ptr(wt),
                                    _ptr(s_in), _ptr(out),
                                    None if part is None else _ptr(part),
                                    None if tickets is None else _ptr(tickets),
                                    c, nb, L, s, int(hop), stream)
    _raise_on("kweight_cells", err)
    kweight_cells.launches += 1
    return out


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
    """Validate the band kernels' operands; returns ``(C, nb, L, S, t2,
    wt2)``."""
    c, nb, L = xrows.shape
    t2, wt2 = crossover_operands(sos_lp, sos_hp, L, xrows.device,
                                 xrows.dtype)
    _, _, _, s = _check_operands(name, xrows, s_in_lp, t2[0], wt2[0].T)
    _check_tf32_operands(name, xrows, t2, s, filters=2)
    if tuple(s_in_hp.shape) != tuple(s_in_lp.shape) or \
            s_in_hp.dtype != s_in_lp.dtype or \
            s_in_hp.device != xrows.device or not s_in_hp.is_contiguous():
        raise ValueError(f"{name}: the high-pass states must match the "
                         f"low-pass ones {tuple(s_in_lp.shape)}, contiguous "
                         f"float32 on {xrows.device}")
    return c, nb, L, s, t2, wt2


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
    c, nb, L, s, t2, wt2 = _check_band_operands(
        "band_energies", xrows, s_in_lp, s_in_hp, sos_lp, sos_hp)
    _check_hop(L, hop)
    out = torch.empty((3, nb * (L // hop)), dtype=xrows.dtype,
                      device=xrows.device)
    lib = _kernels.library().lib
    with torch.cuda.device(xrows.device):
        stream = torch.cuda.current_stream(xrows.device).cuda_stream
        err = lib.pam_band_energies(_ptr(xrows), _ptr(t2), _ptr(wt2),
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
    c, nb, L, s, t2, wt2 = _check_band_operands(
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
            _ptr(xrows), _ptr(t2), _ptr(wt2), _ptr(s_in_lp), _ptr(s_in_hp),
            _ptr(cols), _ptr(y), None if mono is None else _ptr(mono), c, nb,
            L, s, int(hop), stream)
    _raise_on("band_gain_apply", err)
    band_gain_apply.launches += 1
    return (y, mono) if emit_mono else y


front_chain.launches = 0
kweight_cells.launches = 0
band_energies.launches = 0
band_gain_apply.launches = 0
_WRAPPERS = (front_chain, kweight_cells, band_energies, band_gain_apply,
             ballistics.pass1_hull, ballistics.pass1_runs, ballistics.replay,
             ballistics.replay_bnd)


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """``{kernel name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
