"""ITU-R BS.1770-4 gated loudness over the rows form.

Counterpart of the rows-form half of
``python_audio_mastering_tpu.ops.loudness``:

* K-weighting = high shelf + high pass biquads (``ops.biquad``), run as a
  blocked IIR whose per-block states come from the plain-torch states pass
  and whose outputs are recomputed, squared and bucket-summed by the
  ``kweight_cells`` kernel — the K-weighted signal never reaches memory;
* on the exact filter path (``filter_method="scan"``, and ``"auto"``
  below ``4 · 512`` frames, JAX ``sosfilt``'s rule) the K-weighting is
  the scan kernel K8 instead (``ops.sos_scan``), the cells summed from its
  output in plain torch;
* 400 ms gating blocks at 75 % overlap, built from 100 ms cells;
* −70 LUFS absolute and −10 LU relative gates as masked reductions.

Downmix modes: ``"reference_mono_mean"`` measures the channel mean as one
mono signal (the reference engine's behaviour, the chain default);
``"bs1770"`` weights per-channel energies as the spec says.

:func:`block_cell_energies`, :func:`integrated_loudness` and
:func:`normalize_to_lufs` take ``(N, C)`` audio, folded into rows for
the same kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops._kernels import (
    check_channel_major_arg,
    check_kernel_arg,
)
from python_audio_mastering_tpu_torch.ops.biquad import (
    deman_high_pass_sos,
    deman_high_shelf_sos,
)
from python_audio_mastering_tpu_torch.ops.cuda_multiband import kweight_cells
from python_audio_mastering_tpu_torch.ops.sos_scan import sos_scan

__all__ = [
    "kweight_sos",
    "kweight_scans",
    "channel_weights",
    "block_cell_energies_rows",
    "integrated_loudness_rows",
    "loudness_from_cells",
    "gain_for_target",
    "block_cell_energies",
    "integrated_loudness",
    "normalize_to_lufs",
    "BlockEnergyAccumulator",
]


_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_LOUDNESS_OFFSET = -0.691


def kweight_sos(sample_rate):
    """The 2-section K-weighting prefilter cascade, float64 ``(2, 6)``."""
    return np.concatenate([deman_high_shelf_sos(sample_rate),
                           deman_high_pass_sos(sample_rate)], axis=0)


def channel_weights(num_channels, dtype=torch.float32, device="cpu"):
    """BS.1770 channel weights: L, R, C get 1.0; Ls, Rs get 1.41."""
    g = np.ones(num_channels)
    if num_channels >= 4:
        g[3:5] = 1.41
    return torch.as_tensor(g, dtype=dtype, device=device)


def _gating_geometry(sample_rate):
    """(cell_len, cells_per_block) for 400 ms blocks at 75 % overlap."""
    win = int(round(0.4 * sample_rate))
    cell = int(round(0.1 * sample_rate))
    if win != 4 * cell:  # pragma: no cover - exotic rates
        cell = win // 4
    return cell, 4


def block_cell_energies_rows(xrows, sample_rate, zi=None, valid_frames=None,
                             return_state=False, kernel="auto", ops=None,
                             scan=False):
    """Per-cell mean-square K-weighted energies of rows ``(C, nb, L)``, or
    of an album's ``(C, T, nb, L)`` (T tracks, each its own signal).

    The ``kweight_cells`` kernel emits sums over buckets of
    ``h = gcd(cell, L)`` samples (6 at 44.1 kHz with L = 384, 192 at
    48 kHz); a cell is then an exact sum of ``cell / h`` buckets.  A
    bucket lies inside a block, so the album's tracks fold into the
    kernel's block axis, one launch for all of them; the states pass
    runs the ``C·T`` signals as independent sequences.  ``ops`` are the
    K-filter's blocked operators (``iir.blocked_ops``), looked up when not
    given.  ``zi``/``return_state``: the carried K-filter state of chunked
    streaming, ``(K, 2, C·T)`` for an album.  ``valid_frames``: cells that
    reach past it are masked out of the gating (zero-padded tails), and
    ``zf`` is the state after it.  ``kernel``: JAX's switch, ``"auto"``
    only (the device picks the route).  ``scan``: the exact K-weighting
    instead (K8 over every ``(channel, track)`` run of ``nb·L`` samples,
    read in place; the cells are means of its squared output).

    Returns ``(cell_ms (num_cells, C), cell_mask or None, zf)``; for an
    album ``cell_ms`` is ``(T, num_cells, C)``.
    """
    check_kernel_arg(kernel)
    album = xrows.ndim == 4
    x4 = xrows if album else xrows[:, None]
    c, tracks, nb, L = x4.shape
    n = nb * L
    cell, _ = _gating_geometry(sample_rate)
    n_cells = n // cell
    if scan:
        kx, (z_scan,) = sos_scan(
            x4.reshape(c * tracks, n), [kweight_sos(sample_rate)],
            [zi], n_valid=valid_frames)
        zf = z_scan if return_state else zi
        z = kx[0].reshape(c, tracks, n)[:, :, : n_cells * cell] ** 2
        cell_ms = z.reshape(c, tracks, n_cells, cell).mean(dim=3).permute(
            1, 2, 0)
    else:
        h = math.gcd(cell, L)
        s_in, zf, ops = iir.sosfilt_states_rows(
            kweight_sos(sample_rate), x4.reshape(c * tracks, nb, L), zi=zi,
            n_valid=valid_frames, return_state=return_state, ops=ops)
        buck = kweight_cells(x4.reshape(c, tracks * nb, L),
                             s_in.reshape(c, tracks * nb, -1), ops.t, ops.w,
                             h)
        per_cell = cell // h
        cells = buck.reshape(c, tracks, n // h)[:, :, : n_cells * per_cell]
        cell_ms = cells.reshape(c, tracks, n_cells, per_cell).sum(
            dim=3).permute(1, 2, 0) / cell
    if not album:
        cell_ms = cell_ms[0]
    cell_mask = None
    if valid_frames is not None:
        cell_mask = (torch.arange(n_cells, device=xrows.device)
                     < (int(valid_frames) // cell))
    return cell_ms, cell_mask, zf


def integrated_loudness_rows(xrows, sample_rate, downmix="bs1770",
                             valid_frames=None, kernel="auto", ops=None,
                             scan=False):
    """Gated integrated loudness (LUFS, 0-d tensor) of rows ``(C, nb, L)``
    (``(T,)`` for an album's ``(C, T, nb, L)``); ``kernel``, ``ops`` and
    ``scan`` as in :func:`block_cell_energies_rows`."""
    if downmix == "reference_mono_mean":
        xrows = xrows.mean(dim=0, keepdim=True)
    cell_ms, cell_mask, _ = block_cell_energies_rows(
        xrows, sample_rate, valid_frames=valid_frames, kernel=kernel,
        ops=ops, scan=scan)
    return loudness_from_cells(cell_ms, cell_mask=cell_mask)


def loudness_from_cells(cell_ms, weights=None, cell_mask=None):
    """Gated integrated loudness from 100 ms cell energies ``(cells, C)``,
    or per track from an album's ``(T, cells, C)``.

    ``cell_mask``: optional ``(cells,)`` (``(T, cells)``) validity mask.
    Returns a 0-d tensor (``(T,)``), −inf when no gating block survives
    (pyloudnorm's contract).  No host synchronisation: the gates are
    masked reductions.
    """
    n_cells, c = cell_ms.shape[-2:]
    lead = cell_ms.shape[:-2]
    dt, dev = cell_ms.dtype, cell_ms.device
    if n_cells < 4:
        return torch.full(lead, -math.inf, dtype=dt, device=dev)
    if weights is None:
        weights = channel_weights(c, dtype=dt, device=dev)
    if cell_mask is None:
        cell_mask = torch.ones(cell_ms.shape[:-1], dtype=torch.bool,
                               device=dev)

    block_ms = (cell_ms[..., :-3, :] + cell_ms[..., 1:-2, :]
                + cell_ms[..., 2:-1, :] + cell_ms[..., 3:, :]) / 4.0
    block_ok = (cell_mask[..., :-3] & cell_mask[..., 1:-2]
                & cell_mask[..., 2:-1] & cell_mask[..., 3:])
    eps = float(np.finfo(np.float32).tiny)

    def lufs_of(ms):
        return _LOUDNESS_OFFSET + 10.0 * torch.log10(torch.clamp_min(ms, eps))

    def masked_mean(values, mask):
        cnt = mask.sum(dim=-1)
        s = torch.where(mask[..., None], values, 0.0).sum(dim=-2)
        return s / torch.clamp_min(cnt, 1)[..., None], cnt

    l_blocks = lufs_of(block_ms @ weights)
    m_abs = block_ok & (l_blocks > _ABS_GATE_LUFS)
    ms_abs, _ = masked_mean(block_ms, m_abs)
    rel_gate = lufs_of(ms_abs @ weights) + _REL_GATE_LU
    m_rel = m_abs & (l_blocks > rel_gate[..., None])
    ms_rel, cnt_rel = masked_mean(block_ms, m_rel)
    lufs = lufs_of(ms_rel @ weights)
    return torch.where(cnt_rel > 0, lufs, torch.full_like(lufs, -math.inf))


def gain_for_target(loudness, target_lufs, dtype=None):
    """Linear gain that moves ``loudness`` to ``target_lufs``; 1 for a
    silent (−inf) measurement instead of an infinite gain.  ``dtype``:
    the target's (and so the gain's) type, as JAX's casts it; the
    loudness's when None."""
    if dtype is not None:
        target_lufs = torch.as_tensor(target_lufs, dtype=dtype,
                                      device=loudness.device)
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    return torch.where(torch.isfinite(loudness), gain, torch.ones_like(gain))


def _as_audio(x):
    x = torch.as_tensor(x)
    return x[:, None] if x.ndim == 1 else x


def kweight_scans(filter_method, n_frames):
    """Whether the K-weighting of ``n_frames`` takes the exact scan: JAX
    ``block_cell_energies``' ``iir.sosfilt`` at its default block (512)."""
    return iir.uses_scan(filter_method, n_frames, iir.DEFAULT_BLOCK)


def block_cell_energies(x, sample_rate, zi=None, filter_method="auto"):
    """Per-cell mean-square K-weighted energies of ``(N, C)`` (or
    ``(N,)``) audio (JAX ``block_cell_energies``), through the rows path
    and its kernel, or through the scan kernel where ``filter_method``
    picks the scan (:func:`kweight_scans`).  Returns ``(cell_ms (N //
    cell, C), zf)``: complete cells only, ``zf`` the K-filter state after
    the N samples."""
    x = _as_audio(x)
    n = x.shape[0]
    cell_ms, _, zf = block_cell_energies_rows(
        iir.to_rows(x), sample_rate, zi=zi, valid_frames=n,
        return_state=True, scan=kweight_scans(filter_method, n))
    return cell_ms[: n // _gating_geometry(sample_rate)[0]], zf


def integrated_loudness(x, sample_rate, downmix="bs1770", filter_method="auto",
                        valid_frames=None):
    """Gated integrated loudness (LUFS, 0-d tensor) of ``(N, C)`` or
    ``(N,)`` audio; ``filter_method`` as in :func:`block_cell_energies`;
    ``valid_frames``: only cells inside the first ``valid_frames`` samples
    count."""
    x = _as_audio(x)
    n = x.shape[0]
    vf = n if valid_frames is None else min(int(valid_frames), n)
    return integrated_loudness_rows(iir.to_rows(x), sample_rate,
                                    downmix=downmix, valid_frames=vf,
                                    scan=kweight_scans(filter_method, n))


def normalize_to_lufs(x, sample_rate, target_lufs=-14.0,
                      downmix="reference_mono_mean", filter_method="auto",
                      valid_frames=None, channel_major=False):
    """Measure, then one linear gain to ``target_lufs`` (no re-measure, no
    clip guard: a limiter follows).  ``channel_major``: JAX's ``(C, N)``
    input, not ported (only False).  Returns ``(y, measured_lufs,
    gain_linear)``."""
    check_channel_major_arg(channel_major)
    x = torch.as_tensor(x)
    loudness = integrated_loudness(x, sample_rate, downmix=downmix,
                                   filter_method=filter_method,
                                   valid_frames=valid_frames)
    gain = gain_for_target(loudness, target_lufs, x.dtype)
    return x * gain, loudness, gain


@dataclasses.dataclass
class BlockEnergyAccumulator:
    """Streaming loudness state: per-cell energies accumulated chunk by
    chunk (:func:`block_cell_energies`, the K-filter state carried), so
    the integrated loudness needs no second pass over the audio.  Chunks
    must be multiples of the 100 ms cell length."""

    sample_rate: int
    zi: object = None
    cells: list = dataclasses.field(default_factory=list)

    @property
    def cell_len(self):
        return _gating_geometry(self.sample_rate)[0]

    def update(self, chunk):
        """Add ``chunk`` ``(M, C)``'s cells; returns them."""
        cell_ms, self.zi = block_cell_energies(chunk, self.sample_rate,
                                               zi=self.zi)
        self.cells.append(cell_ms)
        return cell_ms

    def loudness(self, downmix="bs1770"):
        """The gated integrated loudness of every cell so far."""
        if downmix == "reference_mono_mean":
            raise ValueError(
                "reference_mono_mean downmix must be applied before "
                "update(); pass chunk.mean(axis=1) chunks instead")
        return loudness_from_cells(torch.cat(self.cells, dim=0))
