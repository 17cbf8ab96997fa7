"""Chunked streaming execution with carried state.

Counterpart of ``python_audio_mastering_tpu.parallel.streaming`` (the
rows-form chunk body).  The audio is cut into chunks of
:func:`default_chunk_frames`; each chunk runs the chain front (and the
multiband compressor) with the EQ (and multiband) state carried from the
last one (pass A) and adds its 100 ms loudness cells, measured with the
K-weighting state carried too.  The gated loudness
of all cells sets one gain, and pass B applies gain and soft limiter chunk
by chunk, so the streamed result matches the one-shot :func:`master` up to
float reassociation.

What this port covers: float32 transfer with every chunk resident on the
device.  The pcm16 wire, the device-memory budget with spills,
checkpoint/resume and the meters are ROADMAP queue 1 items 4 and 5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import (
    MasteringChain,
    check_fp32_matmul,
    check_supported,
    require_device,
)
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.ops.waveshaper import soft_limiter

__all__ = ["master_streamed", "StreamState", "default_chunk_frames"]


@dataclasses.dataclass
class StreamState:
    """Carried state across chunks: scipy-layout ``(K, 2, C)`` filter
    states of the EQ and of the K-weighting (loudness) filter, and the
    multiband compressor's ``{"crossover": {"lp", "hp"}, "att",
    "ctrl_tail"}`` dict."""

    eq_zi: Any = None
    mb: Any = None
    kw_zi: Any = None


def default_chunk_frames(config: ChainConfig, seconds: float = 30.0) -> int:
    """A chunk length aligned to the 100 ms loudness cell, the compressor
    control hop and the IIR block size, so per-chunk grids concatenate
    into exactly the one-shot grids and every chunk is whole rows.

    The JAX package falls back to cell/hop alignment (and a channel-major
    body) when the request is shorter than that alignment; the port rounds
    up to one aligned chunk instead (1128960 frames for 30 s at 44.1 kHz
    and L = 384).
    """
    cell = int(round(0.1 * config.sample_rate))
    align = math.lcm(cell, max(config.comp_hop, 1), config.block_size)
    frames = int(seconds * config.sample_rate)
    return max(1, frames // align) * align


def _fx_chunk(chunk, params: MasteringParams, config: ChainConfig,
              state: StreamState, chain: MasteringChain,
              need_cells: bool = True):
    """Chain front (and multiband) on one ``(C, nb, L)`` chunk with carried
    state, plus the chunk's loudness cells.  The meter's mono downmix comes
    from the last kernel of the chunk, as in the one-shot chain.  Returns
    ``(y, new_state, cells or None)``."""
    want_mono = (need_cells and chunk.shape[0] > 1
                 and config.measure_downmix == "reference_mono_mean")
    mb_state = state.mb
    meter_rows = None
    if want_mono and not params.multiband:
        y, meter_rows, eq_zi = chain.front(chunk, params, state=state.eq_zi,
                                           return_state=True, emit_mono=True)
    else:
        y, eq_zi = chain.front(chunk, params, state=state.eq_zi,
                               return_state=True)
    if params.multiband:
        out = chain.multiband(y, params, state=mb_state, return_state=True,
                              emit_mono=want_mono)
        if want_mono:
            y, meter_rows, mb_state = out
        else:
            y, mb_state = out
    if not need_cells:
        return y, StreamState(eq_zi=eq_zi, mb=mb_state), None
    meter_sig = y if meter_rows is None else meter_rows[None]
    cells, _, kw_zi = loud.block_cell_energies_rows(
        meter_sig, config.sample_rate, zi=state.kw_zi, return_state=True,
        ops=chain.kweight_ops())
    return y, StreamState(eq_zi=eq_zi, mb=mb_state, kw_zi=kw_zi), cells


def _finalize_chunk(chunk, gain, config: ChainConfig):
    return soft_limiter(chunk * gain, threshold=config.limiter_threshold)


def master_streamed(audio, params: MasteringParams, config: ChainConfig,
                    chunk_seconds: float = 30.0, progress_cb=None,
                    checkpoint_dir=None,
                    transfer: str = "float32", return_meters: bool = False,
                    device="cuda"):
    """Master ``(N, C)`` or ``(N,)`` float audio chunk by chunk on
    ``device``: the card unless the caller passes ``device="cpu"``; raises
    when no card is there.

    Args:
      audio: numpy array.
      progress_cb: optional ``cb(message: str)``.
      checkpoint_dir / transfer="pcm16" / return_meters: not ported yet,
        raise ``NotImplementedError``.

    Returns ``(audio_out (N, C) float32 numpy, measured_lufs, gain_db)``.
    """
    if transfer != "float32":
        raise NotImplementedError(
            f"transfer={transfer!r}: the pcm16 wire is ROADMAP queue 1 item 4")
    if checkpoint_dir:
        raise NotImplementedError(
            "checkpoint_dir: checkpoint/resume is ROADMAP queue 1 item 4")
    if return_meters:
        raise NotImplementedError(
            "return_meters: the R128 meters are ROADMAP queue 1 item 5")
    device = require_device(device, "master_streamed")
    check_supported(params, config)
    check_fp32_matmul(device)
    chain = MasteringChain(config).to(device)
    dtype = config.torch_dtype()

    audio = np.asarray(audio)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[:, None]
    n, c = audio.shape
    L = config.block_size
    chunk_frames = default_chunk_frames(config, chunk_seconds)
    num_chunks = max(1, -(-n // chunk_frames))
    cpb = chunk_frames // L

    # one upload: (num_chunks, C, cpb, L), each chunk a contiguous slice
    whole = np.zeros((num_chunks * chunk_frames, c), np.float32)
    whole[:n] = audio
    wire = np.ascontiguousarray(
        whole.T.reshape(c, num_chunks, cpb, L).transpose(1, 0, 2, 3))
    x_dev = torch.from_numpy(wire).to(device=device, dtype=dtype)

    need_cells = params.lufs_enabled
    state = StreamState()
    processed, cell_list = [], []
    for i in range(num_chunks):
        y, state, cells = _fx_chunk(x_dev[i], params, config, state, chain,
                                    need_cells=need_cells)
        processed.append(y)
        cell_list.append(cells)
        if progress_cb:
            progress_cb(f"Processed chunk {i + 1}/{num_chunks}...")

    cell_len = loud._gating_geometry(config.sample_rate)[0]
    if params.lufs_enabled:
        # only cells wholly inside the real n samples count
        all_cells = torch.cat(cell_list, dim=0)
        mask = (torch.arange(all_cells.shape[0], device=all_cells.device)
                < (n // cell_len))
        measured = loud.loudness_from_cells(all_cells, cell_mask=mask)
        gain = loud.gain_for_target(measured, params.lufs)
    else:
        measured = torch.tensor(float("nan"))
        gain = torch.ones((), dtype=dtype, device=device)

    finalized = []
    for i, y in enumerate(processed):
        finalized.append(_finalize_chunk(y, gain, config))
        if progress_cb:
            progress_cb(f"Finalizing chunk {i + 1}/{num_chunks}...")
    out = torch.cat(finalized, dim=1).reshape(c, -1)[:, :n]
    out = np.ascontiguousarray(out.T.cpu().numpy(), dtype=np.float32)
    if squeeze:
        out = out[:, 0]
    gain_db = 20.0 * math.log10(float(gain))
    return out, float(measured), gain_db
