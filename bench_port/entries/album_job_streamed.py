"""The cloud worker's album job as its job API runs it
(``serving/worker.run_job`` → ``engine.process_album_from_uris`` →
``parallel.batch.master_album_streamed``), from the host's tracks to the
host's outputs, without the codec, the blob store or a checkpoint.

The traffic mix names the job's options: ``transfer`` (``"pcm16"``: int16
over the host ↔ device link both ways, the job API's default),
``chunk_seconds`` and ``meters`` (the R128 meters and the true-peak meter
over the output).  The timed call is ``master_album_streamed(tracks,
params, config, transfer=, chunk_seconds=, return_meters=,
device=)`` with no mesh, no checkpoint and no per-track callback: the
tracks quantized on the host, uploaded, cut into chunks, pass A with the
filter, ballistics and K-weighting states carried, the album's loudness
gains, pass B's gain and limiter a chunk at a time, the meters, the
output requantized on the card, read back and dequantized on the host.
Its output is ``(outs, measured, meters)``, the outputs on the host.

At set-up each rendered track is rounded onto the pcm16 grid,
``round(clip(x, −1, 1)·32767)/32767`` in float32, half to even, where a
decoded 16-bit upload lies; the wire's input quantization is then exact,
and the reference masters the samples the program masters.  The tracks
go to the host unpadded, ``(n_i, C)`` float32 NumPy, the form
``engine.conform_album_tracks`` hands the album entry."""

from __future__ import annotations

import math

PCM16_SCALE = 32767.0


def build(config, traffic, device):
    from python_audio_mastering_tpu_torch.parallel.batch import (
        master_album_streamed,
    )

    transfer = str(traffic["transfer"])
    seconds = float(traffic["chunk_seconds"])
    meters = bool(traffic["meters"])

    def fn(tracks, params, lengths):
        return master_album_streamed(tracks, params, config,
                                     transfer=transfer,
                                     chunk_seconds=seconds,
                                     return_meters=meters, device=device)

    return fn


def inputs(batch, plan, traffic):
    import torch

    grid = torch.round(torch.clamp(batch, -1.0, 1.0) * PCM16_SCALE) \
        / PCM16_SCALE
    return [grid[i, :n].cpu().numpy() for i, n in enumerate(plan.lengths)]


def track_in(x, i, n):
    return x[i]


def track_out(y, i, n):
    return y[0][i]


def frames(plan, config, traffic):
    """The chunks that the album's longest track needs, whole: every
    track of a chunk runs through its kernels, silence past its end.  A
    chunk is ``chunk_seconds`` rounded down to whole 100 ms loudness
    cells, control hops and filter blocks (one at the least)."""
    chain = config["chain"]
    fs = int(chain["sample_rate"])
    align = math.lcm(int(round(0.1 * fs)), max(int(chain["comp_hop"]), 1),
                     int(chain["block_size"]))
    chunk = max(1, int(float(traffic["chunk_seconds"]) * fs) // align) \
        * align
    return -(-max(plan.lengths) // chunk) * chunk
