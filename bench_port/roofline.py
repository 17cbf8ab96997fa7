"""A kernel's share of its roofline: the least time the card could take
for the album's work in that kernel (``rooflines/<kernel>.py`` counts
its bytes and operations from the album's shapes; ``peaks`` holds the
rates) over the kernel's device time per album (``device_trace``).

The counts are of the work itself, whatever implements it: each input
byte read once and each output byte written once, and the arithmetic of
the recurrence (a biquad section's five multiply-adds a sample, ten
operations) and of the pointwise stages, one operation each (``tanh``
included).  A blocked product's operations are one implementation's
work and are not counted."""

from __future__ import annotations

import math

from bench_port import peaks, registry

__all__ = ["share", "album_shape", "SECTION_FLOPS"]

SECTION_FLOPS = 10.0      # one biquad section, one sample
F32 = 4                   # bytes


def album_shape(config, frames, tracks, channels, multiband, lufs=True):
    """The shapes of one album call, as the roofline counts read them."""
    chain = config["chain"]
    L = int(chain["block_size"])
    nb = -(-frames // L)
    fs = int(chain["sample_rate"])
    cell = int(round(0.1 * fs))
    return {"tracks": tracks, "frames": frames, "channels": channels,
            "block": L, "blocks": nb, "rows": tracks * nb,
            "samples": tracks * nb * L, "hop": int(chain["comp_hop"]),
            "kweight_bucket": math.gcd(cell, L), "multiband": multiband,
            "lufs": lufs, "variant": chain.get("variant", "worker")}


def ballistics_steps(shape):
    """``(rows, steps)`` of the ballistics timeline: 3 bands a track,
    ``nb·L / hop`` control steps padded to blocks of 128."""
    t = -(-shape["blocks"] * shape["block"] // shape["hop"])
    return 3 * shape["tracks"], -(-t // 128) * 128


def share(ctx, kernel):
    """``kernel``'s roofline share in %, or None where the traced window
    holds none of its launches."""
    mod = registry.roofline(kernel)
    ms = ctx.kernel_ms(mod.LAUNCHES)
    if ms is None or ms <= 0:
        return None
    counts = [mod.count(s) for s in ctx.shape]     # a traced album each
    flops = sum(c[0] for c in counts) / len(counts)
    n_bytes = sum(c[1] for c in counts) / len(counts)
    seconds, _ = peaks.bound_seconds(flops, n_bytes)
    return 100.0 * seconds * 1e3 / ms
