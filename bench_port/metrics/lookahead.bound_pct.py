"""The lookahead limiter's share of its bound: the least time the card
could take for its work (``rooflines/lookahead.py``, ``peaks.
bound_seconds``) over the plain device time of the ``limiter`` span and
its ``truepeak``, ``attack`` and ``release`` stages
(``limiter_spans.stage_ms``), in %; None where any of them has no
reading.  Not a kernel's roofline share: no kernel of the port's library
runs the limiter."""

from bench_port import peaks, registry
from bench_port.limiter_spans import LIMITER, STAGES, stage_ms

NAME = "lookahead.bound_pct"
UNIT = "%"
LAYER = "lookahead limiter"
MOVES = "audio_rtf"


def read(ctx):
    parts = [stage_ms(ctx, s) for s in (LIMITER, *STAGES)]
    if any(p is None for p in parts) or sum(parts) <= 0:
        return None
    count = registry.roofline("lookahead").count
    counts = [count(s) for s in ctx.shape]      # a traced album each
    flops = sum(c[0] for c in counts) / len(counts)
    n_bytes = sum(c[1] for c in counts) / len(counts)
    seconds, _ = peaks.bound_seconds(flops, n_bytes)
    return 100.0 * seconds * 1e3 / sum(parts)
