"""Plain-torch device time per album launched inside every ``states``
span (``spans.stage_ms``): ``ops.iir``'s float64 states passes of the
EQ, the crossovers, the legacy EQ and bands, and the K-weighting."""

from bench_port.spans import stage_ms

NAME = "plain_torch.states_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "states")
