"""Plain-torch device time per album launched inside the ``detector``
span (``spans.stage_ms``): the multiband detector
(``ops.multiband._fused_stats_from_ctrl``) and the bucket sums before
it."""

from bench_port.spans import stage_ms

NAME = "plain_torch.detector_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "detector")
