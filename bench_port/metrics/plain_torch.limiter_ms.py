"""Plain-torch device time per album launched inside the ``limiter`` span
(``spans.stage_ms``): the soft limiter."""

from bench_port.spans import stage_ms

NAME = "plain_torch.limiter_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "limiter")
