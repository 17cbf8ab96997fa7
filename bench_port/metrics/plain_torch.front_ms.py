"""Plain-torch device time per album launched in ``pam.chain/front``'s own
time (``spans.stage_ms``): the exciter, the width and K1's glue; in the
legacy chain its saturation and its EQ's products and blends."""

from bench_port.spans import stage_ms

NAME = "plain_torch.front_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "front")
