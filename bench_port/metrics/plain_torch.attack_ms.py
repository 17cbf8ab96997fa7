"""Plain-torch device time per album launched inside the lookahead
limiter's ``attack`` spans (``limiter_spans.stage_ms``): the raw gain,
the erosion's doubling passes and the moving average's float64 running
sum."""

from bench_port.limiter_spans import stage_ms

NAME = "plain_torch.attack_ms"
UNIT = "ms/call"
LAYER = "lookahead limiter"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "attack")
