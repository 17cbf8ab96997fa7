"""Plain-torch device time per album launched inside the lookahead
limiter's ``truepeak`` spans (``limiter_spans.stage_ms``): the 4x
interpolator (a float32 banded product) and the cross-channel peak
envelope."""

from bench_port.limiter_spans import stage_ms

NAME = "plain_torch.truepeak_ms"
UNIT = "ms/call"
LAYER = "lookahead limiter"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "truepeak")
