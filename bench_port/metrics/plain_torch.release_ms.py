"""Plain-torch device time per album launched inside the lookahead
limiter's ``release`` spans (``limiter_spans.stage_ms``): the release's
float64 prefix max (log, cummax over rows, exp, min)."""

from bench_port.limiter_spans import stage_ms

NAME = "plain_torch.release_ms"
UNIT = "ms/call"
LAYER = "lookahead limiter"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "release")
