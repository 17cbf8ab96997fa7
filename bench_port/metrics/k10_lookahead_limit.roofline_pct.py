"""K10 lookahead_limit's share of its roofline (``roofline.share``,
counted by ``rooflines/k10_lookahead_limit.py``, the lookahead limiter's
work); None where the traced window holds none of its launches."""

from bench_port.roofline import share

NAME = "k10_lookahead_limit.roofline_pct"
UNIT = "%"
LAYER = "K10 lookahead_limit"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k10_lookahead_limit")
