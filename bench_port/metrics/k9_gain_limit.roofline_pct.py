"""K9 gain_limit's share of its roofline (``roofline.share``, counted by
``rooflines/k9_gain_limit.py``)."""

from bench_port.roofline import share

NAME = "k9_gain_limit.roofline_pct"
UNIT = "%"
LAYER = "K9 gain_limit"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k9_gain_limit")
