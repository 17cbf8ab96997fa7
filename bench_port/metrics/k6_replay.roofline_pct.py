"""K6 replay's share of its roofline (``roofline.share``, counted by
``rooflines/k6_replay.py``)."""

from bench_port.roofline import share

NAME = "k6_replay.roofline_pct"
UNIT = "%"
LAYER = "K5-K7 ballistics"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k6_replay")
