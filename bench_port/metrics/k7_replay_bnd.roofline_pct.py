"""K7 replay_bnd's share of its roofline (``roofline.share``, counted by
``rooflines/k7_replay_bnd.py``)."""

from bench_port.roofline import share

NAME = "k7_replay_bnd.roofline_pct"
UNIT = "%"
LAYER = "K5-K7 ballistics"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k7_replay_bnd")
