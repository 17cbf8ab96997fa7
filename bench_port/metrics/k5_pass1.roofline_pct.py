"""K5 (pass1_hull + pass1_runs)'s share of its roofline
(``roofline.share``, counted by ``rooflines/k5_pass1.py``)."""

from bench_port.roofline import share

NAME = "k5_pass1.roofline_pct"
UNIT = "%"
LAYER = "K5-K7 ballistics"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k5_pass1")
