"""K1 front_chain's share of its roofline (``roofline.share``, counted by
``rooflines/k1_front_chain.py``)."""

from bench_port.roofline import share

NAME = "k1_front_chain.roofline_pct"
UNIT = "%"
LAYER = "K1 front_chain"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k1_front_chain")
