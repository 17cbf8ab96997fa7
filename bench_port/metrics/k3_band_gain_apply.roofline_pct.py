"""K3 band_gain_apply's share of its roofline (``roofline.share``, counted by
``rooflines/k3_band_gain_apply.py``)."""

from bench_port.roofline import share

NAME = "k3_band_gain_apply.roofline_pct"
UNIT = "%"
LAYER = "K3 band_gain_apply"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k3_band_gain_apply")
