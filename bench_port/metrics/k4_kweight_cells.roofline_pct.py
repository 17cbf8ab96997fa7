"""K4 kweight_cells's share of its roofline (``roofline.share``, counted by
``rooflines/k4_kweight_cells.py``)."""

from bench_port.roofline import share

NAME = "k4_kweight_cells.roofline_pct"
UNIT = "%"
LAYER = "K4 kweight_cells"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k4_kweight_cells")
