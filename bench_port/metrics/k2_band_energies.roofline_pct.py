"""K2 band_energies's share of its roofline (``roofline.share``, counted by
``rooflines/k2_band_energies.py``)."""

from bench_port.roofline import share

NAME = "k2_band_energies.roofline_pct"
UNIT = "%"
LAYER = "K2 band_energies"
MOVES = "audio_rtf"


def read(ctx):
    return share(ctx, "k2_band_energies")
