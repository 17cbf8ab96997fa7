"""K10 ``lookahead_limit`` (``csrc/lookahead_limit.cu``): the quality
mode's lookahead true-peak limiter over each track to its own end, one
launch a track.  Its work is the limiter's, counted once by
``rooflines/lookahead.py`` whatever implements it (each frame of each
channel read once and written once, the FIR's 256 FLOP a sample and
channel, 12 a frame); this module names the kernel's launches and reads
that count."""

from bench_port.rooflines.lookahead import count  # noqa: F401

LAUNCHES = ("lookahead_limit",)
