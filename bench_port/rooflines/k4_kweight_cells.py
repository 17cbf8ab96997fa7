"""K4 ``kweight_cells`` (``csrc/kweight_cells.cu``): the 2-section
K-weighting over the mono downmix, squared and summed into buckets of
``gcd(cell, L)`` samples."""

from bench_port.roofline import F32, SECTION_FLOPS

LAUNCHES = ("kweight_cells",)
SECTIONS = 2
STATES = 2 * SECTIONS


def count(shape):
    s, L, h = shape["samples"], shape["block"], shape["kweight_bucket"]
    flops = s * (SECTIONS * SECTION_FLOPS + 2)      # + square, bucket sum
    n_bytes = F32 * (s + shape["rows"] * STATES + L * L + STATES * L
                     + s // h)
    return flops, n_bytes
