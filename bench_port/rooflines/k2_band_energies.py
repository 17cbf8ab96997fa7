"""K2 ``band_energies`` (``csrc/band_energies.cu``): both crossover
filters (2 sections each) over every sample, the subtraction mid band,
the squared bands' channel mean and their ``hop``-bucket sums."""

from bench_port.roofline import F32, SECTION_FLOPS

LAUNCHES = ("band_energies",)
STATES = 4      # a 2-section filter's


def count(shape):
    c, s, L, hop = shape["channels"], shape["samples"], shape["block"], \
        shape["hop"]
    # a channel's sample: 4 sections, mid (2), 3 squares; a frame: the
    # channel mean of 3 bands (3 sums, 3 scalings), 3 bucket sums
    flops = c * s * (4 * SECTION_FLOPS + 2 + 3) + s * (6 + 3)
    n_bytes = F32 * (c * s + 2 * c * shape["rows"] * STATES
                     + 2 * (L * L + STATES * L)
                     + 3 * s // hop)
    return flops, n_bytes
