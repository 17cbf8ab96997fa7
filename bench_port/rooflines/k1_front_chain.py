"""K1 ``front_chain`` (``csrc/front_chain.cu``): exciter, the 4-section EQ
and the stereo width over every sample of the album's rows; without
the multiband stage it also writes the mono downmix."""

from bench_port.roofline import F32, SECTION_FLOPS

LAUNCHES = ("front_chain",)
SECTIONS = 4
STATES = 2 * SECTIONS


def count(shape):
    c, s, L = shape["channels"], shape["samples"], shape["block"]
    mono = not shape["multiband"] and shape["lufs"] and c > 1
    # exciter: 2 products, tanh, 1 product, 1 sum; width: 3 a sample
    flops = c * s * (5 + SECTIONS * SECTION_FLOPS + 3) + (2 * s if mono else 0)
    n_bytes = F32 * (c * s                      # x
                     + c * shape["rows"] * STATES   # incoming states
                     + L * L + STATES * L           # the EQ's operator
                     + c * s                        # y
                     + (s if mono else 0))          # mono
    return flops, n_bytes
