"""K3 ``band_gain_apply`` (``csrc/band_gain_apply.cu``): both crossover
filters again over every sample, the control-rate gains applied and the
bands recombined, and the mono downmix for the loudness meter."""

from bench_port.roofline import F32, SECTION_FLOPS

LAUNCHES = ("band_gain_apply",)
STATES = 4


def count(shape):
    c, s, L, hop = shape["channels"], shape["samples"], shape["block"], \
        shape["hop"]
    mono = shape["lufs"] and c > 1
    # a channel's sample: 4 sections, x·g_mid + low·c1 + high·c2 (5)
    flops = c * s * (4 * SECTION_FLOPS + 5) + (2 * s if mono else 0)
    n_bytes = F32 * (c * s + 2 * c * shape["rows"] * STATES
                     + 2 * (L * L + STATES * L)
                     + 3 * s // hop            # the gain columns
                     + c * s + (s if mono else 0))
    return flops, n_bytes
