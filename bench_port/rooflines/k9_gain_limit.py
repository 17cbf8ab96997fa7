"""K9 ``gain_limit`` (``csrc/gain_limit.cu``): the chain's tail, each
track's loudness gain, the soft limiter and the unfold from the rows form
to the mastered ``(T, N, C)``: the album's frames read once and written
once, the gains read once."""

from bench_port.roofline import F32

LAUNCHES = ("gain_limit",)
# the worker limiter's pointwise steps: abs, subtract, divide, square,
# add, sqrt, divide, add, sign, multiply, compare, select
LIMITER_FLOPS = 12


def count(shape):
    t, c, n = shape["tracks"], shape["channels"], shape["frames"]
    gained = shape["lufs"]
    flops = c * t * n * (LIMITER_FLOPS + (1 if gained else 0))
    n_bytes = F32 * (c * t * n + t * n * c + (t if gained else 0))
    return flops, n_bytes
