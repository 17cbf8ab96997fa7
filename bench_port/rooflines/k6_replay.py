"""K6 ``replay`` (``csrc/ballistics.cu``): every step's ballistics state,
each 128-step block replayed from its incoming state."""

from bench_port.roofline import F32, ballistics_steps

LAUNCHES = ("replay",)
STEP_FLOPS = 4


def count(shape):
    rows, steps = ballistics_steps(shape)
    flops = STEP_FLOPS * rows * steps
    n_bytes = F32 * (rows * steps + 2 * rows + rows * steps // 128
                     + rows * steps)
    return flops, n_bytes
