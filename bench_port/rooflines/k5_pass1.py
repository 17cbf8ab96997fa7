"""K5 (``pass1_hull`` + ``pass1_runs``, ``csrc/ballistics.cu``): every
128-step block's outgoing ballistics state, from the band targets."""

from bench_port.roofline import F32, ballistics_steps

LAUNCHES = ("pass1_hull", "pass1_runs")
STEP_FLOPS = 4      # compare, product, sum, clamp


def count(shape):
    rows, steps = ballistics_steps(shape)
    flops = STEP_FLOPS * rows * steps
    n_bytes = F32 * (rows * steps + 3 * rows + rows * steps // 128)
    return flops, n_bytes
