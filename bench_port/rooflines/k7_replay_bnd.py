"""K7 ``replay_bnd`` (``csrc/ballistics.cu``): the block-boundary fixed
point, counted as the one pass over the targets that the boundary
states need (its further rounds are the implementation's)."""

from bench_port.roofline import F32, ballistics_steps

LAUNCHES = ("replay_bnd",)
STEP_FLOPS = 4


def count(shape):
    rows, steps = ballistics_steps(shape)
    flops = STEP_FLOPS * rows * steps
    n_bytes = F32 * (rows * steps + 3 * rows + rows * steps // 128)
    return flops, n_bytes
