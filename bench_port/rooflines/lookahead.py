"""The lookahead true-peak limiter (``ops/limiter.lookahead_limiter``,
quality mode) over each track to its own end, whatever implements it:
each frame of each channel read once and written once (float32); the
4x interpolator as a direct FIR, 4 phases of 32 taps, a multiply and an
add a tap, a sample and channel; and 12 operations a position for the
peak envelope, the raw gain, erosion, the moving average, the release
and the gain's multiply.  No kernel of the port's library runs it, so
there are no launches to count."""

from bench_port.roofline import F32

LAUNCHES = ()
FIR_FLOPS = 2 * 4 * 32        # a sample and channel
POSITION_FLOPS = 12           # a frame


def count(shape):
    t, c, n = shape["tracks"], shape["channels"], shape["frames"]
    flops = FIR_FLOPS * c * t * n + POSITION_FLOPS * t * n
    n_bytes = 2 * F32 * c * t * n
    return flops, n_bytes
