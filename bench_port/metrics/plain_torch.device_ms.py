"""Device time per album of every activity that the port's kernel
library did not launch: the float64 states passes, the detector,
gating, gain and limiter, the legacy EQ and bands, copies and sets."""

NAME = "plain_torch.device_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return ctx.plain_ms()
