"""Plain-torch device time per album launched in ``pam.chain/loudness``'s
own time (``spans.stage_ms``): the downmix, the gating and the gain;
K4 and the K-weighting's states pass are not in it."""

from bench_port.spans import stage_ms

NAME = "plain_torch.loudness_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "loudness")
