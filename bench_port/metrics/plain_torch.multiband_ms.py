"""Plain-torch device time per album launched in ``pam.chain/multiband``'s
own time (``spans.stage_ms``): the glue of K2, K3 and the ballistics
(K5-K7) and the gains; the legacy bands' products and their sum."""

from bench_port.spans import stage_ms

NAME = "plain_torch.multiband_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "multiband")
