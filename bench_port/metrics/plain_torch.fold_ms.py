"""Plain-torch device time per album launched in ``pam.chain``'s own
time (``spans.stage_ms``): the fold of the album into rows and back, the
operator uploads, the output's slice and transpose."""

from bench_port.spans import stage_ms

NAME = "plain_torch.fold_ms"
UNIT = "ms/call"
LAYER = "plain torch between kernels"
MOVES = "audio_rtf"


def read(ctx):
    return stage_ms(ctx, "chain")
