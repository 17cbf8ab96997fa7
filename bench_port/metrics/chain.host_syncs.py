"""Host synchronisations a call makes (``MasteringChain.forward_tracks``
through ``parallel.batch.make_album_fn``), counted with PyTorch's sync
debug mode."""

NAME = "chain.host_syncs"
UNIT = "syncs/call"
LAYER = "chain host"
MOVES = "album_p95_ms"


def read(ctx):
    return ctx.host_syncs
