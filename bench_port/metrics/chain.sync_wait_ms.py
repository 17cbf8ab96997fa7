"""Host ms per album spent in synchronising runtime calls (names holding
``Synchronize``) inside ``pam.chain`` (``spans.split``): the host
waiting for the card inside ``MasteringChain.forward_tracks``."""

from bench_port.spans import split

NAME = "chain.sync_wait_ms"
UNIT = "ms/call"
LAYER = "chain host"
MOVES = "album_p95_ms"


def read(ctx):
    s = split(ctx)
    return None if s is None else s.chain_wait_ms
