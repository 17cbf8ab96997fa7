"""Host ms per album inside ``pam.chain`` less its synchronising calls
(``spans.split``): the host's own time issuing the chain's work."""

from bench_port.spans import split

NAME = "chain.host_issue_ms"
UNIT = "ms/call"
LAYER = "chain host"
MOVES = "album_p95_ms"


def read(ctx):
    s = split(ctx)
    return None if s is None else s.chain_host_ms - s.chain_wait_ms
