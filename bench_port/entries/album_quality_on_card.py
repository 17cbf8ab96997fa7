"""The port's batched album entry in quality mode: ``album_on_card``'s
call, input and tracks (``parallel.batch.make_album_fn(config)`` →
``MasteringChain.forward_tracks``, the album ``(T, N, C)`` on the card in
one call), with each track's lookahead limiter running over that track's
own length.  So the frames a track that the limiter processes, the only
count this entry's cell reads (``rooflines/lookahead.py``), are the mean
of the album's own track lengths, not the padded length."""

from __future__ import annotations

from bench_port.entries.album_on_card import (  # noqa: F401
    build,
    inputs,
    track_in,
    track_out,
)


def frames(plan, config, traffic):
    return round(sum(plan.lengths) / len(plan.lengths))
