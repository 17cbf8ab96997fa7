"""The port's batched album entry on the card, the default of a traffic
mix that names none: ``parallel.batch.make_album_fn(config)`` →
``MasteringChain.forward_tracks``.  Each album is the rendered ``(T, N,
C)`` float32 batch as it lies on the card, padded, mastered in one call,
each track's loudness over its own length; the output stays on the card.

An entry module declares ``build(config, traffic, device)`` (the timed
call ``fn(x, params, lengths)``), ``inputs(batch, plan, traffic)`` (the
call's input made at set-up from the rendered album), ``track_in(x, i,
n)`` and ``track_out(y, i, n)`` (track ``i``'s unpadded ``(n, C)`` input
and output on the host, for the reference) and ``frames(plan, config,
traffic)`` (the frames a track that the kernels process, for the
roofline counts)."""

from __future__ import annotations


def build(config, traffic, device):
    from python_audio_mastering_tpu_torch.parallel.batch import make_album_fn

    return make_album_fn(config, device=device)


def inputs(batch, plan, traffic):
    return batch


def track_in(x, i, n):
    return x[i, :n].cpu().numpy()


track_out = track_in


def frames(plan, config, traffic):
    return plan.frames
