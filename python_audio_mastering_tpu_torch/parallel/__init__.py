"""Execution over time and over ranks: chunked streaming
(``parallel.streaming``), the album (``parallel.batch``, data parallel over
the tracks), sequence parallelism (``parallel.sequence``) and the mesh of
``torch.distributed`` ranks they run on (``parallel.mesh``)."""

from python_audio_mastering_tpu_torch.parallel.mesh import (
    make_mesh,
    tracks_sharding,
)
from python_audio_mastering_tpu_torch.parallel.batch import (
    make_album_fn,
    master_album,
    pad_tracks,
    stack_params,
)
from python_audio_mastering_tpu_torch.parallel.streaming import (
    StreamState,
    default_chunk_frames,
    master_streamed,
)

__all__ = ["make_mesh", "tracks_sharding", "master_album", "make_album_fn",
           "pad_tracks", "stack_params", "master_streamed", "StreamState",
           "default_chunk_frames"]
