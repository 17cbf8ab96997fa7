"""Device ms per album of the record's host-to-device copies (the
profiler's ``Memcpy HtoD`` activities): the streamed job's upload of its
tracks over the wire, and any smaller upload beside it."""

NAME = "wire.h2d_ms"
UNIT = "ms/call"
LAYER = "host-device wire"
MOVES = "audio_rtf"


def read(ctx):
    return ctx.copy_ms("HtoD")
