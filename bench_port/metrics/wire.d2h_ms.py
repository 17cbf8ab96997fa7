"""Device ms per album of the record's device-to-host copies (the
profiler's ``Memcpy DtoH`` activities): the streamed job's readback of
its outputs over the wire, its meters and any smaller readback beside
them."""

NAME = "wire.d2h_ms"
UNIT = "ms/call"
LAYER = "host-device wire"
MOVES = "audio_rtf"


def read(ctx):
    return ctx.copy_ms("DtoH")
