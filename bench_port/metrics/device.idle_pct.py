"""The share of the traced window's wall in which no kernel or copy ran
on the device: 1 − (the union of the device intervals) / the window."""

NAME = "device.idle_pct"
UNIT = "%"
LAYER = "device"
MOVES = "audio_rtf"


def read(ctx):
    if not ctx.names or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
