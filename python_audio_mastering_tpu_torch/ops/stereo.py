"""Mid/side stereo width (counterpart of
``python_audio_mastering_tpu.ops.stereo``; reference engine:136-144)."""

from __future__ import annotations

import torch

__all__ = ["stereo_width"]


def stereo_width(x, width_factor, channel_axis=1):
    """``mid = (L+R)/2``, ``side = (L-R)/2·width``, remixed to L/R.

    A no-op unless the channel axis holds exactly two channels.
    ``channel_axis=0`` takes channel-major / rows-form audio.  A tensor
    ``width_factor`` stays in the graph.
    """
    if x.ndim == 1 or x.shape[channel_axis] != 2:
        return x
    left, right = x.unbind(channel_axis)
    mid = (left + right) * 0.5
    w = (width_factor if isinstance(width_factor, torch.Tensor)
         else float(width_factor))
    side = (left - right) * (0.5 * w)
    return torch.stack([mid + side, mid - side], dim=channel_axis)
