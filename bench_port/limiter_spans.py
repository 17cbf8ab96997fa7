"""The lookahead limiter's stage spans (``ops/limiter.py``): ``truepeak``
(the 4x interpolator and the peak envelope), ``attack`` (the raw gain,
erosion and the moving average) and ``release`` (the prefix-max scan),
each inside the chain's ``limiter`` span, whose own time keeps the gain's
multiply, the casts and the copy into the album's output.

A stage reads ``spans.stage_ms`` of its span, and None (no reading) where
the record holds no span of that name: a program that does not open it."""

from __future__ import annotations

from bench_port import spans

__all__ = ["LIMITER", "STAGES", "opened", "stage_ms"]

LIMITER = "limiter"
STAGES = ("truepeak", "attack", "release")


def opened(ctx, name):
    """Whether the traced record holds a program span last named
    ``name``."""
    return any(n.startswith(spans.PROGRAM)
               and n.rsplit("/", 1)[-1].removeprefix(spans.PROGRAM) == name
               for n in ctx.host_names)


def stage_ms(ctx, name):
    return spans.stage_ms(ctx, name) if opened(ctx, name) else None
