"""Carry settings and state over from the JAX package.

The chain has no learned weights: what a job carries is its slider values
(``MasteringParams``), its static configuration (``ChainConfig``) and, in a
streamed job, its filter states.  These functions are duck-typed — they
read attributes and numpy-convertible arrays — so they need no ``jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.ops.limiter import LookaheadLimiterState
from python_audio_mastering_tpu_torch.parallel.streaming import StreamState

__all__ = ["params_from_jax", "album_params_from_jax", "config_from_jax",
           "stream_state_from_jax", "limiter_state_from_jax"]

_BOOL_PARAMS = ("multiband", "lufs_enabled")


def params_from_jax(p) -> MasteringParams:
    """A port ``MasteringParams`` from any object with its attributes."""
    kwargs = {}
    for f in dataclasses.fields(MasteringParams):
        v = getattr(p, f.name)
        kwargs[f.name] = bool(v) if f.name in _BOOL_PARAMS else float(v)
    return MasteringParams(**kwargs)


def album_params_from_jax(params) -> list:
    """The port's per-track album params (a list, as
    ``parallel.batch.master_album_streamed`` takes it) from a sequence of
    JAX ``MasteringParams``, one per track."""
    return [params_from_jax(p) for p in params]


def config_from_jax(cfg) -> ChainConfig:
    """A port ``ChainConfig`` from the JAX one: the fields the port has
    (``mb_kernel``, ``layout`` and ``filter_method`` are execution knobs of
    the JAX package and are dropped)."""
    return ChainConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ChainConfig)})


def stream_state_from_jax(state, device="cpu") -> StreamState:
    """A port ``StreamState`` from the JAX one: its arrays (the
    scipy-layout ``(K, 2, C)`` ``eq_zi``/``kw_zi`` and every array of the
    multiband ``mb`` dict) become float32 tensors on ``device``, dicts
    keeping their keys."""

    def conv(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    return StreamState(eq_zi=conv(state.eq_zi), mb=conv(state.mb),
                       kw_zi=conv(state.kw_zi))


def limiter_state_from_jax(state, device="cpu") -> LookaheadLimiterState:
    """A port ``LookaheadLimiterState`` from the JAX one (a quality stream
    begun in JAX goes on in the port): ``buf`` and ``g`` become tensors on
    ``device`` in their own dtype, ``pend`` stays an int."""
    return LookaheadLimiterState(
        buf=torch.tensor(np.asarray(state.buf), device=device),
        g=torch.tensor(np.asarray(state.g), device=device),
        pend=int(state.pend))
