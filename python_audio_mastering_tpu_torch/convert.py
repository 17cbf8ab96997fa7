"""Carry settings and state over from the JAX package.

The chain has no learned weights: what a job carries is its slider values
(``MasteringParams``), its static configuration (``ChainConfig``) and, in a
streamed job, its filter states; an automaster fit carries its θ and its
optimizer state.  These functions are duck-typed — they read attributes
and numpy-convertible arrays — so they need no ``jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.ops.limiter import LookaheadLimiterState
from python_audio_mastering_tpu_torch.ops.multiband import ctrl_tail_from_tail
from python_audio_mastering_tpu_torch.parallel.streaming import StreamState

__all__ = ["params_from_jax", "album_params_from_jax", "config_from_jax",
           "stream_state_from_jax", "limiter_state_from_jax",
           "theta_from_jax", "adam_state_from_optax"]

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
    """A port ``ChainConfig`` from the JAX one: the fields the port has,
    the variant and ``filter_method`` among them.  ``mb_kernel`` and
    ``layout`` are execution knobs of the JAX package (its Pallas/XLA
    switch and its forced row-major layout) and are dropped: the port
    picks its kernels by device, and takes the row-major filter stages by
    ``filter_method`` and length alone."""
    return ChainConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ChainConfig)})


def stream_state_from_jax(state, device="cpu", hop=None) -> StreamState:
    """A port ``StreamState`` from the JAX one: its arrays (the
    scipy-layout ``(K, 2, C)`` ``eq_zi``/``kw_zi`` and every array of the
    multiband ``mb`` dict) become float32 tensors on ``device``, dicts
    keeping their keys.

    A legacy stream's multiband state (the JAX general path: crossover
    ``{lp, hp, mid_hp, mid_lp}``, ``att`` and the sample-rate detector
    ``tail (3, look_pad, C)``) keeps its crossover states and ``att``; its
    tail becomes the port's control-rate ``ctrl_tail`` at the detector's
    ``hop`` (``config.comp_hop``, which must then be given)."""

    def conv(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    mb = conv(state.mb)
    if mb is not None and mb.get("tail") is not None:
        if hop is None:
            raise ValueError("a legacy multiband state carries a sample-rate "
                             "tail: pass the detector's hop")
        mb["ctrl_tail"] = ctrl_tail_from_tail(mb.pop("tail"), hop)
    return StreamState(eq_zi=conv(state.eq_zi), mb=mb,
                       kw_zi=conv(state.kw_zi))


def limiter_state_from_jax(state, device="cpu") -> LookaheadLimiterState:
    """A port ``LookaheadLimiterState`` from the JAX one (a quality stream
    begun in JAX goes on in the port): ``buf`` and ``g`` become tensors on
    ``device`` in their own dtype, ``pend`` stays an int."""
    return LookaheadLimiterState(
        buf=torch.tensor(np.asarray(state.buf), device=device),
        g=torch.tensor(np.asarray(state.g), device=device),
        pend=int(state.pend))


def theta_from_jax(theta, device="cpu"):
    """An automaster θ (JAX array, ``(6,)`` or a batch's ``(T, 6)``) as a
    tensor on ``device``, in its own dtype."""
    return torch.tensor(np.asarray(theta), device=device)


def _adam_leaf(state):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an optax
    state, which ``optax.adam`` nests in a tuple of chained states."""
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            leaf = _adam_leaf(s)
            if leaf is not None:
                return leaf
    return None


def adam_state_from_optax(opt_state, lr):
    """A ``torch.optim.Adam`` state dict for one parameter (θ) from an
    ``optax.adam`` state: ``mu`` → ``exp_avg``, ``nu`` → ``exp_avg_sq``,
    ``count`` → ``step``, so that a fit begun in JAX goes on in the port
    (``optimizer.load_state_dict``, then ``models.automaster.
    make_train_step``).  The moments keep their dtype; the
    optimizer's ``load_state_dict`` moves them to θ's device and dtype.
    The hyperparameters are ``optax.adam``'s defaults (β 0.9 and 0.999,
    ε 1e-8), which are ``torch.optim.Adam``'s."""
    leaf = _adam_leaf(opt_state)
    if leaf is None:
        raise ValueError("no optax Adam state (count, mu, nu) found")
    groups = torch.optim.Adam([torch.zeros(1)],
                              lr=lr).state_dict()["param_groups"]
    return {"state": {0: {
        "step": torch.tensor(float(np.asarray(leaf.count)),
                             dtype=torch.float32),
        "exp_avg": torch.tensor(np.asarray(leaf.mu)),
        "exp_avg_sq": torch.tensor(np.asarray(leaf.nu))}},
        "param_groups": groups}
