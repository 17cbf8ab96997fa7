"""Automastering: fit the chain's sliders to a reference by gradient descent.

Counterpart of ``python_audio_mastering_tpu.models.automaster``.  The
chain is differentiable in its sliders, so instead of hand-tuning them the
fit *solves* for the saturation, EQ and width that make a track match a
target sound: a reference track's spectral profile and a loudness.  It is
the system's training path: an optimizer loop (``torch.optim.Adam``, the
update of ``optax.adam``) with gradients through the whole chain, biquad
design → blocked IIR → gated loudness.

On the card the forward pass of every step launches the chain's kernels,
``front_chain`` once and ``kweight_cells`` twice (the chain's loudness
normalisation and the loss's meter); their backward passes are plain
torch (``ops.cuda_multiband``).  The EQ operators are built in the graph
in float64 (``ops.iir.blocked_ops_traced``).  θ is in the config's dtype,
float32 by default, as JAX's is without x64.

A batch of tracks is one chain call (:meth:`AutoMasterModel.batch_loss`):
its tracks fold into the kernels' block axis as an album's do, so a step
launches ``front_chain`` once and ``kweight_cells`` twice whatever the
batch size with a shared θ.  Over the ranks of a ``parallel.mesh`` mesh
(:func:`make_train_step` with ``mesh``) each rank takes its own tracks
and θ's gradient is all-reduced before the update: data parallelism, as
the JAX package gets it from a sharded tracks axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from python_audio_mastering_tpu_torch.config import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models.chain import (
    MasteringChain,
    require_device,
)
from python_audio_mastering_tpu_torch.ops import loudness as loud
from python_audio_mastering_tpu_torch.parallel.mesh import tracks_sharding

__all__ = ["AutoMasterModel", "spectral_profile", "latent_to_params", "fit",
           "make_train_step"]

# (name, lo, hi): the tunable slider subspace and its GUI ranges.
_LATENT_SPEC = [
    ("saturation", 0.0, 60.0),
    ("bass_boost", -6.0, 6.0),
    ("mid_cut", -6.0, 6.0),
    ("presence_boost", -6.0, 6.0),
    ("treble_boost", -6.0, 6.0),
    ("width", 0.5, 1.8),
]


def _on(v, device, dtype=None):
    """``v`` (numpy, a JAX array, a list or a tensor) as a tensor on
    ``device``, copied from the host where it is not a tensor."""
    t = v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype)


def latent_to_params(theta, lufs=-14.0):
    """Unconstrained ``theta (6,)`` → in-range MasteringParams via tanh
    (the sliders 0-d tensors of θ)."""
    vals = {}
    for i, (name, lo, hi) in enumerate(_LATENT_SPEC):
        mid, half = (hi + lo) / 2.0, (hi - lo) / 2.0
        vals[name] = mid + half * torch.tanh(theta[i])
    return MasteringParams(lufs=lufs, **vals)


@functools.lru_cache(maxsize=16)
def _band_index(sample_rate, n_bands, n_fft, device):
    """Band of each rFFT bin and the bins a band holds: the bins'
    frequencies placed among float64 log-spaced edges 40 Hz..18 kHz by
    ``torch.searchsorted`` (left side, as ``jnp.searchsorted``)."""
    freqs = torch.fft.rfftfreq(n_fft, 1.0 / sample_rate, dtype=torch.float64)
    edges = torch.logspace(np.log10(40.0), np.log10(18000.0), n_bands + 1,
                           dtype=torch.float64)
    idx = torch.clamp(torch.searchsorted(edges, freqs, right=False) - 1, 0,
                      n_bands - 1)
    cnt = torch.bincount(idx, minlength=n_bands).to(torch.float64)
    return idx.to(device), torch.clamp_min(cnt, 1.0).to(device)


def spectral_profile(x, sample_rate, n_bands=24, n_fft=4096):
    """Log-band energy profile (dB) over log-spaced bands 40 Hz..18 kHz.

    Symmetric-Hann-windowed rFFT power averaged over frames, pooled into
    log-spaced bands (an out-of-place ``index_add``): a compact,
    differentiable "sound" descriptor for matching.  ``x`` is ``(N, C)``
    or ``(N,)`` (numpy or a tensor; the profile lies on its device).
    """
    x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    x = x[None, :, None] if x.ndim == 1 else x[None]
    return _profiles(x, sample_rate, n_bands, n_fft)[0]


def _profiles(x, sample_rate, n_bands=24, n_fft=4096):
    """:func:`spectral_profile` of each track of a batch ``(T, N, C)``:
    ``(T, n_bands)``."""
    x = x.mean(dim=2)
    n = (x.shape[1] // n_fft) * n_fft
    window = torch.hann_window(n_fft, periodic=False, dtype=x.dtype,
                               device=x.device)
    frames = x[:, :n].reshape(x.shape[0], -1, n_fft) * window
    power = (torch.fft.rfft(frames, dim=2).abs() ** 2).mean(dim=1)
    idx, cnt = _band_index(int(sample_rate), n_bands, n_fft, x.device)
    band_pow = power.new_zeros(x.shape[0], n_bands).index_add(1, idx, power)
    return 10.0 * torch.log10(band_pow / cnt.to(power.dtype) + 1e-12)


@dataclasses.dataclass(frozen=True)
class AutoMasterModel:
    """Fit chain params so the mastered audio matches a target profile.

    ``device``: where the chain runs, the card unless the caller passes
    ``device="cpu"``; raises when no card is there.
    """

    config: ChainConfig
    target_lufs: float = -14.0
    n_bands: int = 24
    profile_weight: float = 1.0
    loudness_weight: float = 0.3
    device: Any = "cuda"

    def __post_init__(self):
        dev = require_device(self.device, "AutoMasterModel")
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "_chain", MasteringChain(self.config).to(dev))

    @property
    def chain(self) -> MasteringChain:
        return self._chain

    def as_audio(self, audio):
        """``audio`` as a tensor of the config's dtype on the model's device
        (upload once, outside the step loop)."""
        return _on(audio, self.device, self.config.torch_dtype())

    def loss(self, theta, audio, target_profile):
        """Profile mismatch (mean-removed: the loudness stage owns the
        absolute level) plus the squared loudness error of the mastered
        ``audio`` at the sliders of ``theta``."""
        return self.batch_loss(theta, self.as_audio(audio)[None],
                               _on(target_profile, self.device)[None])[0]

    def batch_loss(self, theta, batch, targets, shared: bool = True):
        """:meth:`loss` of each track of ``batch`` ``(T, N, C)`` (or ``(T,
        N)``) against its row of ``targets`` ``(T, n_bands)``, in one chain
        call (``MasteringChain.forward_tracks``); ``theta`` is one ``(6,)``
        for every track (``shared``) or ``(T, 6)``.  Returns ``(T,)``."""
        cfg = self.config
        batch = self.as_audio(batch)
        if batch.ndim == 2:
            batch = batch[:, :, None]
        params = (latent_to_params(theta, lufs=self.target_lufs) if shared
                  else [latent_to_params(th, lufs=self.target_lufs)
                        for th in theta])
        y, _, _ = self._chain.forward_tracks(batch, params)
        prof = _profiles(y, cfg.sample_rate, self.n_bands)
        target = _on(targets, prof.device)
        d = ((prof - prof.mean(dim=1, keepdim=True))
             - (target - target.mean(dim=1, keepdim=True)))
        l_prof = torch.mean(d ** 2, dim=1)
        tracks, n, c = y.shape
        L = cfg.block_size
        rows = torch.nn.functional.pad(
            y.permute(2, 0, 1), (0, -n % L)).reshape(c, tracks, -1, L)
        measured = loud.integrated_loudness_rows(
            rows, cfg.sample_rate, downmix=cfg.measure_downmix,
            valid_frames=n, ops=self._chain.kweight_ops())
        l_loud = torch.where(torch.isfinite(measured),
                             (measured - self.target_lufs) ** 2,
                             torch.zeros_like(measured))
        return self.profile_weight * l_prof + self.loudness_weight * l_loud


def make_train_step(model: AutoMasterModel, optimizer, shared: bool = True,
                    mesh=None):
    """One optimizer step over a batch of tracks.

    ``optimizer`` holds θ: a leaf tensor that requires grad, ``(6,)`` with
    ``shared=True`` (one θ for every track, the per-track losses meaned)
    or ``(T, 6)`` with ``shared=False`` (a θ per track; the mean's gradient
    is each track's own over T, as JAX's vmapped mean gives it).  The
    batch is one chain call (:meth:`AutoMasterModel.batch_loss`).
    ``step(theta, batch, targets)`` updates θ in place and returns the
    mean loss (a 0-d tensor, before the update).

    ``mesh`` (a ``parallel.mesh`` mesh; the tracks shard over its first
    axis): every rank calls ``step`` with the whole batch ``(T, N, C)``
    and targets; each takes its own rows (``parallel.mesh.
    tracks_sharding``; T must split evenly, as JAX's sharded batch must)
    and differentiates its share of the mean over all T.  With
    ``shared=True`` θ's gradient is then all-reduced (``Mesh.psum``, the
    loss riding in the same collective) before the update, so θ stays the
    same on every rank; with ``shared=False`` each rank's θ holds its own
    tracks' rows ``(T/D, 6)`` and only the loss is summed.  The returned
    loss is the mean over all T.
    """
    axis = None if mesh is None else mesh.axis_names[0]
    sharding = None if mesh is None else tracks_sharding(mesh, axis)

    def step(theta, batch, targets):
        n_tracks = len(batch)
        if sharding is not None:
            batch, targets = sharding.shard(batch), sharding.shard(targets)
        optimizer.zero_grad(set_to_none=True)
        loss = model.batch_loss(theta, batch, targets, shared).sum() \
            / n_tracks
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            if shared:
                both = mesh.psum(torch.cat([theta.grad.reshape(-1),
                                            loss.reshape(1)]), axis)
                theta.grad.copy_(both[:-1].view_as(theta.grad))
                loss = both[-1]
            else:
                loss = mesh.psum(loss, axis)
        optimizer.step()
        return loss

    return step


def fit(model: AutoMasterModel, audio, target_profile, steps=60, lr=0.05,
        theta0=None, callback=None):
    """Fit one track.  Returns ``(MasteringParams, losses)``: the fitted
    sliders (detached 0-d tensors) and each step's loss.

    ``theta0``: the starting θ (zeros by default).
    """
    dt = model.config.torch_dtype()
    if theta0 is None:
        theta = torch.zeros(len(_LATENT_SPEC), dtype=dt, device=model.device)
    else:
        theta = _on(theta0, model.device, dt).clone()
    theta.requires_grad_(True)
    optimizer = torch.optim.Adam([theta], lr=lr)
    batch = model.as_audio(audio)[None]
    targets = _on(target_profile, model.device)[None]
    step = make_train_step(model, optimizer, shared=True)
    losses = []
    for i in range(steps):
        losses.append(float(step(theta, batch, targets)))
        if callback:
            callback(i, losses[-1])
    return latent_to_params(theta.detach(), lufs=model.target_lufs), losses
