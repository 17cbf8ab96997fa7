"""The one traffic generator: albums of program material, made from
``--seed`` on the device.

A traffic mix is a JSON file under ``bench_port/traffic/`` that this
module reads; nothing in it is code.  Its keys:

* ``albums``: how many distinct albums the run holds on the device and
  dispatches in turn;
* ``content_seed``: draws the albums: each one's preset, the order of
  its lengths and materials, and each track's phases and noise;
* ``tracks_per_album``: tracks a call;
* ``length_s``: ``[low, high]``; every album's tracks take the same
  lengths, the stratified quantiles ``low + (high − low)·(i + ½)/T`` of
  the uniform distribution, so that every seed hands the chain the same
  work in another order;
* ``pad_multiple_s``: the album is padded with silence to its longest
  track, rounded up to this many seconds;
* ``materials``: the program generators (:data:`MATERIALS`), dealt out
  equally over an album's tracks;
* ``presets``: the EQ presets an album's one settings dict draws from;
* ``settings``: the rest of that settings dict (the job payload's keys);
* ``entry`` (optional): the program's entry the albums are handed to,
  ``entries/<entry>.py`` (``album_on_card`` when absent: the rendered
  batch on the card); ``album_job_streamed`` also reads ``transfer``
  (the host ↔ device wire, ``float32`` or ``pcm16``), ``chunk_seconds``
  and ``meters``;
* ``check_tracks``: tracks of the sampled album that the reference
  masters after the window (its longest, and one of the half of the
  album that does not hold it, among them);
* ``trace_albums``: albums the traced run records.

Every seed gets the same albums, and so the same work (the ballistics'
walk, K5, takes longer on some noise than on other), in an order drawn
from ``--seed``; the seed also draws the album and tracks the reference
checks (``correctness``).  ``torch`` is imported
where audio is made, so that the plain reference's worker processes,
which import the harness, never load it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["AlbumPlan", "schedule", "render", "MATERIALS"]


@dataclasses.dataclass(frozen=True)
class TrackPlan:
    frames: int
    material: str
    seed: int


@dataclasses.dataclass(frozen=True)
class AlbumPlan:
    tracks: tuple
    frames: int          # the padded length every track of the batch has
    settings: dict

    @property
    def lengths(self):
        return [t.frames for t in self.tracks]

    def audio_seconds(self, fs):
        return sum(self.lengths) / fs

    def key(self):
        """What a warm-up call has to cover: the padded length and the
        settings."""
        return self.frames, tuple(sorted(self.settings.items()))


def schedule(traffic, fs, seed):
    """The run's albums, as plans (no audio yet): the mix's fixed set of
    albums, drawn from its ``content_seed``, dispatched in an order drawn
    from ``seed``."""
    rng = np.random.default_rng(int(traffic["content_seed"]))
    n_tracks = int(traffic["tracks_per_album"])
    lo, hi = traffic["length_s"]
    lengths = [int(round((lo + (hi - lo) * (i + 0.5) / n_tracks) * fs))
               for i in range(n_tracks)]
    mats = list(traffic["materials"])
    dealt = [mats[i % len(mats)] for i in range(n_tracks)]
    pad = int(round(traffic["pad_multiple_s"] * fs))
    albums = []
    for _ in range(int(traffic["albums"])):
        order = rng.permutation(n_tracks)
        kinds = rng.permutation(n_tracks)
        seeds = rng.integers(0, 2 ** 62, size=n_tracks)
        tracks = tuple(TrackPlan(lengths[order[i]], dealt[kinds[i]],
                                 int(seeds[i])) for i in range(n_tracks))
        preset = traffic["presets"][int(rng.integers(len(traffic["presets"])))]
        frames = -(-max(lengths) // pad) * pad
        albums.append(AlbumPlan(tracks, frames,
                                {**traffic["settings"], "preset": preset}))
    turn = np.random.default_rng(seed).permutation(len(albums))
    return [albums[i] for i in turn]


# ------------------------------------------------------------ materials
# The four program generators of the repository's ballistics study
# (scripts/bal_materials.py): a tonal mix under a slow envelope, pink
# noise, a pulse train and a hot sustained tone pair, each with its
# phases and noise drawn from the track's seed.

def _phase(n, fs, hz, ph, dev):
    """``sin(2π·hz·i/fs + ph)`` for ``i < n``, the phase held in float64."""
    import torch

    i = torch.arange(n, dtype=torch.float64, device=dev)
    return torch.sin(torch.remainder(i * (2.0 * math.pi * hz / fs) + ph,
                                     2.0 * math.pi)).float()


def _bench(n, fs, g, ph, dev):
    import torch

    sig = (0.4 * _phase(n, fs, 55.0, ph[0], dev)
           + 0.2 * _phase(n, fs, 880.0, ph[1], dev)
           + 0.1 * _phase(n, fs, 4200.0, ph[2], dev)
           + 0.05 * torch.randn(n, generator=g, device=dev))
    env = 0.4 + 0.6 * (0.5 + 0.5 * _phase(n, fs, 0.5, ph[3], dev)) ** 2
    s = sig * env
    return torch.stack([s, torch.roll(s, 29)], dim=1)


def _pink(n, fs, g, ph, dev):
    import torch

    nfft = 1 << n.bit_length()
    f = torch.fft.rfft(torch.randn(nfft, generator=g, device=dev))
    f /= torch.clamp_min(torch.arange(f.numel(), device=dev,
                                      dtype=torch.float32).sqrt(), 1.0)
    p = torch.fft.irfft(f, nfft)[:n]
    p = 0.5 * p / p.abs().max()
    return torch.stack([p, torch.roll(p, 13)], dim=1)


def _pulse(n, fs, g, ph, dev):
    import torch

    beat = int(fs * 0.5)
    shift = int(ph[1] / (2.0 * math.pi) * beat)
    i = torch.arange(n, device=dev) + shift
    envp = torch.exp(-5.0 * (torch.remainder(i, beat).float() / beat))
    sig = envp * (_phase(n, fs, 60.0, ph[0], dev)
                  + 0.3 * torch.randn(n, generator=g, device=dev))
    sig = 0.8 * sig / sig.abs().max()
    return torch.stack([sig, torch.roll(sig, 7)], dim=1)


def _sustained(n, fs, g, ph, dev):
    import torch

    env = (0.55 + 0.1 * _phase(n, fs, 0.2, ph[0], dev)
           + 0.05 * _phase(n, fs, 3.1, ph[1], dev))
    sig = env * (_phase(n, fs, 220.0, ph[2], dev)
                 + 0.5 * _phase(n, fs, 3300.0, ph[3], dev))
    return torch.stack([sig, torch.roll(sig, 11)], dim=1)


MATERIALS = {"bench": _bench, "pink": _pink, "pulse": _pulse,
             "sustained": _sustained}


def render(album, fs, channels, device):
    """The album's batch ``(T, frames, C)`` float32 on ``device``, each
    track its material over its length and silence after it."""
    import torch

    if channels != 2:
        raise ValueError("the generators make stereo tracks")
    batch = torch.zeros((len(album.tracks), album.frames, channels),
                        dtype=torch.float32, device=device)
    for i, tr in enumerate(album.tracks):
        g = torch.Generator(device=device)
        g.manual_seed(tr.seed)
        ph = (torch.rand(4, generator=g, device=device, dtype=torch.float64)
              * (2.0 * math.pi)).tolist()
        batch[i, :tr.frames] = MATERIALS[tr.material](tr.frames, fs, g, ph,
                                                      device)
    return batch
