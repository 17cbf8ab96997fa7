"""Quality mode on the port's batched album path (``parallel.batch.
make_album_fn`` → ``MasteringChain.forward_tracks``): each track of a
zero-padded album is limited to its own end, so it equals its own one-shot
quality ``master()``.

Three tracks of 1.8-3.2 s at 44.1 kHz, padded to 3.5 s, at -8 LUFS (the
lookahead true-peak limiter works on most peaks).  Limit: 2e-4 max abs,
the chain budget of the port's other album tests (test_torch_batch.py),
over every sample, the last 200 of each track included.  Each track ends
on the rise of its 55 Hz tone, just before a crest, where the limiter's
attack is still pulling the gain down: there, limiting the padded album
reads the EQ's ring-out and the padding after the track's end, where the
one-shot limiter replicates the track's own last sample, and moves the
last 20-50 samples of two of the tracks by 4e-3-1e-2."""

import dataclasses

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, master
from python_audio_mastering_tpu_torch.models import chain as chain_mod
from python_audio_mastering_tpu_torch.parallel import batch

from .conftest import make_signal

FS = 44100
# 98, 137 and 176 cycles of 55 Hz and a quarter less 0.01
LENGTHS = (78770, 110041, 141312)
PADDED = int(3.5 * FS)
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -8.0, "multiband": False}
CEILING = 10.0 ** (-1.0 / 20.0)
BUDGET = 2e-4
EDGE = 200


def _config():
    return dataclasses.replace(ChainConfig.gpu_default(FS),
                               limiter_mode="lookahead_truepeak")


def _album():
    tracks = [(make_signal(n, fs=FS, seed=60 + i) * 0.7).astype(np.float32)
              for i, n in enumerate(LENGTHS)]
    padded, lengths = batch.pad_tracks(tracks, multiple=PADDED)
    return tracks, padded, [int(n) for n in lengths]


@pytest.fixture(scope="module")
def album_out():
    tracks, padded, lengths = _album()
    params = MasteringParams.from_settings(SETTINGS)
    fn = batch.make_album_fn(_config(), device="cpu")
    y = fn(torch.from_numpy(padded), params, lengths).numpy()
    return tracks, lengths, y


def test_album_track_equals_its_one_shot_quality_master(album_out):
    tracks, lengths, y = album_out
    params = MasteringParams.from_settings(SETTINGS)
    assert y.shape == (len(tracks), PADDED, 2)
    for i, (x, n) in enumerate(zip(tracks, lengths)):
        one = master(x, params, _config(), device="cpu").numpy()
        d = np.abs(y[i, :n] - one)
        print(f"track {i}: max abs {d.max():.3e}, last {EDGE} samples "
              f"{d[-EDGE:].max():.3e}")
        assert d.max() <= BUDGET
        assert d[-EDGE:].max() <= BUDGET
        assert not y[i, n:].any()


def test_album_sample_peak_stays_under_the_ceiling(album_out):
    _, lengths, y = album_out
    for i, n in enumerate(lengths):
        assert np.abs(y[i, :n]).max() <= CEILING * (1 + 1e-6)
    # the limiter works: the loudness gain alone would go over
    assert np.abs(y).max() > 0.95 * CEILING


def test_quality_limiter_is_the_chain_hook(monkeypatch):
    """The quality branch limits through ``MasteringChain.limiter``, one
    whole track an argument, so a patched hook reaches it."""
    _, padded, lengths = _album()
    seen = []

    def spy(self, x):
        seen.append(tuple(x.shape))
        return x

    monkeypatch.setattr(chain_mod.MasteringChain, "limiter", spy)
    y, _, _ = chain_mod.MasteringChain(_config()).forward_tracks(
        torch.from_numpy(padded), MasteringParams.from_settings(SETTINGS),
        lengths)
    assert seen == [(n, 2) for n in lengths]
    assert np.abs(y.numpy()).max() > 1.0     # nothing limited it


def test_limiter_takes_a_track_or_an_album_of_whole_tracks():
    x = torch.from_numpy((make_signal(FS, fs=FS, seed=5) * 2.0).astype(
        np.float32))
    chain = chain_mod.MasteringChain(_config())
    one = chain.limiter(x)
    both = chain.limiter(torch.stack([x, 0.5 * x]))
    assert torch.equal(both[0], one)
    assert torch.equal(both[1], chain.limiter(0.5 * x))
    assert one.abs().max() <= CEILING * (1 + 1e-6)
