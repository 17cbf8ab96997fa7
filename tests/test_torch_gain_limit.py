"""The chain's tail, ``ops.gain_limit`` (K9: loudness gain, soft limiter
and unfold to ``(T, n, C)``), on the CPU: its plain version against the
unfused ops the chain ran before it, bit for bit, and against the JAX
package's limiters (rtol 1e-6, atol 1e-6: XLA's own ``tanh`` and
contractions); its VJP against autograd through the plain ops, within
1e-5 of each gradient's max; the chain's CPU path, which keeps the
unfused ops, against the plain version.  The
kernel against its plain version on the card is in
``test_torch_kernels.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import waveshaper as jws
from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import gain_limit as k9
from python_audio_mastering_tpu_torch.ops.waveshaper import (
    soft_limiter,
    soft_limiter_legacy,
)

from .conftest import make_signal

FS = 44100
THR = 0.98
TRACKS, L, NB = 3, 128, 3
N = 301                              # not a multiple of the 4-frame quad
VALID = [FS // 2, 18000]             # frames measured: both over 0.4 s


def _operands(channels, gained, seed=0, dtype=torch.float32):
    """Rows ``(C, T, nb, L)`` hot enough to cross the threshold, and T
    distinct gains (or None)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((channels, TRACKS, NB, L)) * 0.6
    x[..., -1, 64:] = 0.0
    gain = (torch.tensor([0.7, 1.3, 2.1], dtype=dtype) if gained else None)
    return torch.as_tensor(x, dtype=dtype), gain


def _unfused(xr4, gain, variant):
    """The chain's tail before K9: the gain over the padded rows, the
    ``(T, n, C)`` view, the variant's limiter."""
    c, t, nb, blk = xr4.shape
    if gain is not None:
        xr4 = xr4 * gain.view(1, t, 1, 1)
    y = xr4.reshape(c, t, nb * blk)[:, :, :N].permute(1, 2, 0)
    lim = soft_limiter_legacy if variant == "legacy" else soft_limiter
    return lim(y, threshold=THR)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("gained", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_ref_is_the_unfused_tail_bitwise(variant, gained,
                                                   channels):
    xr4, gain = _operands(channels, gained, seed=channels)
    c = channels
    got = k9.gain_limit_ref(xr4.reshape(c, TRACKS, NB * L), gain, N, THR,
                            variant)
    want = _unfused(xr4, gain, variant)
    assert got.shape == (TRACKS, N, c) and got.is_contiguous()
    assert torch.equal(got, want)
    z = xr4 if gain is None else xr4 * gain.view(1, TRACKS, 1, 1)
    assert (z.abs() > THR).float().mean() > 0.05     # the limiter works


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("gained", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_ref_matches_jax(variant, gained, channels):
    xr4, gain = _operands(channels, gained, seed=10 + channels)
    xr = xr4.reshape(channels, TRACKS, NB * L)
    got = k9.gain_limit_ref(xr, gain, N, THR, variant)
    z = xr[:, :, :N].permute(1, 2, 0).numpy()
    if gained:
        z = z * gain.numpy()[:, None, None]          # float32, as torch's
    jlim = jws.soft_limiter_legacy if variant == "legacy" else \
        jws.soft_limiter
    ref = np.asarray(jlim(jnp.asarray(z), threshold=THR))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_gain_limit_takes_the_plain_version_on_cpu():
    """A CPU tensor gets the plain version: no launch, one twin call."""
    xr4, gain = _operands(2, True)
    xr = xr4.reshape(2, TRACKS, NB * L)
    cmb.reset_launch_counts()
    got = k9.gain_limit(xr, gain, N, THR, "worker")
    assert cmb.launch_counts()["gain_limit"] == 0
    assert cmb.plain_calls()["gain_limit_ref"] == 1
    assert torch.equal(got, k9.gain_limit_ref(xr, gain, N, THR, "worker"))
    with pytest.raises(ValueError, match="variant"):
        k9.gain_limit(xr, gain, N, THR, "quality")


@pytest.mark.parametrize("gained", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_gain_limit_vjp_matches_plain_autograd(variant, gained):
    """The autograd Function's backward (the VJP in plain torch) against
    autograd through the plain ops, with respect to the rows and the
    gain, within 1e-5 of each gradient's max; the padding's gradient is
    0."""
    xr4, gain = _operands(2, gained, seed=5)
    xr = xr4.reshape(2, TRACKS, NB * L)
    up = torch.randn((TRACKS, N, 2), generator=torch.Generator().manual_seed(
        3))
    grads = []
    for fn in (k9.gain_limit, k9.gain_limit_ref):
        x_ = xr.clone().requires_grad_(True)
        g_ = None if gain is None else gain.clone().requires_grad_(True)
        cmb.reset_launch_counts()
        (fn(x_, g_, N, THR, variant) * up).sum().backward()
        grads.append((x_.grad, None if g_ is None else g_.grad))
    assert cmb.plain_calls()["gain_limit_ref"] == 1   # the plain autograd's
    (dx, dg), (dx_ref, dg_ref) = grads
    assert torch.all(dx[:, :, N:] == 0)
    assert (dx - dx_ref).abs().max() <= 1e-5 * dx_ref.abs().max()
    if gained:
        assert (dg - dg_ref).abs().max() <= 1e-5 * dg_ref.abs().max()


def _album(variant, lufs):
    cfg = ChainConfig.gpu_default(FS)
    if variant == "legacy":
        cfg = dataclasses.replace(cfg, variant="legacy")
    settings = {"saturation": 20, "preset": "techno", "width": 1.3,
                "lufs": -8.0}
    if not lufs:
        settings["lufs"] = None
    params = MasteringParams.from_settings(settings)
    batch = torch.as_tensor(np.stack([
        make_signal(FS // 2, channels=2, fs=FS, seed=60 + i) * 0.5
        for i in range(2)]).astype(np.float32))
    return MasteringChain(cfg), batch, params


@pytest.mark.parametrize("lufs", [True, False])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_forward_tracks_cpu_path_unchanged(variant, lufs, monkeypatch):
    """On the CPU the chain keeps its unfused tail (no launch, K9's twin
    not called), and its output equals, bit for bit, K9's plain version
    on the gained rows that its limiter was given."""
    chain, batch, params = _album(variant, lufs)
    seen, limiter = [], MasteringChain.limiter

    def spy(self, x):
        seen.append(x)
        return limiter(self, x)

    monkeypatch.setattr(MasteringChain, "limiter", spy)
    cmb.reset_launch_counts()
    y, _, _ = chain.forward_tracks(batch, params, VALID)
    assert cmb.plain_calls()["gain_limit_ref"] == 0
    assert not any(cmb.launch_counts().values())
    (x,) = seen
    assert x.shape == y.shape == batch.shape
    want = k9.gain_limit_ref(x.permute(2, 0, 1), None, x.shape[1],
                             chain.config.limiter_threshold, variant)
    assert torch.equal(y, want)


def test_lookahead_limiter_keeps_the_unfused_tail():
    """The lookahead limiter takes neither K9 nor its twin."""
    chain, batch, params = _album("worker", True)
    chain = MasteringChain(dataclasses.replace(
        chain.config, limiter_mode="lookahead_truepeak"))
    cmb.reset_launch_counts()
    y, _, _ = chain.forward_tracks(batch, params, VALID)
    assert cmb.plain_calls()["gain_limit_ref"] == 0
    assert not any(cmb.launch_counts().values())
    assert y.shape == batch.shape and torch.isfinite(y).all()
