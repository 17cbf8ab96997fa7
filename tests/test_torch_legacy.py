"""The port's legacy chain (``variant="legacy"``, the monolith service's
engine) against the JAX package, on the same numpy-seeded inputs.

JAX runs its own functions on the CPU: the legacy chain with
``comp_ballistics="scan"`` (its exact execution; its Pallas ballistics
have no interpret mode on that route), its EQ and crossovers as float64
scan filters.  Limits:

* ``saturate_legacy``, ``soft_limiter_legacy``: 1e-6 abs;
* the legacy EQ and ``crossover_split(variant="legacy")`` against the
  float64 scan filters: 2e-5 of the max (test_pallas_multiband.py:44);
* ``master()``, ``master_streamed`` and the albums: < 2e-4 max abs and
  < 1e-3 LU (the JAX kernels-vs-XLA chain budget,
  test_pallas_multiband.py:269);
* the ``front_chain`` plain twin with the worker's exciter: bitwise the
  worker front it replaced (saturate, EQ, width).

The streamed legacy chain runs the worker EQ cascade, as the JAX streamed
runner does (JAX parallel/streaming.py:44, :277-282), where one-shot
``master()`` runs the legacy EQ (JAX models/chain.py:303-305): the port
reproduces both, and a test prints how far the JAX package's two lie
apart (ROADMAP queue 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu import master as jmaster
from python_audio_mastering_tpu.models import chain as jchain
from python_audio_mastering_tpu.ops import multiband as jmb
from python_audio_mastering_tpu.ops import waveshaper as jws
from python_audio_mastering_tpu.parallel import batch as jbatch
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import (
    ChainConfig,
    MasteringChain,
    MasteringParams,
    convert,
    master,
)
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import multiband as mb
from python_audio_mastering_tpu_torch.ops import waveshaper as ws
from python_audio_mastering_tpu_torch.parallel import batch, streaming

from .conftest import make_signal

FS = 44100
FS48 = 48000          # the streamed tests: 0.2 s chunk alignment at L = 384
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
# a cut on both shelves and a boosted mid: the other blend branch
CUT = {"saturation": 35, "bass_boost": -4.0, "mid_cut": -2.5,
       "presence_boost": 1.5, "treble_boost": -3.0, "width": 0.8,
       "lufs": -16.0}
MAX_ABS, MAX_LU = 2e-4, 1e-3


def _legacy(cfg, **kw):
    return dataclasses.replace(cfg, variant="legacy", **kw)


def _jcfg(fs=FS, **kw):
    return _legacy(JConfig.tpu_default(fs), comp_ballistics="scan", **kw)


def _pcfg(fs=FS, **kw):
    return _legacy(ChainConfig.gpu_default(fs), **kw)


def _signal(seconds, channels=2, fs=FS, seed=1):
    return (make_signal(int(seconds * fs), channels=channels, fs=fs,
                        seed=seed) * 0.5).astype(np.float32)


def _close_lufs(a, b):
    a, b = float(a), float(b)
    if np.isinf(a) or np.isinf(b):
        assert a == b          # both gated out (a signal under 0.4 s)
    else:
        assert abs(a - b) < MAX_LU


@pytest.mark.parametrize("amount", [0.0, 12.0, 20.0, 73.0])
def test_legacy_waveshapers_match_jax(amount):
    x = (make_signal(4096, seed=5) * 1.7).astype(np.float32)
    got = ws.saturate_legacy(torch.from_numpy(x), amount).numpy()
    ref = np.asarray(jws.saturate_legacy(jnp.asarray(x), amount))
    assert np.abs(got - ref).max() <= 1e-6
    if amount == 0.0:
        np.testing.assert_array_equal(got, x)
    got = ws.soft_limiter_legacy(torch.from_numpy(x), 0.98).numpy()
    ref = np.asarray(jws.soft_limiter_legacy(jnp.asarray(x), 0.98))
    assert np.abs(got - ref).max() <= 1e-6
    # the kernel's form of the legacy exciter, dry·x + wet·tanh(drive·x)
    coefs = ws.exciter_coefs(amount, "legacy")
    got = ws.exciter(torch.from_numpy(x), coefs).numpy()
    assert np.abs(got - ws.saturate_legacy(torch.from_numpy(x),
                                           amount).numpy()).max() <= 1e-6


@pytest.mark.parametrize("settings", [SETTINGS, CUT], ids=["boost", "cut"])
def test_legacy_eq_matches_jax_float64(settings):
    x = _signal(0.5)
    params = MasteringParams.from_settings(settings)
    chain = MasteringChain(_pcfg())
    rows = iir.to_rows(torch.from_numpy(x), 384)
    got = iir.from_rows(chain.legacy_eq(rows, params), x.shape[0]).numpy()
    cfg64 = dataclasses.replace(_jcfg(), dtype="float64",
                                filter_method="scan")
    with jax.enable_x64(True):
        ref = np.asarray(jchain._apply_eq_legacy(
            jnp.asarray(x, jnp.float64), JParams.from_settings(settings),
            cfg64))
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_crossover_split_legacy_matches_jax_float64():
    """The three legacy bands, one chunk and two (the second resumed from
    the first's states, the JAX state layout ``{lp, hp, mid_hp, mid_lp}``),
    against the JAX float64 scan crossovers."""
    x = _signal(0.4, seed=3)
    half = 7000
    with jax.enable_x64(True):
        ref, ref_zf = jmb.crossover_split(jnp.asarray(x, jnp.float64), FS,
                                          variant="legacy",
                                          filter_method="scan")
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    got, zf = mb.crossover_split(torch.from_numpy(x), FS, variant="legacy")
    assert set(zf) == set(ref_zf) == {"lp", "hp", "mid_hp", "mid_lp"}
    assert np.abs(got.numpy() - ref).max() <= 2e-5 * scale
    for k in zf:
        np.testing.assert_allclose(zf[k].numpy(), np.asarray(ref_zf[k]),
                                   rtol=0, atol=2e-5 * scale)
    a, za = mb.crossover_split(torch.from_numpy(x[:half]), FS,
                               variant="legacy")
    b, _ = mb.crossover_split(torch.from_numpy(x[half:]), FS,
                              variant="legacy", zi=za)
    assert np.abs(torch.cat([a, b], 1).numpy() - ref).max() <= 2e-5 * scale


@pytest.mark.parametrize("multiband", [False, True], ids=["mb_off", "mb_on"])
@pytest.mark.parametrize("seconds,channels", [(1.0, 2), (1.0, 1), (0.03, 2)],
                         ids=["stereo", "mono", "short"])
def test_legacy_master_matches_jax(seconds, channels, multiband):
    x = _signal(seconds, channels=channels)
    settings = {**SETTINGS, "multiband": multiband}
    ref = jmaster(jnp.asarray(x), JParams.from_settings(settings), _jcfg(),
                  return_result=True)
    got = master(x, MasteringParams.from_settings(settings),
                 _pcfg(comp_ballistics="scan"), return_result=True,
                 device="cpu")
    assert np.abs(got.audio.numpy() - np.asarray(ref.audio)).max() < MAX_ABS
    _close_lufs(got.measured_lufs, ref.measured_lufs)
    # "auto" (the collapse mode on the card) gives the same bits as "scan"
    auto = master(x, MasteringParams.from_settings(settings), _pcfg(),
                  device="cpu")
    assert torch.equal(auto, got.audio)


@functools.cache
def _streamed_refs(multiband):
    x = _signal(1.5, fs=FS48, seed=4)
    jp = JParams.from_settings({**SETTINGS, "multiband": multiband})
    streamed = jstream.master_streamed(x, jp, _jcfg(FS48),
                                       chunk_seconds=0.6)
    one_shot = np.asarray(jmaster(jnp.asarray(x), jp, _jcfg(FS48)))
    return x, streamed, one_shot


@pytest.mark.parametrize("multiband", [False, True], ids=["mb_off", "mb_on"])
def test_legacy_master_streamed_matches_jax(multiband):
    """Three chunks of 0.6 s: the port's streamed legacy chain against the
    JAX one (the worker EQ behind the legacy saturation in both), and the
    reference's quirk printed: JAX's legacy ``master()`` against its own
    legacy ``master_streamed()``."""
    x, (ref, ref_lufs, _), one_shot = _streamed_refs(multiband)
    got, lufs, _ = streaming.master_streamed(
        x, MasteringParams.from_settings({**SETTINGS,
                                          "multiband": multiband}),
        _pcfg(FS48), chunk_seconds=0.6, device="cpu")
    assert np.abs(got - np.asarray(ref)).max() < MAX_ABS
    assert abs(lufs - float(ref_lufs)) < MAX_LU
    d = np.abs(one_shot - np.asarray(ref))
    print(f"JAX legacy master() vs JAX legacy master_streamed(), multiband "
          f"{multiband}: max abs {d.max():.4g}, rms "
          f"{np.sqrt(np.mean(d ** 2)):.4g}")
    assert d.max() > 1e-2      # the two EQs differ: the quirk is real


@functools.cache
def _album_refs(multiband):
    tracks = [_signal(s, fs=FS48, seed=20 + i)
              for i, s in enumerate((0.9, 1.3))]
    settings = [{**SETTINGS, "multiband": multiband},
                {**CUT, "multiband": multiband}]
    cfg = _jcfg(FS48, comp_block_ctrl=None)
    jp = [JParams.from_settings(s) for s in settings]
    return (tracks, settings, jbatch.master_album(tracks, jp, cfg),
            jbatch.master_album_streamed(tracks, jp, cfg,
                                         chunk_seconds=0.6)[0])


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["master_album", "master_album_streamed"])
@pytest.mark.parametrize("multiband", [False, True], ids=["mb_off", "mb_on"])
def test_legacy_albums_match_jax(multiband, streamed):
    """Two tracks of their own settings (a boost and a cut): the one-shot
    album runs the legacy EQ, as the JAX album's vmapped ``master`` does,
    the streamed album the worker EQ, as JAX's does; each track also
    equals its own port entry point's run."""
    tracks, settings, ref_album, ref_streamed = _album_refs(multiband)
    params = [MasteringParams.from_settings(s) for s in settings]
    cfg = _pcfg(FS48)
    if streamed:
        got, _ = batch.master_album_streamed(tracks, params, cfg,
                                             chunk_seconds=0.6, device="cpu")
        refs = ref_streamed
        own = [streaming.master_streamed(x, p, cfg, chunk_seconds=0.6,
                                         device="cpu")[0]
               for x, p in zip(tracks, params)]
    else:
        got = batch.master_album(tracks, params, cfg, device="cpu")
        refs = ref_album
        own = [master(x, p, cfg, device="cpu").numpy()
               for x, p in zip(tracks, params)]
    for g, r, o in zip(got, refs, own):
        assert g.shape == np.asarray(r).shape
        assert np.abs(g - np.asarray(r)).max() < MAX_ABS
        assert np.abs(g - o).max() < MAX_ABS


def test_front_chain_plain_twin_keeps_the_worker_bits():
    """``front_chain_ref`` now takes the exciter as ``(dry, wet, drive)``;
    with the worker's coefficients it is bitwise the front it replaced:
    ``(1 − mix)·x + mix·tanh(drive·x)``, the EQ product, the width."""
    chain = MasteringChain(ChainConfig.gpu_default(FS))
    x = torch.from_numpy(_signal(0.3, seed=7))
    xr = iir.to_rows(x, 384)
    for pct in (0.0, 20.0, 55.0):
        params = MasteringParams.from_settings({**SETTINGS,
                                                "saturation": pct})
        ops = chain.eq_ops(params)
        s_in, _, _ = iir.sosfilt_states_rows(None, ws.saturate(xr, pct),
                                             ops=ops)
        got = cmb.front_chain_ref(xr, s_in, ops.t, ops.w,
                                  ws.exciter_coefs(pct), params.width)
        mix, drive = ws.saturation_coefs(pct)
        xs = (1.0 - mix) * xr + mix * torch.tanh(xr * drive)
        c, nb, L = xr.shape
        y = (xs.reshape(c * nb, L) @ ops.t
             + s_in.reshape(c * nb, -1) @ ops.w.T).reshape(c, nb, L)
        mid, side = (y[0] + y[1]) * 0.5, (y[0] - y[1]) * (0.5 * params.width)
        assert torch.equal(got, torch.stack([mid + side, mid - side]))
        assert torch.equal(got, cmb.front_chain_ref(
            xr, s_in, ops.t, ops.w, pct, params.width))


def test_legacy_stream_state_converts_from_jax():
    """A legacy multiband stream begun in JAX goes on in the port: JAX's
    state (crossover ``{lp, hp, mid_hp, mid_lp}``, ``att``, sample-rate
    ``tail``) through ``convert.stream_state_from_jax`` (the tail becomes
    the control-rate one at the detector's hop) continues the second
    chunk as JAX continues it."""
    x = _signal(0.8, fs=FS48, seed=9)
    half = 19200                       # whole hop-8 steps
    kw = dict(thresholds_db=(-25.0, -20.0, -15.0), ratios=(6.0, 3.0, 4.0),
              variant="legacy", hop=8)
    y1, st = jmb.multiband_compress(jnp.asarray(x[:half]), FS48,
                                    return_state=True, ballistics="scan",
                                    filter_method="blocked", **kw)
    ref = np.asarray(jmb.multiband_compress(
        jnp.asarray(x[half:]), FS48, state=st, ballistics="scan",
        filter_method="blocked", **kw))
    state = convert.stream_state_from_jax(
        jstream.StreamState(mb=st), hop=8)
    assert set(state.mb) == {"crossover", "att", "ctrl_tail"}
    got = mb.multiband_compress(torch.from_numpy(x[half:]), FS48,
                                state=state.mb, ballistics="scan", **kw)
    assert np.abs(got.numpy() - ref).max() < MAX_ABS
    with pytest.raises(ValueError, match="hop"):
        convert.stream_state_from_jax(jstream.StreamState(mb=st))

