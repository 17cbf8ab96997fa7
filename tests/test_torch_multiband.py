"""The port's multiband compressor (python_audio_mastering_tpu_torch.ops.
multiband and the band kernels' plain versions) against the JAX package,
on the same numpy-seeded inputs.

Budgets are the JAX package's own: the host float64 designs bit-equal;
the multi-filter states pass rtol 2e-5 (test_pallas_multiband.py:44); the
band kernels and the whole compressor rtol 5e-5 / atol 5e-6 (the JAX
kernels vs its XLA body, test_pallas_multiband.py:63), the JAX side
running its Pallas kernels in interpret mode; two chunks vs one shot atol
2e-4 (test_pallas_multiband.py:117).  The JAX references are built once
per module (interpret-mode Pallas is slow).

Where the float32 JAX result carries more roundoff than that budget, the
port is held to the exact result instead, at the same budget: the states
pass to scipy's float64 filter (the float32 JAX outputs are 1.5e-7 off
near zero crossings), and the detector, whose running sum the port takes
in float64, to the JAX function evaluated in float64 (``jax.enable_x64``):
at hop 1 the float32 JAX compressor is 8.2e-6 from its own float64 result
on these signals, the port 1.3e-7.
"""

import functools

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax
import jax.numpy as jnp

from python_audio_mastering_tpu.ops import biquad as jbq
from python_audio_mastering_tpu.ops import compressor as jcomp
from python_audio_mastering_tpu.ops import iir as jiir
from python_audio_mastering_tpu.ops import multiband as jmb
from python_audio_mastering_tpu.ops import pallas_multiband as jpmb
from python_audio_mastering_tpu_torch.ops import biquad, compressor, iir
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import multiband as mb

from .conftest import make_signal

FS = 44100
L = 384
NB = 45          # not a whole number of the CUDA kernels' tile groups
KW = dict(thresholds_db=(-25.0, -20.0, -15.0), ratios=(6.0, 3.0, 4.0))


def _rows(channels, nb=NB, seed=0):
    x = make_signal(nb * L, channels=channels, seed=seed) * 0.5
    return np.ascontiguousarray(x.T.reshape(channels, nb, L), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


@functools.cache
def _jax_states(channels):
    lp, hp = jmb._crossover_sos(FS, 250.0, 4000.0)
    (s_lp, s_hp), _ = jiir.sosfilt_states_multi_rows(
        (lp, hp), jnp.asarray(_rows(channels)))
    return np.asarray(s_lp), np.asarray(s_hp)


@functools.cache
def _jax_compress(channels, hop, chunks, x64=False):
    """JAX kernel-path compressor (interpret mode) over the test rows:
    one shot (in float64 with ``x64``), or the second half resumed from
    the first half's state.  Returns ``(y, state)`` as numpy."""
    xr = _rows(channels)
    common = dict(hop=hop, kernel="pallas_interpret", **KW)
    if chunks == 1:
        with jax.enable_x64(x64):
            y, st = jmb.multiband_compress_rows(
                jnp.asarray(xr.astype(np.float64) if x64 else xr), FS,
                return_state=True, **common)
            return np.asarray(y), _np(st)
    xr = jnp.asarray(xr)
    half = NB // 2
    _, st = jmb.multiband_compress_rows(xr[:, :half], FS, return_state=True,
                                        **common)
    y2 = jmb.multiband_compress_rows(xr[:, half:], FS, state=st, **common)
    return np.asarray(y2), _np(st)


@pytest.mark.parametrize("fs", [44100, 48000])
def test_crossover_design_matches_jax(fs):
    for args in [(4, 250.0, "lowpass"), (4, 4000.0, "highpass"),
                 (5, 1000.0, "lowpass"), (2, [200.0, 2000.0], "bandpass")]:
        np.testing.assert_array_equal(biquad.butter_sos(*args, fs=fs),
                                      jbq.butter_sos(*args, fs=fs))
    for a, b in zip(mb._crossover_sos(fs, 250.0, 4000.0),
                    jmb._crossover_sos(fs, 250.0, 4000.0)):
        np.testing.assert_array_equal(a, b)
    assert mb.BAND_BALLISTICS_MS == jmb.BAND_BALLISTICS_MS
    for hop in (1, 6, 8):
        assert mb.detector_lookpad(fs, hop) == jmb.detector_lookpad(fs, hop)
    for blk, hop in ((384, 8), (512, 6)):
        np.testing.assert_array_equal(mb._bucket_matrix(blk, hop),
                                      jmb._bucket_matrix(blk, hop))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_states_multi_rows_match_jax(channels, carried):
    """The shared-read states pass recomputes the filters' outputs
    (y = x @ T + s_in @ Wᵀ, float64) within rtol 2e-5 of scipy's float64
    filter, and its final states match scipy's and the JAX states pass's;
    with a carried ``zi`` (the JAX blocked filter's) too."""
    xrows = _rows(channels, nb=20, seed=3)
    sos = jmb._crossover_sos(FS, 250.0, 4000.0)
    zis = None
    if carried:  # the final states of a preceding stretch of signal
        _, zis = jiir.sosfilt_blocked_multi_rows(
            sos, jnp.asarray(_rows(channels, nb=8, seed=4)))
        zis = [np.asarray(z) for z in zis]
    _, zf_jax = jiir.sosfilt_states_multi_rows(
        sos, jnp.asarray(xrows),
        None if zis is None else [jnp.asarray(z, jnp.float32) for z in zis])
    s_ins, zfs = iir.sosfilt_states_multi_rows(
        sos, _t(xrows), None if zis is None else [_t(z) for z in zis])
    x64 = xrows.reshape(channels, -1).astype(np.float64)
    rows = x64.reshape(-1, L)
    for f, s in enumerate(sos):
        zi = (np.zeros((2, 2, channels)) if zis is None
              else zis[f].astype(np.float32).astype(np.float64))
        y_ref, zf_ref = sps.sosfilt(s, x64, axis=-1,
                                    zi=zi.transpose(0, 2, 1))
        t_mat, _, w, _ = iir._blocked_operators_static(s.tobytes(),
                                                       s.shape[0], L)
        s_in = s_ins[f].numpy().astype(np.float64).reshape(rows.shape[0], -1)
        y = (rows @ t_mat + s_in @ w.T).reshape(x64.shape)
        np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(zfs[f].numpy(),
                                   zf_ref.transpose(0, 2, 1), rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(zfs[f].numpy(), np.asarray(zf_jax[f]),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("hop", [1, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_band_energies_ref_matches_jax_kernel(channels, hop):
    xrows = _rows(channels)
    s_lp, s_hp = _jax_states(channels)
    lp, hp = jmb._crossover_sos(FS, 250.0, 4000.0)
    ref = np.asarray(jpmb.band_energies(
        jnp.asarray(xrows), jnp.asarray(s_lp), jnp.asarray(s_hp), lp, hp,
        hop=hop, interpret=True))
    got = cmb.band_energies(_t(xrows), _t(s_lp), _t(s_hp), lp, hp, hop=hop)
    assert got.shape == (3, NB * L // hop)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("hop", [1, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_band_gain_apply_ref_matches_jax_kernel(channels, hop):
    xrows = _rows(channels)
    s_lp, s_hp = _jax_states(channels)
    lp, hp = jmb._crossover_sos(FS, 250.0, 4000.0)
    r = np.random.default_rng(hop)
    g = (0.5 + 0.5 * r.random((3, NB * L // hop))).astype(np.float32)
    cols = np.stack([g[1], g[0] - g[1], g[2] - g[1]])
    ref_y, ref_m = jpmb.band_gain_apply(
        jnp.asarray(xrows), jnp.asarray(s_lp), jnp.asarray(s_hp),
        jnp.asarray(cols), lp, hp, hop=hop, emit_mono=True, interpret=True)
    y, mono = cmb.band_gain_apply(_t(xrows), _t(s_lp), _t(s_hp), _t(cols),
                                  lp, hp, hop=hop, emit_mono=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=5e-5,
                               atol=5e-6)
    np.testing.assert_allclose(mono.numpy(), np.asarray(ref_m), rtol=5e-5,
                               atol=5e-6)
    plain = cmb.band_gain_apply(_t(xrows), _t(s_lp), _t(s_hp), _t(cols),
                                lp, hp, hop=hop)
    assert torch.equal(plain, y)


def test_cumsum_matches_jax():
    """The two-stage running sum (float64 in the port) against the JAX
    float32 one, past the 2·512 single-stage cutoff."""
    x = np.random.default_rng(1).random((3, 5000)).astype(np.float32)
    ref = np.asarray(jcomp.cumsum_mxu(jnp.asarray(x), axis=1))
    got = compressor.cumsum_mxu(_t(x).double(), dim=1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.astype(np.float64),
                                                      axis=1), rtol=1e-12)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("hop", [1, 8])
def test_fused_stats_match_jax(hop, tail):
    """The detector (windowed means + gain computer, band-major) from the
    same bucketed energies, with and without a carried control tail,
    against the JAX function in float64 (the float32 JAX running sum is
    7.6e-5 dB off at hop 8 here, the port 1.8e-6)."""
    r = np.random.default_rng(hop)
    t = 6000 // hop
    xb = (r.random((3, t)) * 0.2 * hop).astype(np.float32)
    look_ctrl = jmb.detector_lookpad(FS, hop) // hop
    ctrl_tail = (r.random((3, look_ctrl)) * 0.2 * hop).astype(np.float32) \
        if tail else None
    with jax.enable_x64(True):
        ref, ref_tail = jmb._fused_stats_from_ctrl(
            jnp.asarray(xb, jnp.float64), t, FS, KW["thresholds_db"],
            KW["ratios"], hop, None if ctrl_tail is None
            else jnp.asarray(ctrl_tail, jnp.float64), look_ctrl,
            jnp.float64, band_major=True)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        ref_tail = np.asarray(ref_tail)
    got, got_tail = mb._fused_stats_from_ctrl(
        _t(xb), t, FS, KW["thresholds_db"], KW["ratios"], hop,
        None if ctrl_tail is None else _t(ctrl_tail), look_ctrl)
    for k in ("max_att", "inc", "dec"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=5e-5,
                                   atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(got["above"].numpy(), ref["above"])
    np.testing.assert_array_equal(got_tail.numpy(), ref_tail)


@pytest.mark.parametrize("hop", [1, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_multiband_compress_rows_matches_jax(channels, hop):
    """Hop 8 (the main path) against the float32 JAX compressor; hop 1,
    where the float32 JAX running sum over 17 280 steps drifts past the
    budget, against the JAX compressor in float64."""
    ref_y, ref_st = _jax_compress(channels, hop, 1, x64=hop == 1)
    y, mono, st = mb.multiband_compress_rows(
        _t(_rows(channels)), FS, hop=hop, return_state=True, emit_mono=True,
        **KW)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=5e-5, atol=5e-6)
    assert torch.equal(mono, y.mean(dim=0))
    np.testing.assert_allclose(st["att"].numpy(), ref_st["att"], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(st["ctrl_tail"].numpy(), ref_st["ctrl_tail"],
                               rtol=5e-5, atol=5e-6)
    for k in ("lp", "hp"):
        np.testing.assert_allclose(st["crossover"][k].numpy(),
                                   ref_st["crossover"][k], rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("channels", [1, 2])
def test_two_chunks_resume_a_jax_state(channels):
    """The second half resumed from the JAX first half's state equals the
    JAX resume; the port's own two chunks equal its one shot (atol 2e-4)."""
    from python_audio_mastering_tpu_torch import convert
    from python_audio_mastering_tpu.parallel.streaming import StreamState

    hop = 8
    ref_y2, jst = _jax_compress(channels, hop, 2)
    st = convert.stream_state_from_jax(StreamState(mb=jst)).mb
    xr = _t(_rows(channels))
    half = NB // 2
    y2 = mb.multiband_compress_rows(xr[:, half:], FS, hop=hop, state=st, **KW)
    np.testing.assert_allclose(y2.numpy(), ref_y2, rtol=5e-5, atol=5e-6)

    one = mb.multiband_compress_rows(xr, FS, hop=hop, **KW)
    y1, own = mb.multiband_compress_rows(xr[:, :half], FS, hop=hop,
                                         return_state=True, **KW)
    y2 = mb.multiband_compress_rows(xr[:, half:], FS, hop=hop, state=own,
                                    **KW)
    streamed = torch.cat([y1, y2], dim=1)
    assert (streamed - one).abs().max().item() < 2e-4


@pytest.mark.parametrize("ballistics", ["blocked", "scan"])
def test_approximate_ballistics_are_not_ported(ballistics):
    """The executions refused before the legacy slice now run: ``"scan"``
    is the exact serial mode, bitwise the default ``"auto"``; ``"blocked"``
    (a block-parallel approximation) is within 0.01 dB of it
    (tests/test_compressor.py:36-44), with blocks short enough that the
    rows have several and the JAX package's default overlap."""
    xr = _t(_rows(2, nb=12))
    exact = mb.multiband_compress_rows(xr, FS, hop=8, **KW)
    got = mb.multiband_compress_rows(xr, FS, hop=8, ballistics=ballistics,
                                     block_ctrl=128, **KW)
    if ballistics == "scan":
        assert torch.equal(got, exact)
    else:
        db = 20.0 * torch.log10(got.abs().clamp_min(1e-6)
                                / exact.abs().clamp_min(1e-6))
        assert db[exact.abs() > 1e-3].abs().max().item() < 0.01
