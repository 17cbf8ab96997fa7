"""The port's lookahead true-peak limiter (``ops.limiter``) against the JAX
package's, on the same numpy-seeded inputs, float64 on both sides: rtol
1e-9, atol 1e-10, the JAX limiter's own budgets (test_limiter.py:51,
test_streaming.py:117).  The port's float32 limiter is held to JAX in
float64 (the JAX float32 attack sum drifts, see
``test_float32_limiter_stays_under_the_ceiling``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from python_audio_mastering_tpu.ops import limiter as jlim
from python_audio_mastering_tpu_torch.convert import limiter_state_from_jax
from python_audio_mastering_tpu_torch.ops import limiter as lim

from .conftest import make_signal

FS = 44100
CEILING = 10.0 ** (-1.0 / 20.0)
TOL = {"rtol": 1e-9, "atol": 1e-10}
# the JAX chunk step, compiled once per chunk shape
_jax_chunk = jax.jit(jlim.lookahead_limiter_chunk, static_argnums=(2,),
                     static_argnames=("flush", "true_peak"))


def _hot(seconds, fs=FS, channels=2, seed=0, drive=1.6):
    return make_signal(int(fs * seconds), channels=channels, fs=fs,
                       seed=seed) * drive


@pytest.mark.parametrize("window", [1, 2, 7, 133])
def test_windowed_min_forward_matches_jax(window):
    g = np.random.default_rng(window).random(3001)
    got = lim._windowed_min_forward(torch.from_numpy(g), window)
    ref = jlim._windowed_min_forward(jnp.asarray(g), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("g0", [None, 0.3])
def test_release_scan_matches_jax_and_the_loop(g0):
    """The log-domain prefix max against JAX's associative scan and the
    per-sample loop, over more than one row of the prefix max."""
    r = np.random.default_rng(0)
    target = np.minimum(1.0, 0.2 + r.random(5000))
    rho = np.exp(-1.0 / 800.0)
    got = lim._release_scan(torch.from_numpy(target), rho,
                            g0=None if g0 is None
                            else torch.tensor(g0, dtype=torch.float64))
    ref = jlim._release_scan(jnp.asarray(target), rho,
                             g0=None if g0 is None else jnp.asarray(g0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    g = 1.0 if g0 is None else g0
    loop = np.empty_like(target)
    for i in range(target.shape[0]):
        g = min(target[i], 1.0 - (1.0 - g) * rho)
        loop[i] = g
    np.testing.assert_allclose(got.numpy(), loop, **TOL)


@pytest.mark.parametrize("true_peak", [False, True])
def test_peak_env_matches_jax(true_peak):
    x = _hot(0.5, seed=1)
    got = lim._peak_env(torch.from_numpy(x), true_peak)
    ref = jlim._peak_env(jnp.asarray(x), true_peak)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_attack_gain_matches_jax():
    x = _hot(0.5, seed=2)
    raw = np.minimum(1.0, CEILING / np.maximum(np.abs(x).max(axis=1), 1e-9))
    got = lim._attack_gain(torch.from_numpy(raw), 66)
    ref = jlim._attack_gain(jnp.asarray(raw), 66)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fs", [44100, 48000])
@pytest.mark.parametrize("channels", [1, 2])
def test_lookahead_limiter_matches_jax(fs, channels):
    x = _hot(1.0, fs=fs, channels=channels, seed=channels)
    if channels == 1:
        x = x[:, 0]
    got = lim.lookahead_limiter(torch.from_numpy(x), fs)
    ref = jax.jit(lambda v: jlim.lookahead_limiter(v, fs))(x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.abs(got.numpy()).max() <= CEILING * (1 + 1e-9)


def _chunked(step, x, state, lengths, fs):
    out, start = [], 0
    for m in lengths:
        y, state = step(x[start:start + m], state, fs)
        out.append(np.asarray(y))
        start += m
    y, _ = step(None, state, fs, flush=True)
    return np.concatenate(out + [np.asarray(y)])


@pytest.mark.parametrize("true_peak", [False, True])
def test_lookahead_limiter_chunk_matches_one_shot_and_jax(true_peak):
    """Ragged chunks (one shorter than the pending depth, which emits
    nothing) concatenate to the one-shot limiter, and to JAX's chunked
    run."""
    x = _hot(1.0, seed=4)
    lengths = [5000, 100, 20000, 1, 9000, x.shape[0] - 34101]
    got = _chunked(
        lambda c, s, fs, flush=False: lim.lookahead_limiter_chunk(
            None if c is None else torch.from_numpy(c), s, fs,
            true_peak=true_peak, flush=flush),
        x, lim.lookahead_limiter_init(2, torch.float64), lengths, FS)
    one = lim.lookahead_limiter(torch.from_numpy(x), FS, true_peak=true_peak)
    ref = _chunked(
        lambda c, s, fs, flush=False: _jax_chunk(
            None if c is None else jnp.asarray(c), s, fs,
            true_peak=true_peak, flush=flush),
        x, jlim.lookahead_limiter_init(2, jnp.float64), lengths, FS)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, one.numpy(), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_limiter_state_from_jax_round_trip():
    """A quality stream begun in JAX goes on in the port: the emissions
    join to the one-shot limiter."""
    x = _hot(0.6, seed=5)
    state = jlim.lookahead_limiter_init(2, jnp.float64)
    head, state = _jax_chunk(jnp.asarray(x[:11000]), state, FS)
    pstate = limiter_state_from_jax(state)
    assert pstate.pend == state.pend and pstate.buf.dtype == torch.float64
    np.testing.assert_array_equal(pstate.buf.numpy(), np.asarray(state.buf))
    mid, pstate = lim.lookahead_limiter_chunk(torch.from_numpy(x[11000:]),
                                              pstate, FS)
    tail, _ = lim.lookahead_limiter_chunk(None, pstate, FS, flush=True)
    got = np.concatenate([np.asarray(head), mid.numpy(), tail.numpy()])
    one = lim.lookahead_limiter(torch.from_numpy(x), FS)
    np.testing.assert_allclose(got, one.numpy(), **TOL)


def test_float32_limiter_stays_under_the_ceiling():
    """The port's float32 limiter on a 30 s hot mix against JAX in float64:
    max abs <= 5e-5, sample peak <= ceiling x (1 + 1e-6).  The JAX float32
    limiter drifts from its float64 result here, through its float32
    running sum of the attack's moving average: printed, not asserted."""
    x = make_signal(30 * FS, fs=FS, seed=0) * 2.0
    run = jax.jit(lambda v: jlim.lookahead_limiter(v, FS))
    ref = np.asarray(run(x))
    got = lim.lookahead_limiter(torch.from_numpy(x.astype(np.float32)), FS)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max()
    peak = np.abs(got.numpy()).max()
    j32 = np.asarray(run(x.astype(np.float32)))
    print(f"float32 port vs float64 JAX: max abs {err:.3e}, peak "
          f"{peak:.8f} (ceiling {CEILING:.8f}); float32 JAX: max abs "
          f"{np.abs(j32 - ref).max():.3e}, peak {np.abs(j32).max():.8f}")
    assert err <= 5e-5
    assert peak <= CEILING * (1 + 1e-6)
