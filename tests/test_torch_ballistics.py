"""The port's exact ballistics (python_audio_mastering_tpu_torch.ops.
ballistics, plain versions of kernels K5-K7 and their driver) against the
JAX package's ``ballistics_pallas_rates_bt`` (Pallas in interpret mode)
and its ``attenuation_scan``, on the regimes of test_pallas.py.

Budgets: atol 2e-4 dB against both (test_pallas.py:50, 125).  Inside the
port the kernels share one op sequence, so the collapse mode, the serial
mode and the forced serial fallback (``iters=1``) agree bitwise, and
bitwise with the port's step-by-step ``attenuation_scan`` fed the same
products ``m·ca`` / ``m·cr``.  K5's segmented walk (the hull pass, then
the runs of non-collapsed blocks) equals the serial walk bitwise, on
those regimes and on timelines built against it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import compressor as jcomp
from python_audio_mastering_tpu.ops import pallas_kernels as jpk
from python_audio_mastering_tpu_torch.ops import ballistics as bal
from python_audio_mastering_tpu_torch.ops import compressor

CA = np.float32([8 / 220.5, 8 / 441.0, 8 / 882.0])
CR = np.float32([8 / 2205.0, 8 / 4410.0, 8 / 8820.0])
T0 = 128 * 128 * 2 + 999   # several JAX tiles, a ragged last block


@functools.cache
def _battery():
    """The collapse pipeline's regimes (test_pallas.py:_case_battery):
    collapsing active blocks, frozen silences, never-saturating wander,
    sparse blips, a random walk, and nonzero incoming states."""
    rng = np.random.default_rng(0)
    act = (rng.random(T0) < 0.5).astype(np.float32)
    tt = np.arange(T0, dtype=np.float32)
    blip = np.zeros((3, T0), np.float32)
    blip[:, ::3000] = 10.0
    walk = np.abs(np.cumsum(rng.standard_normal(T0)).astype(np.float32)) / 50
    return {
        "bursty": ((rng.random((3, T0)).astype(np.float32) * 12) * act,
                   np.float32([0, 0, 0])),
        "silence": (np.zeros((3, T0), np.float32), np.float32([3, 0, 1.5])),
        "sustained": (6.0 + rng.random((3, T0)).astype(np.float32),
                      np.float32([0, 2, 9])),
        "slow-wander": (
            ((5.0 + 4.0 * np.sin(2 * np.pi * tt / 50000.0))[None, :]
             * np.ones((3, 1), np.float32)).astype(np.float32),
            np.float32([20.0, 0.0, 5.0])),
        "blips": (blip, np.float32([1, 1, 1])),
        "randomwalk": (
            np.stack([walk + 0.5] * 3) * np.float32([1, 0.5, 2])[:, None],
            np.float32([8, 0, 0])),
    }


CASES = ["bursty", "silence", "sustained", "slow-wander", "blips",
         "randomwalk"]


@functools.cache
def _adversarial():
    """Timelines built against the segmented walk, with their own rates:
    ``(m, att0, ca, cr)``."""
    rng = np.random.default_rng(1)
    slow = np.float32([1e-4, 2e-4, 5e-5])
    bursty = (rng.random((3, T0)).astype(np.float32) * 12
              * (rng.random(T0) < 0.5))
    tail = np.full((3, T0), 10.0, np.float32)
    tail[:, T0 // 2:] = 0.1   # a slow release from 10 dB to the end
    return {
        # slow attack and release throughout: no block collapses
        "no-collapse": (6.0 + rng.random((3, T0)).astype(np.float32),
                        np.float32([0, 3, 9]), slow, slow),
        # every block frozen from a zero state: all collapse to 0
        "all-frozen": (np.zeros((3, T0), np.float32), np.float32([0, 0, 0]),
                       CA, CR),
        "att0-high": (bursty, np.float32([20, 5, 0.5]), CA, CR),
        "run-to-the-end": (tail, np.float32([0, 0, 0]), CA,
                           np.float32([1e-4, 1e-4, 1e-4])),
        "single-block": (bursty[:, :100], np.float32([1, 0, 2]), CA, CR),
    }


def _case(name):
    """``(m, att0, ca, cr)`` of a regime of CASES or ADVERSARIAL."""
    if name in CASES:
        return (*_battery()[name], CA, CR)
    return _adversarial()[name]


ADVERSARIAL = ["no-collapse", "all-frozen", "att0-high", "run-to-the-end",
               "single-block"]


def _scan_stats(m, ca, cr):
    """``attenuation_scan`` stats ``(T, B)`` with the rates folded in."""
    return {"max_att": m.T, "above": m.T > 0, "inc": (m * ca[:, None]).T,
            "dec": (m * cr[:, None]).T}


@functools.cache
def _port(name, mode, iters=bal.FIXPOINT_ITERS):
    m, att0, ca, cr = _case(name)
    return bal.ballistics_rates_bt(torch.from_numpy(m), ca, cr,
                                   torch.from_numpy(att0), mode=mode,
                                   iters=iters)


@pytest.mark.parametrize("name", CASES + ADVERSARIAL)
def test_driver_matches_jax_kernel_and_scan(name):
    m, att0, ca, cr = _case(name)
    ref, ref_f = jpk.ballistics_pallas_rates_bt(
        jnp.asarray(m), jnp.asarray(ca), jnp.asarray(cr), jnp.asarray(att0),
        interpret=True, mode="collapse")
    scan, scan_f = jcomp.attenuation_scan(
        {k: jnp.asarray(v) for k, v in _scan_stats(m, ca, cr).items()},
        jnp.asarray(att0))
    att, fin = _port(name, "collapse")
    assert att.shape == m.shape and att.dtype == torch.float32
    for r, rf in ((np.asarray(ref), np.asarray(ref_f)),
                  (np.asarray(scan).T, np.asarray(scan_f))):
        np.testing.assert_allclose(att.numpy(), r, rtol=0, atol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(fin.numpy(), rf, rtol=0, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("name", CASES + ADVERSARIAL)
def test_collapse_serial_and_fallback_are_bitwise_equal(name):
    m, att0, ca, cr = _case(name)
    att, fin = _port(name, "collapse")
    for other in (_port(name, "serial"), _port(name, "collapse", 1)):
        assert torch.equal(other[0], att), name
        assert torch.equal(other[1], fin), name
    stats = {k: torch.from_numpy(v)
             for k, v in _scan_stats(m, ca, cr).items()}
    scan, scan_f = compressor.attenuation_scan(stats, torch.from_numpy(att0))
    assert torch.equal(scan.T, att), name
    assert torch.equal(scan_f, fin), name


def test_port_scan_matches_jax_scan():
    """The port's oracle is the JAX one, step for step."""
    m, att0 = _battery()["bursty"]
    m = m[:, :4000]
    stats = _scan_stats(m, CA, CR)
    ref, ref_f = jcomp.attenuation_scan(
        {k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(att0))
    got, got_f = compressor.attenuation_scan(
        {k: torch.from_numpy(v) for k, v in stats.items()},
        torch.from_numpy(att0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))


def _padded(name):
    m, att0, ca, cr = _case(name)
    t = -(-m.shape[1] // bal.BLOCK) * bal.BLOCK
    return (torch.nn.functional.pad(torch.from_numpy(m), (0, t - m.shape[1])),
            torch.from_numpy(ca), torch.from_numpy(cr),
            torch.from_numpy(att0))


@pytest.mark.parametrize("name", CASES + ADVERSARIAL)
def test_segmented_walk_equals_the_serial_walk(name):
    """K5's plain twin (hull pass, then the runs walked together) against
    the serial walk ``pass1_bnd_ref``, bitwise; the adversarial regimes
    are checked to be what they claim."""
    m, ca, cr, att0 = _padded(name)
    hmax = torch.maximum(att0, m.amax(dim=1))
    lo, hi = bal.pass1_hull(m, ca, cr, hmax)
    assert torch.equal(bal.pass1_bnd(m, ca, cr, att0),
                       bal.pass1_bnd_ref(m, ca, cr, att0)), name
    collapsed, runs, longest = zip(*bal.hull_runs(lo, hi))
    nblk = lo.shape[1]
    if name == "no-collapse":
        assert collapsed == (0, 0, 0) and longest == (nblk,) * 3
    elif name == "all-frozen":
        assert collapsed == (nblk,) * 3 and runs == (0, 0, 0)
    elif name == "run-to-the-end":
        assert all(lo[:, -1] != hi[:, -1]) and all(c > 0 for c in collapsed)
    elif name == "single-block":
        assert nblk == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hull_pass_is_sound(seed):
    """Every incoming state in [0, H] (its ends included), replayed through
    a block, lands inside the block's hull; through a collapsed block, on
    its constant bit for bit."""
    rng = np.random.default_rng(seed)
    nblk = 24
    act = rng.random((3, nblk * bal.BLOCK)) < (0.3 + 0.3 * seed)
    m = torch.from_numpy(
        (rng.random((3, nblk * bal.BLOCK)) * 12 * act).astype(np.float32))
    ca = torch.from_numpy(rng.uniform(1e-3, 0.5, 3).astype(np.float32))
    cr = torch.from_numpy(rng.uniform(1e-4, 0.05, 3).astype(np.float32))
    hmax = m.amax(dim=1) + 1.0
    lo, hi = bal.pass1_hull_ref(m, ca, cr, hmax)
    assert bool((lo <= hi).all())
    collapsed = lo == hi
    for trial in range(48):
        u = torch.from_numpy(rng.random((3, nblk)).astype(np.float32))
        incomes = ({0: torch.zeros_like(u), 1: hmax[:, None].expand_as(u)}
                   .get(trial, u * hmax[:, None])).contiguous()
        out = bal.replay_ref(m, ca, cr, incomes)[:, bal.BLOCK - 1::bal.BLOCK]
        assert bool(((lo <= out) & (out <= hi)).all()), trial
        assert torch.equal(out[collapsed], lo[collapsed]), trial


def test_fixed_point_certifies_or_falls_back():
    """Sustained material certifies within the round cap (bursty noise
    stalls after the grace rounds and takes the walk); with the cap at 1
    a slowly converging timeline does not certify either."""
    args = _padded("sustained")
    _, ctrl = bal._run_collapse(*args)
    assert int(ctrl[bal.CNT]) == 0 and int(ctrl[bal.ACTIVE]) == 0
    assert 1 <= int(ctrl[bal.ROUND]) <= bal.FIXPOINT_ITERS
    args = _padded("randomwalk")
    out, ctrl = bal._run_collapse(*args, iters=1)
    assert int(ctrl[bal.ROUND]) == 1 and int(ctrl[bal.CNT]) != 0
    assert torch.equal(out, bal._run(*args))


def test_a_stopped_round_carries_its_input_through():
    m, ca, cr, att0 = _padded("sustained")
    nblk = m.shape[1] // bal.BLOCK
    s = torch.rand((3, nblk))
    idx = bal._frozen_index(m)
    ctrl = bal.new_ctrl("cpu")
    ctrl[bal.ACTIVE] = 0
    before = ctrl.clone()
    assert torch.equal(bal.replay_bnd(m, ca, cr, att0, idx, s, ctrl), s)
    assert torch.equal(ctrl, before)
    # a certified fixed point leaves the serial walk out
    ctrl[bal.CNT] = 0
    assert torch.equal(bal.pass1_bnd(m, ca, cr, att0, ctrl),
                       torch.zeros((3, nblk)))


def test_frozen_blocks_are_read_through():
    """A block's income index skips every all-zero block before it."""
    m = torch.zeros((2, 6 * bal.BLOCK))
    m[0, 1 * bal.BLOCK + 5] = 1.0      # block 1 active
    m[0, 4 * bal.BLOCK] = 2.0          # block 4 active
    m[1, 0] = 1.0                      # block 0 active
    idx = bal._frozen_index(m)
    assert idx.tolist() == [[0, 0, 2, 2, 2, 5], [0, 1, 1, 1, 1, 1]]


def test_single_band_nonzero_att0_and_ragged_length():
    rng = np.random.default_rng(3)
    m = np.abs(rng.standard_normal((1, 5 * 128 + 37))).astype(np.float32)
    ca, cr, att0 = (np.float32([0.01]), np.float32([0.001]),
                    np.float32([3.0]))
    att, fin = bal.ballistics_rates_bt(torch.from_numpy(m), ca, cr, att0)
    scan, scan_f = jcomp.attenuation_scan(
        {k: jnp.asarray(v) for k, v in _scan_stats(m, ca, cr).items()},
        jnp.asarray(att0))
    np.testing.assert_allclose(att.numpy(), np.asarray(scan).T, rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(fin.numpy(), np.asarray(scan_f), rtol=0,
                               atol=2e-4)
    with pytest.raises(ValueError, match="mode"):
        bal.ballistics_rates_bt(torch.from_numpy(m), ca, cr, mode="scan")


@pytest.mark.parametrize("rounds", [3, bal.FIXPOINT_ITERS])
@pytest.mark.parametrize("name", CASES + ADVERSARIAL)
def test_rounds_equal_one_round_calls(name, rounds):
    """``replay_bnd_ref(..., rounds=k)`` (K7's plain twin, and the wrapper
    on the CPU) equals k one-round calls in a row, states and ``ctrl``
    bitwise, whether the loop runs all k rounds or stops before."""
    m, ca, cr, att0 = _padded(name)
    idx = bal._frozen_index(m)
    s0 = torch.zeros((m.shape[0], m.shape[1] // bal.BLOCK))
    ctrls = [bal.new_ctrl("cpu") for _ in range(3)]
    got = bal.replay_bnd_ref(m, ca, cr, att0, idx, s0, ctrls[0],
                             rounds=rounds)
    wrapped = bal.replay_bnd(m, ca, cr, att0, idx, s0, ctrls[1],
                             rounds=rounds)
    s = s0
    for _ in range(rounds):
        s = bal.replay_bnd_ref(m, ca, cr, att0, idx, s, ctrls[2])
    assert torch.equal(got, s) and torch.equal(wrapped, s), name
    assert torch.equal(ctrls[0], ctrls[2]), name
    assert torch.equal(ctrls[1], ctrls[2]), name
    assert 1 <= int(ctrls[0][bal.ROUND]) <= rounds
    assert int(ctrls[0][bal.CHANGED_EVEN]) == 0
    assert int(ctrls[0][bal.CHANGED_ODD]) == 0


def test_rounds_stop_where_the_loop_stops():
    """A loop that stops before the rounds asked for: sustained material
    certifies, and the rounds after it carry the states through."""
    m, ca, cr, att0 = _padded("sustained")
    idx = bal._frozen_index(m)
    s0 = torch.zeros((3, m.shape[1] // bal.BLOCK))
    ctrl = bal.new_ctrl("cpu")
    s = bal.replay_bnd_ref(m, ca, cr, att0, idx, s0, ctrl,
                           rounds=bal.FIXPOINT_ITERS)
    ran = int(ctrl[bal.ROUND])
    assert ran < bal.FIXPOINT_ITERS and int(ctrl[bal.ACTIVE]) == 0
    assert int(ctrl[bal.CNT]) == 0
    ctrl2 = bal.new_ctrl("cpu")
    assert torch.equal(bal.replay_bnd_ref(m, ca, cr, att0, idx, s0, ctrl2,
                                          rounds=ran), s)
    assert torch.equal(ctrl2, ctrl)


@pytest.mark.parametrize("counter", [bal.CHANGED_EVEN, bal.CHANGED_ODD])
def test_rounds_refuse_a_ctrl_with_counters_set(counter):
    """K7 reads its counters as 0 on entry (other CTAs add to them before
    the first grid barrier); the plain twin refuses a ``ctrl`` that breaks
    this, and leaves it as it was."""
    m, ca, cr, att0 = _padded("sustained")
    idx = bal._frozen_index(m)
    s0 = torch.zeros((3, m.shape[1] // bal.BLOCK))
    ctrl = bal.new_ctrl("cpu")
    ctrl[counter] = 7
    kept = ctrl.clone()
    with pytest.raises(ValueError, match="counters must be 0"):
        bal.replay_bnd(m, ca, cr, att0, idx, s0, ctrl, rounds=3)
    assert torch.equal(ctrl, kept)
