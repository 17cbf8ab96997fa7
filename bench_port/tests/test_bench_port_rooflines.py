"""The roofline counts at the 180 s shapes of PERF.md's kernel table
(one 180 s 44.1 kHz stereo track: 20 672 blocks of 384 samples a
channel, 992 256 control steps at hop 8), against sums done by hand:
bytes each input read once and each output written once (float32), the
recurrence's own arithmetic (10 operations a biquad section a sample)
and the pointwise stages."""

import pytest

from bench_port import peaks, registry, roofline

ROWS, L = 20672, 384
S = ROWS * L                # 7 938 048 samples a channel
STEPS = 992256              # S / 8, whole 128-step blocks
B = 3                       # bands of one track
OPERATOR = L * L            # a filter's 384 x 384 block operator

HAND = {
    # x, 8 states a row and channel, operator + state operator, y
    "k1_front_chain": (2 * S * (5 + 40 + 3),
                       4 * (2 * S + 2 * ROWS * 8 + OPERATOR + 8 * L + 2 * S)),
    # 4 sections, mid, 3 squares a channel sample; mean + buckets a frame
    "k2_band_energies": (2 * S * 45 + S * 9,
                         4 * (2 * S + 2 * 2 * ROWS * 4
                              + 2 * (OPERATOR + 4 * L) + 3 * S // 8)),
    # 4 sections + recombination a channel sample, the mono downmix
    "k3_band_gain_apply": (2 * S * 45 + 2 * S,
                           4 * (2 * S + 2 * 2 * ROWS * 4
                                + 2 * (OPERATOR + 4 * L) + 3 * S // 8
                                + 2 * S + S)),
    # 2 sections, square, bucket sum; buckets of 6 samples
    "k4_kweight_cells": (S * 22,
                         4 * (S + ROWS * 4 + OPERATOR + 4 * L + S // 6)),
    "k5_pass1": (4 * B * STEPS, 4 * (B * STEPS + 3 * B + B * STEPS // 128)),
    "k6_replay": (4 * B * STEPS,
                  4 * (B * STEPS + 2 * B + B * STEPS // 128 + B * STEPS)),
    "k7_replay_bnd": (4 * B * STEPS,
                      4 * (B * STEPS + 3 * B + B * STEPS // 128)),
}


def shape(multiband=True):
    cfg = registry.cell("worker_gpu_default.album12_mb").config
    return roofline.album_shape(cfg, 180 * 44100, 1, 2, multiband)


def test_shape():
    sh = shape()
    assert (sh["rows"], sh["samples"], sh["kweight_bucket"]) == (ROWS, S, 6)
    assert roofline.ballistics_steps(sh) == (B, STEPS)


@pytest.mark.parametrize("kernel", sorted(HAND))
def test_counts_by_hand(kernel):
    assert registry.roofline(kernel).count(shape()) == pytest.approx(
        HAND[kernel], rel=0, abs=0.5)


def test_front_chain_writes_mono_without_multiband():
    flops, n_bytes = registry.roofline("k1_front_chain").count(shape(False))
    assert flops == HAND["k1_front_chain"][0] + 2 * S
    assert n_bytes == HAND["k1_front_chain"][1] + 4 * S


def test_bounds_are_bytes_bound():
    for kernel in HAND:
        _, by = peaks.bound_seconds(*registry.roofline(kernel).count(shape()))
        assert by == "bytes", kernel
