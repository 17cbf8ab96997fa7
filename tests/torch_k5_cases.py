"""Target timelines shaped like what K5's run walk meets, for the CPU
tests (``test_torch_ballistics.py``) and the card tests
(``test_torch_kernels.py``, which imports no jax): numpy only.

Each case is ``(m (3, T) float32, att0 (3,), ca (3,), cr (3,))`` with T a
multiple of 128, built from a seed:

* ``sparse-live``: the legacy chain's mid band in small.  Almost every
  block is frozen (m = 0 throughout); live blocks, each with a few
  nonzero targets, stand one or two at a time between frozen stretches;
  a frozen head with ``att0 > 0``, a frozen tail, and one frozen stretch
  longer than :data:`WINDOW`, the blocks the kernel's walker searches at
  once.  With so few targets no block collapses: each band is one run.
* ``all-frozen-att0``: every block frozen, ``att0 > 0`` in two bands
  (one run each, the state carried to the end) and 0 in the third (every
  block collapses to 0).
* ``long-live-run``: sustained targets under slow rates: no block
  collapses or freezes, one run of 96 live blocks a band (longer than 64
  blocks, and across three stop words).
"""

import numpy as np

BLOCK = 128
WINDOW = 1024           # blocks of the 32 stop words a walker reads at once
CASES = ("sparse-live", "all-frozen-att0", "long-live-run")
CA = np.float32([8 / 220.5, 8 / 441.0, 8 / 882.0])
CR = np.float32([8 / 2205.0, 8 / 4410.0, 8 / 8820.0])


def _sparse_live(rng):
    nblk = 1200
    m = np.zeros((3, nblk * BLOCK), np.float32)
    # live blocks after a 40-block frozen head, one or two at a time,
    # then a frozen stretch of 1030 blocks, three more, a frozen tail
    live = [40, 47, 48, 59, 71, 72, 88, 101, 117, 118, 120,
            1151, 1160, 1161, 1175]
    for band in range(3):
        for k in live:
            at = k * BLOCK + rng.choice(BLOCK, size=rng.integers(1, 7),
                                        replace=False)
            m[band, at] = rng.uniform(0.5, 6.0, at.size).astype(np.float32)
    return m, np.float32([4.0, 2.5, 9.0]), CA, CR


def _all_frozen_att0(rng):
    return (np.zeros((3, 40 * BLOCK), np.float32), np.float32([3.0, 0.0, 7.5]),
            CA, CR)


def _long_live_run(rng):
    slow = np.float32([1e-4, 2e-4, 5e-5])
    m = (6.0 + rng.random((3, 96 * BLOCK))).astype(np.float32)
    return m, np.float32([0.0, 3.0, 9.0]), slow, slow


def case(name):
    """``(m, att0, ca, cr)`` of the case ``name`` (see the module note)."""
    build = {"sparse-live": _sparse_live, "all-frozen-att0": _all_frozen_att0,
             "long-live-run": _long_live_run}[name]
    return build(np.random.default_rng(CASES.index(name) + 20))


def longest_frozen_stretch(m):
    """The most consecutive frozen blocks of any band of ``m``."""
    frozen = ~(m.reshape(m.shape[0], -1, BLOCK) != 0).any(axis=2)
    best = 0
    for row in frozen:
        cur = 0
        for f in row:
            cur = cur + 1 if f else 0
            best = max(best, cur)
    return best
