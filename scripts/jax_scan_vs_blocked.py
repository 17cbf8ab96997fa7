"""How far the JAX package's own exact (scan) and blocked filter paths
lie apart on the legacy multiband chain: the reference reading behind
``chip_smoke.py`` phase 41's limit for the port's scan chain against its
blocked chain on the card.

    JAX_PLATFORMS=cpu python scripts/jax_scan_vs_blocked.py [seconds]

Masters the first ``seconds`` (default 120) of ``chip_smoke.py``'s seeded
180 s 44.1 kHz stereo track (phase 41's) with the bench settings and multiband on, under
``ChainConfig.tpu_default`` with ``variant="legacy"`` and
``comp_ballistics="scan"``, once with ``filter_method="scan"`` and once
with ``"blocked"``, and prints the max abs and rms difference of the two
outputs and the measured loudness of each.
"""

import dataclasses
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (the track and settings)
from python_audio_mastering_tpu import ChainConfig, MasteringParams  # noqa
from python_audio_mastering_tpu import master  # noqa: E402


def main(seconds=120):
    x = cs.make_signal(cs.SECONDS * cs.FS, cs.FS, 0)[: seconds * cs.FS]
    params = MasteringParams.from_settings(cs.MB_SETTINGS)
    out = {}
    for method in ("scan", "blocked"):
        cfg = dataclasses.replace(ChainConfig.tpu_default(cs.FS),
                                  variant="legacy", filter_method=method,
                                  comp_ballistics="scan")
        t0 = time.perf_counter()
        res = jax.jit(lambda a, p, c=cfg: master(a, p, c,
                                                 return_result=True))(
            x, params)
        out[method] = np.asarray(res.audio)
        print(f"{method}: measured {float(res.measured_lufs):.6f} LUFS "
              f"({time.perf_counter() - t0:.1f} s)")
    d = np.abs(out["scan"] - out["blocked"])
    i = np.unravel_index(d.argmax(), d.shape)
    print(f"JAX legacy multiband, scan vs blocked, {seconds} s: max abs "
          f"{d.max():.4e} at sample {i[0]} ({i[0] / cs.FS:.2f} s), rms "
          f"{np.sqrt(np.mean(d ** 2)):.4e}, samples over 1e-5 "
          f"{int((d > 1e-5).sum())}")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
