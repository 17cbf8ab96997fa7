"""The port's compressor executions against the JAX package's: the
detector (``detector_stats``/``detector_stats_bands``), the exact
ballistics (``"scan"``), the coarse pre-scan and the block-parallel
``"blocked"`` ballistics, here on the kernels' plain twins, and the
multiband dispatch of every ``comp_ballistics``.

Limits: the detector's stats against JAX in float64 (the port takes its
running sum in float64) rtol 1e-5; the ballistics against JAX's, atol
2e-4 dB (test_pallas.py:32: the kernels step ``att + m·ca`` where the
JAX scan steps ``att + m/frames·hop``, an ulp apart); ``"blocked"``
against exact < 0.01 dB on the gain (tests/test_compressor.py:36-44);
``"scan"`` bitwise ``"auto"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_audio_mastering_tpu.ops import compressor as jcomp
from python_audio_mastering_tpu.ops import multiband as jmb
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch import master
from python_audio_mastering_tpu_torch.ops import compressor as comp
from python_audio_mastering_tpu_torch.ops import multiband as mb

from .conftest import make_signal

FS = 44100
ATOL = 2e-4
BANDS = dict(thresholds_db=(-25.0, -20.0, -15.0), ratios=(6.0, 3.0, 4.0),
             attacks_ms=(10.0, 5.0, 1.0), releases_ms=(200.0, 150.0, 50.0))


def _x(seconds=1.0, seed=0, gain=0.8):
    return (make_signal(int(seconds * FS), seed=seed) * gain).astype(
        np.float32)


def _bands(x):
    return np.stack([x * 0.9, np.roll(x, 100, axis=0) * 0.6, x * 0.3])


def _stats(x, hop):
    """The 3-band stats of both packages on the same bands: ``(port
    (T, 3) dict, JAX float32 (T, 3) dict)``."""
    b = _bands(x)
    got = comp.detector_stats_bands(torch.from_numpy(b), FS, hop=hop,
                                    **BANDS)
    ref = jcomp.detector_stats_bands(jnp.asarray(b), FS, hop=hop, **BANDS)
    return got, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("hop", [1, 8])
def test_detector_stats_bands_matches_jax(hop):
    b = _bands(_x(0.5))
    got = comp.detector_stats_bands(torch.from_numpy(b), FS, hop=hop,
                                    **BANDS)
    with jax.enable_x64(True):
        ref = jcomp.detector_stats_bands(jnp.asarray(b, jnp.float64), FS,
                                         hop=hop, **BANDS)
        one = jcomp.detector_stats(jnp.asarray(b[1], jnp.float64), FS,
                                   -20.0, 3.0, 5.0, 150.0, hop=hop)
    for k in ("max_att", "inc", "dec"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)
    agree = (got["above"].numpy() == np.asarray(ref["above"])).mean()
    assert agree > 0.999       # threshold flips at float32 roundoff only
    single = comp.detector_stats(torch.from_numpy(b[1]), FS, -20.0, 3.0,
                                 5.0, 150.0, hop=hop)
    np.testing.assert_allclose(single["max_att"].numpy(),
                               np.asarray(one["max_att"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["ca"].numpy(),
                               [hop / (a * FS / 1000.0) for a in
                                BANDS["attacks_ms"]], rtol=1e-7)


@pytest.mark.parametrize("hop", [1, 8])
def test_scan_coarse_and_blocked_match_jax(hop):
    """On the same stats (JAX's float32 ones, with the port's rate
    factors): the exact ballistics against ``attenuation_scan``, the
    coarse pre-scan against ``attenuation_coarse``, the blocked ballistics
    against ``attenuation_blocked`` (blocks short enough for several a
    band, the JAX default overlap), all from a nonzero incoming state."""
    x = _x(1.0, seed=2)
    got_st, ref_st = _stats(x, hop)
    st = {k: torch.from_numpy(np.array(v)) for k, v in ref_st.items()}
    st["ca"], st["cr"] = got_st["ca"], got_st["cr"]
    att0 = np.array([0.5, 0.0, 1.5], np.float32)
    jst = {k: jnp.asarray(v) for k, v in ref_st.items()}

    att, fin = comp.attenuation_exact(st, torch.from_numpy(att0))
    ref, ref_fin = jcomp.attenuation_scan(jst, jnp.asarray(att0))
    np.testing.assert_allclose(att.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(fin.numpy(), np.asarray(ref_fin), atol=ATOL,
                               rtol=0)
    oracle, _ = comp.attenuation_scan(st, torch.from_numpy(att0))
    np.testing.assert_allclose(att.numpy(), oracle.numpy(), atol=ATOL,
                               rtol=0)

    coarse, _ = comp.attenuation_coarse(st, 64, torch.from_numpy(att0))
    ref, _ = jcomp.attenuation_coarse(jst, 64, jnp.asarray(att0))
    np.testing.assert_allclose(coarse.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)

    block = 4096 // hop
    overlap = jcomp._default_overlap(FS, 200.0, hop)
    assert comp._default_overlap(FS, 200.0, hop) == overlap
    blk, blk_fin = comp.attenuation_blocked(st, block, overlap // 4,
                                            torch.from_numpy(att0))
    ref, ref_fin = jcomp.attenuation_blocked(jst, block, overlap // 4,
                                             jnp.asarray(att0))
    np.testing.assert_allclose(blk.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(blk_fin.numpy(), np.asarray(ref_fin),
                               atol=ATOL, rtol=0)


def test_blocked_compressor_within_001_db_of_exact():
    """tests/test_compressor.py:36-44 on the port: ``compress_dynamic_
    range`` with 2048-step blocks within 0.01 dB of the exact one, which
    matches JAX's exact one."""
    x = _x(2.0)
    exact = comp.compress_dynamic_range(torch.from_numpy(x), FS,
                                        threshold=-22.0).numpy()
    blk = comp.compress_dynamic_range(torch.from_numpy(x), FS,
                                      threshold=-22.0,
                                      block_ctrl=2048).numpy()
    err_db = 20 * np.log10(np.maximum(np.abs(blk), 1e-12)
                           / np.maximum(np.abs(exact), 1e-12))
    assert np.max(np.abs(err_db)) < 0.01
    ref = np.asarray(jcomp.compress_dynamic_range(jnp.asarray(x), FS,
                                                  threshold=-22.0))
    assert np.abs(exact - ref).max() < 1e-4


@pytest.mark.parametrize("ballistics", ["scan", "blocked"])
@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_multiband_compress_matches_jax(variant, ballistics):
    """The ``(N, C)`` ``multiband_compress`` of both splits against the
    JAX package's (its general path for the legacy split, its fused one
    for the worker's), hop 8, 1024-step blocks for ``"blocked"``: < 2e-4
    max abs (test_pallas_multiband.py:269)."""
    x = _x(1.0, seed=4, gain=0.6)
    kw = dict(thresholds_db=(-25.0, -20.0, -15.0), ratios=(6.0, 3.0, 4.0),
              variant=variant, hop=8, ballistics=ballistics,
              block_ctrl=1024 if ballistics == "blocked" else None)
    ref = np.asarray(jmb.multiband_compress(jnp.asarray(x), FS,
                                            filter_method="blocked", **kw))
    got = mb.multiband_compress(torch.from_numpy(x), FS, **kw).numpy()
    assert np.abs(got - ref).max() < 2e-4


@pytest.mark.parametrize("variant", ["worker", "legacy"])
def test_every_ballistics_mode_in_the_chain(variant):
    """``comp_ballistics`` takes ``"auto"``, ``"pallas"``, ``"scan"`` and
    ``"blocked"`` for both variants: the three exact ones bitwise equal,
    ``"blocked"`` (the chain's 2048-step blocks) within 2e-4 of them, and
    anything else a ``ValueError``."""
    x = _x(1.5, seed=6, gain=0.5)
    params = MasteringParams.from_settings(
        {"saturation": 20, "preset": "techno", "width": 1.3, "lufs": -14.0,
         "multiband": True})
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS), variant=variant)
    out = {b: master(x, params, dataclasses.replace(cfg, comp_ballistics=b),
                     device="cpu")
           for b in mb.BALLISTICS}
    assert torch.equal(out["auto"], out["pallas"])
    assert torch.equal(out["auto"], out["scan"])
    assert (out["blocked"] - out["auto"]).abs().max().item() < 2e-4
    with pytest.raises(ValueError, match="unknown comp_ballistics"):
        master(x, params, dataclasses.replace(cfg, comp_ballistics="exact"),
               device="cpu")
