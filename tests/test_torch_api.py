"""The port's public names against the JAX package's: the entry points'
signatures, ``master(valid_frames=)``, ``make_master_fn``, the config
helpers, ``BlockEnergyAccumulator``, the RBJ designs, the gain computer
and fused detector, ``ChainConfig.gpu_fast``, ``__version__`` and the
packages' re-exports, each on the same seeded inputs as its JAX twin.

Limits: the chain in float32, 2e-4 max abs and 1e-3 LU (the JAX
kernels-vs-XLA chain budget, test_pallas_multiband.py:269); float64
designs and detector statistics, rtol 1e-9 (measured ~1e-15); loudness
in float64, 1e-9 LU.
"""

import ast
import dataclasses
import inspect
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import python_audio_mastering_tpu as jpkg
from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu import config as jconfig
from python_audio_mastering_tpu.ops import biquad as jbiquad
from python_audio_mastering_tpu.ops import compressor as jcomp
from python_audio_mastering_tpu.ops import loudness as jloud
from python_audio_mastering_tpu.ops import multiband as jmb
from python_audio_mastering_tpu.parallel import batch as jbatch
import python_audio_mastering_tpu_torch as pkg
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch import config, convert
from python_audio_mastering_tpu_torch.models import chain
from python_audio_mastering_tpu_torch.ops import biquad, compressor
from python_audio_mastering_tpu_torch.ops import loudness
from python_audio_mastering_tpu_torch.ops import multiband as mb
from python_audio_mastering_tpu_torch.parallel import batch

from .conftest import make_signal

FS = 44100
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX re-exports the port leaves out: none
NOT_PORTED = set()
SUBPACKAGES = ("", ".ops", ".parallel", ".serving", ".io", ".models")


def _signal(seconds, seed=0, scale=0.5):
    return (make_signal(int(FS * seconds), fs=FS, seed=seed) * scale).astype(
        np.float32)


@pytest.mark.parametrize("name", ["master_album", "master_album_streamed"])
def test_album_entry_points_take_jax_parameter_order(name):
    """The port's parameters are JAX's, in JAX's order, ``device`` last."""
    want = list(inspect.signature(getattr(jbatch, name)).parameters)
    got = list(inspect.signature(getattr(batch, name)).parameters)
    assert got == want + ["device"]


def test_album_entry_points_called_positionally():
    """JAX's order, by position: ``mesh`` fourth, then ``pad_multiple`` /
    ``chunk_seconds`` and the rest; equal to the keyword calls."""
    tracks = [_signal(0.6, seed=1), _signal(0.4, seed=2)]
    p = MasteringParams.from_settings(SETTINGS)
    cfg = ChainConfig.gpu_default(FS)
    by_pos = batch.master_album(tracks, p, cfg, None, 4410, "cpu")
    by_kw = batch.master_album(tracks, p, cfg, pad_multiple=4410,
                               device="cpu")
    for a, b in zip(by_pos, by_kw, strict=True):
        np.testing.assert_array_equal(a, b)
    msgs = []
    outs, measured, meters = batch.master_album_streamed(
        tracks, p, cfg, None, 6.4, msgs.append, "pcm16", None, None, 1,
        True, None, "cpu")
    ref = batch.master_album_streamed(tracks, p, cfg, chunk_seconds=6.4,
                                      transfer="pcm16", return_meters=True,
                                      device="cpu")
    for a, b in zip(outs, ref[0], strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(measured, ref[1])
    assert len(meters) == 2 and msgs


def test_master_valid_frames_matches_jax():
    """A track zero-padded by 0.5 s and mastered with ``valid_frames`` =
    its length measures the unpadded track's loudness, as JAX's does."""
    x = _signal(1.5, seed=3)
    n = x.shape[0]
    padded = np.concatenate([x, np.zeros((FS // 2, 2), np.float32)])
    p = MasteringParams.from_settings(SETTINGS)
    cfg = ChainConfig.gpu_default(FS)
    got = chain.master(padded, p, cfg, return_result=True, valid_frames=n,
                       device="cpu")
    want = jpkg.master(padded, JParams.from_settings(SETTINGS),
                       JConfig.tpu_default(FS), return_result=True,
                       valid_frames=n)
    plain = chain.master(x, p, cfg, return_result=True, device="cpu")
    d = float(np.abs(got.audio.numpy() - np.asarray(want.audio)).max())
    d_lu = abs(float(got.measured_lufs) - float(want.measured_lufs))
    print(f"valid_frames: vs JAX max abs {d:.3e}, |dLU| {d_lu:.3e}")
    assert got.audio.shape == padded.shape and d <= 2e-4 and d_lu <= 1e-3
    assert abs(float(got.measured_lufs)
               - float(plain.measured_lufs)) <= 1e-3
    whole = chain.master(padded, p, cfg, return_result=True, device="cpu")
    assert float(whole.measured_lufs) < float(got.measured_lufs) - 0.5


def test_make_master_fn_matches_jax():
    """One cached chain; a ``MasterResult`` by default, as JAX's."""
    x = _signal(1.2, seed=4)
    cfg = ChainConfig.gpu_default(FS)
    fn = chain.make_master_fn(cfg, device="cpu")
    assert pkg.make_master_fn is chain.make_master_fn
    got = fn(x, MasteringParams.from_settings(SETTINGS))
    want = jpkg.make_master_fn(JConfig.tpu_default(FS))(
        x, JParams.from_settings(SETTINGS))
    assert isinstance(got, chain.MasterResult)
    d = float(np.abs(got.audio.numpy() - np.asarray(want.audio)).max())
    assert d <= 2e-4
    assert abs(float(got.measured_lufs) - float(want.measured_lufs)) <= 1e-3
    assert chain.make_master_fn(cfg, device="cpu").__closure__[0] \
        .cell_contents is fn.__closure__[0].cell_contents
    y = chain.make_master_fn(cfg, return_result=False, device="cpu")(
        x, MasteringParams.from_settings(SETTINGS))
    assert torch.is_tensor(y) and y.shape == x.shape


def test_config_names_match_jax():
    assert config.PARAM_RANGES == jconfig.PARAM_RANGES
    s = {**SETTINGS, "multiband": True, "low_thresh": -31.0,
         "mid_band_ratio": 5.0}
    p, jp = MasteringParams.from_settings(s), JParams.from_settings(s)
    assert config.settings_from_params(p) == jconfig.settings_from_params(jp)
    got, want = p.band_params(), jp.band_params()
    assert [dataclasses.asdict(b) for b in got] == [
        {k: float(v) for k, v in dataclasses.asdict(b).items()} for b in want]
    assert isinstance(got[0], config.CompressorBandParams)
    assert pkg.CompressorBandParams is config.CompressorBandParams
    assert ChainConfig.gpu_fast(48000) == convert.config_from_jax(
        JConfig.tpu_fast(48000))
    assert pkg.__version__ == jpkg.__version__ == "0.1.0"


def test_block_energy_accumulator_matches_jax():
    """Three chunks of whole cells, float64: the cells and the gated
    loudness as JAX's accumulator gives them; the mono-mean downmix is
    refused as JAX refuses it."""
    x = make_signal(int(FS * 1.5), fs=FS, seed=5)
    acc, jacc = loudness.BlockEnergyAccumulator(FS), \
        jloud.BlockEnergyAccumulator(FS)
    assert acc.cell_len == jacc.cell_len
    for lo, hi in ((0, 4410 * 5), (4410 * 5, 4410 * 12), (4410 * 12, 4410 * 15)):
        got = acc.update(torch.from_numpy(x[lo:hi]))
        want = np.asarray(jacc.update(jnp.asarray(x[lo:hi])))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-15)
    assert abs(float(acc.loudness()) - float(jacc.loudness())) <= 1e-9
    for a in (acc, jacc):
        with pytest.raises(ValueError, match="reference_mono_mean"):
            a.loudness("reference_mono_mean")


def test_rbj_designs_match_jax():
    for fs, fc, g in ((44100, 250.0, 3.0), (48000, 8000.0, -4.5),
                      (22050, 1000.0, 0.0)):
        for kind in ("low", "high"):
            np.testing.assert_allclose(
                biquad.rbj_shelf_sos(fs, fc, g, kind),
                np.asarray(jbiquad.rbj_shelf_sos(fs, fc, g, kind)),
                rtol=1e-9, atol=1e-15)
        np.testing.assert_allclose(
            biquad.rbj_peak_sos(fs, fc, g, q=0.7),
            np.asarray(jbiquad.rbj_peak_sos(fs, fc, g, q=0.7)), rtol=1e-9,
            atol=1e-15)
        np.testing.assert_allclose(
            biquad.rbj_highpass_sos(fs, fc / 10, 0.5),
            np.asarray(jbiquad.rbj_highpass_sos(fs, fc / 10, 0.5)),
            rtol=1e-9, atol=1e-15)
    t = torch.tensor(2.5, dtype=torch.float64, requires_grad=True)
    row = biquad.rbj_shelf_sos(FS, 250.0, t, "low")
    np.testing.assert_allclose(row.detach().numpy(),
                               biquad.rbj_shelf_sos(FS, 250.0, 2.5, "low"),
                               rtol=1e-12)
    for dt in (np.float32, np.float64):
        got, want = biquad.sos_identity(dt), np.asarray(
            jbiquad.sos_identity(dt))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_gain_computer_stats_matches_jax():
    r = np.random.default_rng(6)
    ms = r.uniform(0.0, 0.2, (500, 3)) ** 2
    ms[::17] = 0.0
    args = ((-25.0, -20.0, -15.0), (6.0, 3.0, 4.0), (441.0, 220.5, 44.1),
            (8820.0, 6615.0, 2205.0), 8)
    got = compressor.gain_computer_stats(torch.from_numpy(ms), *args)
    want = jcomp.gain_computer_stats(jnp.asarray(ms), *args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (500, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("hop,channel_major", [(8, False), (1, False),
                                               (8, True)])
def test_detector_stats_fused_matches_jax(hop, channel_major):
    """Two chunks, the control-rate tail carried from the first."""
    x = make_signal(6144 * 8, fs=FS, seed=8)
    r = np.random.default_rng(9)
    low, high = 0.5 * x + 0.01 * r.standard_normal(x.shape), 0.3 * x
    th, ra = (-25.0, -20.0, -15.0), (6.0, 3.0, 4.0)
    tail = jtail = None
    for lo, hi in ((0, 6144 * 3), (6144 * 3, 6144 * 8)):
        parts = [v[lo:hi].T.copy() if channel_major else v[lo:hi]
                 for v in (x, low, high)]
        got, tail = mb.detector_stats_fused(
            *map(torch.from_numpy, parts), FS, th, ra, hop=hop,
            ctrl_tail=tail, channel_major=channel_major)
        want, jtail = jmb.detector_stats_fused(
            *map(jnp.asarray, parts), FS, th, ra, hop=hop, ctrl_tail=jtail,
            channel_major=channel_major)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-9, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(tail.numpy(), np.asarray(jtail),
                                   rtol=1e-9, atol=1e-15)


def _jax_reexports(sub):
    """The names the JAX package's ``<sub>/__init__.py`` imports."""
    path = ROOT / "python_audio_mastering_tpu" / sub.strip(".").replace(
        ".", "/") / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_packages_reexport_jax_names(sub):
    """Each package's ``__init__`` re-exports the JAX package's names and
    lists them in ``__all__``."""
    import importlib

    mod = importlib.import_module("python_audio_mastering_tpu_torch" + sub)
    want = _jax_reexports(sub) - NOT_PORTED
    assert want <= set(mod.__all__), want - set(mod.__all__)
    for name in mod.__all__:
        assert hasattr(mod, name), name


def test_every_port_module_imports_without_jax():
    """Every module of the port, ``tests/torch_sp_ranks.py`` too, in a
    fresh interpreter where ``jax`` cannot be imported: none of the JAX
    package is loaded, and no import builds the kernel library."""
    code = (
        "import sys, pkgutil, importlib; sys.modules['jax'] = None\n"
        "import python_audio_mastering_tpu_torch as p\n"
        "from python_audio_mastering_tpu_torch.ops import _kernels\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if m.name.split('.')[-1] not in ('gui', '__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import tests.torch_sp_ranks\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] == 'python_audio_mastering_tpu']\n"
        "assert not bad, bad\n"
        "assert _kernels.library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
