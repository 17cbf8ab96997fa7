"""The port's sequence parallelism (``parallel.sequence``, ``parallel.mesh``,
``ops.iir.sosfilt_sharded``) against the JAX package's, on the CPU.

The port runs on D gloo ranks through ``parallel.mesh.launch``, every
call of one D in one launch; the JAX reference runs in this process on a
mesh of D of its virtual CPU devices.  Signals of 2-3 s from
``conftest.make_signal``, ``ChainConfig(sample_rate=44100,
dtype="float64")`` (block 512, so the rows body pads a 2 s track to
1 128 960·D samples, as the JAX package does).

Limits: the JAX package's own SP tolerance (rtol 1e-9, atol 1e-11,
tests/test_sequence.py:20) where the ballistics are exact or absent,
against the JAX SP run and against the port's own one-shot ``master``,
and measured loudness to 1e-9 LU; the blocked route's 2e-4
(test_torch_ballistics_modes.py:33) for multiband ``"approx"``, which
runs the block-parallel approximation on the CPU on both sides; meters
equal the port's own ``master_streamed`` meters to 1e-9 (JAX
test_sequence.py:150-155).
"""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.parallel import mesh as jmesh
from python_audio_mastering_tpu.parallel import sequence as jseq
from python_audio_mastering_tpu_torch import MasteringParams, convert, master
from python_audio_mastering_tpu_torch.ops.loudness import kweight_sos
from python_audio_mastering_tpu_torch.parallel import mesh, sequence
from python_audio_mastering_tpu_torch.parallel.streaming import master_streamed

from . import torch_sp_ranks
from .conftest import make_signal

FS = 44100
EXACT = {"rtol": 1e-9, "atol": 1e-11}
LU = 1e-9
APPROX_MAX = 2e-4
MB = {"saturation": 10, "bass_boost": 3.0, "lufs": -14.0, "multiband": True}

# name: (seconds, scale, settings, JAX ChainConfig fields, sp_ballistics);
# the legacy variant's SP body is not its one-shot chain (ROADMAP queue 3)
CASES = {
    "no_multiband": (2, 0.4, {"saturation": 20, "preset": "techno",
                              "width": 1.3, "lufs": -14.0}, {}, "approx"),
    "exact_hop1": (2, 0.4, MB, {"comp_ballistics": "scan"}, "exact"),
    "exact_hop8": (2, 0.4, {"lufs": -14.0, "multiband": True,
                            "low_thresh": -30.0}, {"comp_hop": 8}, "exact"),
    "unaligned": (2 + 1234 / FS, 0.3, {"preset": "pop", "lufs": -16.0}, {},
                  "approx"),
    "lookahead": (2 + 1234 / FS, 0.95, {"preset": "rock", "lufs": -9.0},
                  {"limiter_mode": "lookahead_truepeak"}, "approx"),
    "legacy": (2, 0.5, {**MB, "saturation": 30, "preset": "techno"},
               {"variant": "legacy", "comp_hop": 8}, "exact"),
    "approx": (2, 0.4, MB, {"comp_hop": 8, "comp_block_ctrl": 512},
               "approx"),
}
METERS = (3 + 517 / FS, 0.5, {"preset": "pop", "lufs": -18.0})
ALBUM = {"preset": "pop", "saturation": 15, "width": 1.2, "lufs": -17.0}
QUALITY = {"preset": "rock", "lufs": -9.0}
# the multiband album: two front groups (tracks 0 and 2 share one)
ALBUM_MB = ({**MB, "preset": "pop"}, {**MB, "preset": "rock", "width": 1.3,
                                      "low_thresh": -30.0},
            {**MB, "preset": "pop"})
# album: (tracks, per-track settings, JAX ChainConfig fields, kwargs)
ALBUMS = {
    "no_multiband": (3, (ALBUM,) * 3, {}, {}),
    "multiband_exact": (3, ALBUM_MB, {}, {"sp_ballistics": "exact"}),
    "lookahead": (2, (QUALITY,) * 2, {"limiter_mode": "lookahead_truepeak"},
                  {}),
}


def _signal(seconds, scale, seed=0):
    return make_signal(int(round(FS * seconds)), fs=FS, seed=seed) * scale


def _jcfg(**fields):
    return JConfig(sample_rate=FS, dtype="float64", **fields)


def _cfg(**fields):
    return convert.config_from_jax(_jcfg(**fields))


def _album_tracks(count):
    return ([_signal(1.3, 0.5, seed=s) for s in (0, 1)]
            + [_signal(0.9, 0.4, seed=2)])[:count]


def _filter_input(d):
    r = np.random.default_rng(d)
    return (r.standard_normal((d * 3001, 2)), r.standard_normal((2, 2, 2)))


def _calls(d):
    """``{name: (fn, args, kwargs)}``: every port call of one launch on
    ``d`` ranks."""
    calls = {}
    for name, (sec, scale, settings, fields, sp) in CASES.items():
        calls[name] = (sequence.master_track_sharded,
                       (_signal(sec, scale),
                        MasteringParams.from_settings(settings),
                        _cfg(**fields)),
                       {"sp_ballistics": sp, "device": "cpu"})
    sec, scale, settings = METERS
    calls["meters"] = (sequence.master_track_sharded,
                       (_signal(sec, scale),
                        MasteringParams.from_settings(settings), _cfg()),
                       {"return_meters": True, "device": "cpu"})
    x, zi = _filter_input(d)
    for name, z in (("filter", None), ("filter_zi", zi)):
        calls[name] = (torch_sp_ranks.sharded_filter,
                       (kweight_sos(FS), x, z, 256), {})
    if d == 4:
        for name, (count, settings, fields, kw) in ALBUMS.items():
            calls["album_" + name] = (
                sequence.master_album_sharded,
                (_album_tracks(count),
                 [MasteringParams.from_settings(s) for s in settings],
                 _cfg(**fields)), {"device": "cpu", **kw})
        calls["probe"] = (torch_sp_ranks.mesh_probe, (2,), {})
    return calls


@pytest.fixture(scope="module")
def runs():
    """``{d: {name: [the ranks' results]}}``, one launch per D."""
    out = {}
    for d in (2, 4):
        calls = _calls(d)
        ranks = mesh.launch(mesh.call_each, d, (list(calls.values()),))
        out[d] = {name: [r[k] for r in ranks]
                  for k, name in enumerate(calls)}
    return out


def _jax_mesh(d):
    return jmesh.make_mesh("seq", devices=jax.devices()[:d])


def _rank0(ranks):
    """Rank 0's result, after checking that every rank returned the same
    audio (SPMD: every rank returns the full result)."""
    def arrays(res):
        out = []
        for v in res:
            out += v if isinstance(v, list) else [v]
        return [v for v in out if isinstance(v, np.ndarray)]

    for r in ranks[1:]:
        for a, b in zip(arrays(r), arrays(ranks[0])):
            np.testing.assert_array_equal(a, b)
    return ranks[0]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_track_sharded_matches_jax(runs, case, d):
    sec, scale, settings, fields, sp = CASES[case]
    got, measured, gain_db = _rank0(runs[d][case])
    ref, m_ref, g_ref = jseq.master_track_sharded(
        _signal(sec, scale), JParams.from_settings(settings), _jcfg(**fields),
        mesh=_jax_mesh(d), sp_ballistics=sp)
    assert got.shape == ref.shape
    if case == "approx":
        assert np.abs(got - ref).max() <= APPROX_MAX
        return
    np.testing.assert_allclose(got, ref, **EXACT)
    assert abs(measured - float(m_ref)) < LU
    assert abs(gain_db - float(g_ref)) < LU
    if fields.get("variant") != "legacy":
        one = master(_signal(sec, scale), MasteringParams.from_settings(
            settings), _cfg(**fields), device="cpu").numpy()
        np.testing.assert_allclose(got, one, **EXACT)


@pytest.mark.parametrize("d", [2, 4])
def test_track_sharded_meters_equal_master_streamed(runs, d):
    sec, scale, settings = METERS
    x = _signal(sec, scale)
    got, measured, gain_db, met = _rank0(runs[d]["meters"])
    p = MasteringParams.from_settings(settings)
    out_s, m_s, g_s, met_s = master_streamed(
        x, p, _cfg(), chunk_seconds=1.0, return_meters=True, device="cpu")
    ref, _, _ = jseq.master_track_sharded(x, JParams.from_settings(settings),
                                          _jcfg(), mesh=_jax_mesh(d))
    np.testing.assert_allclose(got, ref, **EXACT)
    np.testing.assert_allclose(got, out_s, rtol=0, atol=1e-6)  # float32 out
    for key in ("momentary_lufs", "short_term_lufs"):
        np.testing.assert_allclose(met[key], met_s[key], rtol=0, atol=1e-9)
    for key in ("lra_lu", "true_peak_dbtp", "integrated_lufs"):
        assert abs(met[key] - met_s[key]) < 1e-9, key
    assert abs(measured - m_s) < 1e-9 and abs(gain_db - g_s) < 1e-9


@pytest.mark.parametrize("album", list(ALBUMS))
def test_album_sharded_2x2_matches_jax_and_per_track_master(runs, album):
    count, settings, fields, kw = ALBUMS[album]
    outs, measured = _rank0(runs[4]["album_" + album])
    tracks = _album_tracks(count)
    ref, m_ref = jseq.master_album_sharded(
        tracks, [JParams.from_settings(s) for s in settings],
        _jcfg(**fields),
        mesh=jmesh.make_mesh_2d(tracks=2, devices=jax.devices()[:4]), **kw)
    assert len(outs) == count
    np.testing.assert_allclose(measured, np.asarray(m_ref), rtol=0, atol=LU)
    for i, t in enumerate(tracks):
        assert outs[i].shape == t.shape
        np.testing.assert_allclose(outs[i], np.asarray(ref[i]), **EXACT)
        one = master(t, MasteringParams.from_settings(settings[i]),
                     _cfg(**fields), device="cpu").numpy()
        np.testing.assert_allclose(outs[i], one, **EXACT)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("with_zi", [False, True])
def test_sosfilt_sharded_matches_scipy(runs, d, with_zi):
    from scipy.signal import sosfilt

    x, zi = _filter_input(d)
    ref, zf = sosfilt(kweight_sos(FS), x, axis=0,
                      zi=zi if with_zi else np.zeros((2, 2, 2)))
    for y, zf_got in runs[d]["filter_zi" if with_zi else "filter"]:
        np.testing.assert_allclose(y, ref, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(zf_got, zf, rtol=1e-9, atol=1e-9)


def test_mesh_collectives_2d(runs):
    for r, got in enumerate(runs[4]["probe"]):
        row, col = divmod(r, 2)
        assert got["coords"] == (row, col) and got["shape"] == (2, 2)
        for axis, members, i in (("seq", [2 * row, 2 * row + 1], col),
                                 ("tracks", [col, 2 + col], row)):
            g = got[axis]
            assert g["all_gather"] == members
            assert g["from_prev"] == (members[i - 1] if i > 0 else 0.0)
            assert g["from_next"] == (members[i + 1] if i + 1 < 2 else 0.0)
            assert g["psum"] == sum(members) and g["pmax"] == max(members)
        assert got["world"] == [0.0, 1.0, 2.0, 3.0]


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 of 2 failed.*on purpose"):
        mesh.launch(torch_sp_ranks.fail_on, 2, (1,))


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _signal(0.5, 0.3)
    p = MasteringParams.from_settings({"lufs": -14.0})
    with pytest.raises(RuntimeError, match="CUDA"):
        sequence.master_track_sharded(x, p, _cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        sequence.master_album_sharded([x], p, _cfg())


def test_entry_points_check_their_options():
    p = MasteringParams.from_settings({"lufs": -14.0})
    with pytest.raises(ValueError, match="sp_ballistics"):
        sequence.master_track_sharded(np.zeros((10, 2)), p, _cfg(),
                                      sp_ballistics="fast", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        sequence.master_track_sharded(
            np.zeros((10, 2)), p,
            dataclasses.replace(_cfg(), variant="other"), device="cpu")


def test_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import python_audio_mastering_tpu_torch.parallel.sequence, "
            "python_audio_mastering_tpu_torch.parallel.mesh, "
            "python_audio_mastering_tpu_torch.utils.tracing, "
            "python_audio_mastering_tpu_torch.utils.logging, "
            "tests.torch_sp_ranks; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] == 'python_audio_mastering_tpu']; "
            "assert not bad, bad")
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
