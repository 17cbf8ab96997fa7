"""The port's data parallelism (``parallel.mesh`` shardings,
``parallel.batch`` with ``mesh``, ``make_album_fn``, the automaster's step
over ranks) against the JAX package's, on the CPU.

The port runs on two gloo ranks through ``parallel.mesh.launch``, every
call in one launch; the JAX reference runs in this process on a mesh of
two of its virtual CPU devices.  Three tracks of 1.0-1.2 s at 48 kHz (so
0.4 s chunks are whole: the chunk alignment is 0.2 s there), padded to
four over the two ranks, ``gpu_default`` (the JAX ``tpu_default`` knobs).

Limits, those of ``test_torch_batch.py``: against the JAX album 2e-4 max
abs with multiband off, rms 1e-3 with it on (its ballistics are the
block-parallel approximation); against the JAX exact streamed runner
2e-4 and 1e-3 LU, both sides in float64: at sample 17355 of the 1.1 s
track a compressor threshold sits on a float32 rounding edge, where JAX's
float32 run lands 2.88e-4 from its float64 run and the port's float32
album 2.83e-4 (its per-track run 5.0e-6), while the two float64 runs
agree to 3e-8; against the port's one-device album 2e-4 and 1e-3 LU
(printed: whether it is bitwise).  On the pcm16 wire (multiband off, against JAX on the same
wire) both sides round their outputs to its grid, which adds at most one
step, 3.1e-5.  The automaster's step in float64:
loss 1e-9 relative and θ 1e-9 (``test_torch_automaster.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu.models import automaster as jam
from python_audio_mastering_tpu.parallel import batch as jbatch
from python_audio_mastering_tpu.parallel import mesh as jmesh
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams
from python_audio_mastering_tpu_torch.models import automaster as am
from python_audio_mastering_tpu_torch.parallel import batch, mesh

from . import torch_sp_ranks
from .conftest import make_signal

FS = 48000
D = 2
SECONDS = (1.2, 1.0, 1.1)
CHUNK = 0.4
STOP_AFTER = 2
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
PCM16_STEP = 1.0 / 32767.0
AM_FS = 44100
AM_SECONDS = 1.5
AM_LR = 0.05


def _tracks():
    return [(make_signal(int(FS * s), fs=FS, seed=50 + i) * 0.5).astype(
        np.float32) for i, s in enumerate(SECONDS)]


def _params(multiband):
    return MasteringParams.from_settings({**SETTINGS,
                                          "multiband": multiband})


def _jparams(multiband):
    return JParams.from_settings({**SETTINGS, "multiband": multiband})


def _cfg():
    return ChainConfig.gpu_default(FS)


def _jmesh(d=D):
    return jmesh.make_mesh(devices=jax.devices()[:d])


def _am_batch():
    tracks = np.stack([make_signal(int(AM_FS * AM_SECONDS), fs=AM_FS,
                                   seed=60 + i) * 0.3 for i in range(D)])
    targets = np.stack([np.array(jam.spectral_profile(jnp.asarray(t), AM_FS))
                        for t in tracks])
    return tracks, targets


def _theta0(shared):
    return (np.zeros(6) if shared else
            np.random.default_rng(7).standard_normal((D, 6)) * 0.3)


def _am_cfg():
    return ChainConfig(sample_rate=AM_FS, dtype="float64")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port call of the module in one launch of ``D`` gloo ranks:
    ``{name: [the ranks' results]}``, and the one-device runs beside them
    (``"one/<name>"``)."""
    tracks, cfg = _tracks(), _cfg()
    ckpt = tmp_path_factory.mktemp("dp_ckpt")
    one_dev = tmp_path_factory.mktemp("one_device_ckpt")
    batch.master_album_streamed(tracks, _params(False), cfg,
                                chunk_seconds=CHUNK, device="cpu",
                                checkpoint_dir=str(one_dev))
    streamed = {"chunk_seconds": CHUNK, "device": "cpu", "transfer": "pcm16"}
    meters = {"chunk_seconds": CHUNK, "device": "cpu", "return_meters": True}
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    am_tracks, am_targets = _am_batch()
    fn_batch = np.stack([t[: int(FS * 1.0)] for t in tracks])
    fn_lengths = [int(FS * 1.0), int(FS * 0.8), int(FS * 0.9)]
    calls = {
        "album_off": (batch.master_album, (tracks, _params(False), cfg),
                      {"device": "cpu"}),
        "album_on": (batch.master_album, (tracks, _params(True), cfg),
                     {"device": "cpu"}),
        "streamed_off": (torch_sp_ranks.album_streamed_tracks_done,
                         (tracks, _params(False), cfg), streamed),
        "streamed_on": (torch_sp_ranks.album_streamed_tracks_done,
                        (tracks, _params(True), cfg64), meters),
        "resumed_off": (torch_sp_ranks.album_streamed_resumed,
                        (tracks, _params(False), cfg, str(ckpt), STOP_AFTER),
                        streamed),
        "resume_other_size": (torch_sp_ranks.raises,
                              (batch.master_album_streamed, tracks,
                               _params(False), cfg),
                              {**streamed, "checkpoint_dir": str(one_dev)}),
        "album_fn": (torch_sp_ranks.album_fn,
                     (cfg, fn_batch[:2], [_params(True)] * 2,
                      fn_lengths[:2]), {}),
        "album_fn_uneven": (torch_sp_ranks.raises,
                            (torch_sp_ranks.album_fn, cfg, fn_batch,
                             _params(True), fn_lengths), {}),
    }
    for shared in (True, False):
        calls[f"step_shared={shared}"] = (
            torch_sp_ranks.train_step,
            (_am_cfg(), am_tracks, am_targets, _theta0(shared), shared,
             AM_LR), {})
    ranks = mesh.launch(mesh.call_each, D, (list(calls.values()),))
    out = {name: [r[k] for r in ranks] for k, name in enumerate(calls)}
    out["one/album_off"] = batch.master_album(tracks, _params(False), cfg,
                                              device="cpu")
    out["one/album_on"] = batch.master_album(tracks, _params(True), cfg,
                                             device="cpu")
    out["one/streamed_off"] = batch.master_album_streamed(
        tracks, _params(False), cfg, **streamed)
    out["one/streamed_on"] = batch.master_album_streamed(
        tracks, _params(True), cfg64, **meters)
    out["ckpt"], out["one_dev_ckpt"] = str(ckpt), str(one_dev)
    out["fn_inputs"] = (fn_batch, fn_lengths)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references, built once: its album over two devices
    (multiband off and on, block-parallel ballistics), its exact streamed
    runner per track (multiband on, the serial ballistics scan) in
    float64, and its streamed album over two devices (multiband off, the
    pcm16 wire)."""
    tracks, cfg = _tracks(), JConfig.tpu_default(FS)
    m = _jmesh()
    refs = {mb: jbatch.master_album(tracks, _jparams(mb), cfg, mesh=m)
            for mb in (False, True)}
    x64 = dataclasses.replace(cfg, dtype="float64", comp_ballistics="scan",
                              mb_kernel="xla")
    refs["exact_streamed"] = [
        jstream.master_streamed(x.astype(np.float64), _jparams(True), x64,
                                chunk_seconds=CHUNK)[:2] for x in tracks]
    refs["streamed_off"] = jbatch.master_album_streamed(
        tracks, _jparams(False), cfg, mesh=m, chunk_seconds=CHUNK,
        transfer="pcm16")
    return refs


def _same_on_every_rank(ranks):
    """Rank 0's album result, after checking every rank returned it
    bitwise (SPMD: every rank returns the whole album)."""
    def arrays(res):
        if isinstance(res, np.ndarray):
            return [res]
        if isinstance(res, dict):
            return [v for v in res.values() if isinstance(v, np.ndarray)]
        if isinstance(res, (list, tuple)):
            return [a for v in res for a in arrays(v)]
        return []

    for r in ranks[1:]:
        for a, b in zip(arrays(r), arrays(ranks[0]), strict=True):
            np.testing.assert_array_equal(a, b)
    return ranks[0]


def _max(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_make_mesh_names_the_tracks_axis():
    """``make_mesh()``'s axis is JAX's, the one the album shards over."""
    import inspect

    default = inspect.signature(mesh.make_mesh).parameters["axis_name"]
    assert (default.default,) == jmesh.make_mesh().axis_names == ("tracks",)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharding_index_map_matches_jax(d):
    """``tracks_sharding`` / ``replicated_sharding`` give each rank the
    slices JAX's ``NamedSharding`` gives each device, position by
    position; an uneven split raises as JAX's does.  No ranks launched:
    the mesh is this rank's view of a ``d``-rank one."""
    m = mesh.Mesh(("tracks",), (d,), (d - 1,), (None,),
                  torch.device("cpu"), "gloo")
    jm = _jmesh(d)
    for shape in ((2 * d, 7, 2), (d, 3), (4 * d,)):
        for port, jax_ in ((mesh.tracks_sharding(m),
                            jmesh.tracks_sharding(jm)),
                           (mesh.replicated_sharding(m),
                            jmesh.replicated_sharding(jm))):
            got = port.devices_indices_map(shape)
            want = jax_.devices_indices_map(shape)
            assert list(got) == list(range(d))
            assert list(got.values()) == [want[dev]
                                          for dev in jm.devices.flat]
    s = mesh.tracks_sharding(m)
    assert s.rows(3 * d) == range(3 * (d - 1), 3 * d)
    np.testing.assert_array_equal(s.shard(np.arange(3 * d)),
                                  np.arange(3 * (d - 1), 3 * d))
    with pytest.raises(ValueError, match="evenly"):
        s.devices_indices_map((d + 1, 2))
    with pytest.raises(ValueError):
        jmesh.tracks_sharding(jm).devices_indices_map((d + 1, 2))


@pytest.mark.parametrize("multiband", [False, True])
def test_album_over_ranks_matches_jax_and_one_device(runs, jax_refs,
                                                     multiband):
    name = "album_on" if multiband else "album_off"
    outs = _same_on_every_rank(runs[name])
    one = runs["one/" + name]
    for i, x in enumerate(_tracks()):
        assert outs[i].shape == x.shape and outs[i].dtype == np.float32
        d_one = _max(outs[i], one[i])
        line = (f"track {i}: vs one device {d_one:.3e} (bitwise "
                f"{np.array_equal(outs[i], one[i])})")
        assert d_one <= 2e-4
        if multiband:
            rms = float(np.sqrt(np.mean((outs[i] - jax_refs[True][i]) ** 2)))
            line += f"; vs JAX album rms {rms:.3e}"
            assert rms <= 1e-3
        else:
            d_jax = _max(outs[i], jax_refs[False][i])
            line += f"; vs JAX album {d_jax:.3e}"
            assert d_jax <= 2e-4
        print(line)


def test_streamed_album_over_ranks_matches_jax(runs, jax_refs):
    """Multiband off, the pcm16 wire: against JAX's streamed album over
    two devices on the same wire and the port's one-device run;
    ``on_track_done`` once a real track on the rank that mastered it, no
    silent track."""
    res = _same_on_every_rank([r[0] for r in runs["streamed_off"]])
    outs, measured = res
    ref, m_ref = jax_refs["streamed_off"]
    one, m_one = runs["one/streamed_off"]
    assert len(outs) == len(measured) == len(SECONDS)
    for i in range(len(SECONDS)):
        d_jax, d_one = _max(outs[i], ref[i]), _max(outs[i], one[i])
        print(f"track {i}: vs JAX streamed album {d_jax:.3e}, "
              f"|dLU| {abs(measured[i] - m_ref[i]):.3e}; vs one device "
              f"{d_one:.3e} (bitwise {np.array_equal(outs[i], one[i])})")
        assert d_jax <= 2e-4 + PCM16_STEP
        assert abs(measured[i] - m_ref[i]) <= 1e-3
        assert d_one <= 2e-4 and abs(measured[i] - m_one[i]) <= 1e-3
        assert np.all(np.abs(np.round(outs[i] * 32767.0) / 32767.0
                             - outs[i]) <= 1e-7)
    done = [sorted(r[1]) for r in runs["streamed_off"]]
    assert done[0] == [(0, outs[0].shape[0], False),
                       (1, outs[1].shape[0], False)]
    assert done[1] == [(2, outs[2].shape[0], False)]
    for _, _, timings, msgs in runs["streamed_off"]:
        assert {"h2d_s", "compute_s", "d2h_s", "gather_s"} <= set(timings)
        assert msgs[-1].startswith("Finalizing chunk")
        assert any("(2 tracks)" in m for m in msgs)


def test_streamed_album_over_ranks_meters(runs, jax_refs):
    """Multiband on, meters, float64: against the port's one-device run
    (outputs, loudness, every meter) and JAX's exact streamed runner."""
    outs, measured, meters = _same_on_every_rank(
        [r[0] for r in runs["streamed_on"]])
    one, m_one, met_one = runs["one/streamed_on"]
    for i in range(len(SECONDS)):
        x_ref, m_ref = jax_refs["exact_streamed"][i]
        d_one, d_exact = _max(outs[i], one[i]), _max(outs[i], x_ref)
        print(f"track {i}: vs one device {d_one:.3e} (bitwise "
              f"{np.array_equal(outs[i], one[i])}); vs JAX exact "
              f"{d_exact:.3e}, |dLU| {abs(measured[i] - m_ref):.3e}")
        assert d_one <= 2e-4 and abs(measured[i] - m_one[i]) <= 1e-3
        assert d_exact <= 2e-4 and abs(measured[i] - m_ref) <= 1e-3
        for k, v in met_one[i].items():
            np.testing.assert_allclose(meters[i][k], v, rtol=0, atol=1e-3,
                                       err_msg=k)
    done = sorted(d for r in runs["streamed_on"] for d in r[1])
    assert done == [(i, o.shape[0], True) for i, o in enumerate(outs)]


def test_streamed_album_over_ranks_resumes_bitwise(runs):
    """Each rank interrupted after its chunk 2 and resumed from its own
    subdirectory: bitwise the uninterrupted run; a resume at another
    mesh size raises, naming both sizes."""
    import os

    full = _same_on_every_rank([r[0] for r in runs["streamed_off"]])
    resumed = _same_on_every_rank([r[0] for r in runs["resumed_off"]])
    for a, b in zip(resumed[0], full[0], strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed[1], full[1])
    for _, msgs, done in runs["resumed_off"]:
        assert msgs[-1].startswith(f"Processed chunk {STOP_AFTER}/")
    assert sorted(d for r in runs["resumed_off"] for d in r[2]) == [
        (i, o.shape[0]) for i, o in enumerate(full[0])]
    ckpt = runs["ckpt"]
    assert sorted(os.listdir(ckpt)) == ["mesh.json", "rank0", "rank1"]
    for msg in runs["resume_other_size"]:
        assert msg is not None and "1 ranks" in msg and "has 2" in msg
    with pytest.raises(ValueError, match="mesh of 2 ranks; this run has 1"):
        batch.master_album_streamed(_tracks(), _params(False), _cfg(),
                                    chunk_seconds=CHUNK, device="cpu",
                                    checkpoint_dir=ckpt)


def test_make_album_fn_matches_jax(runs):
    """``make_album_fn`` over two ranks against JAX's over two devices
    (multiband on: rms 1e-3, its ballistics block-parallel) and the port's
    one-device function (2e-4); an uneven tracks axis raises, as JAX's
    sharded ``jit`` does."""
    fn_batch, lengths = runs["fn_inputs"]
    got = _same_on_every_rank(runs["album_fn"])
    jfn = jbatch.make_album_fn(JConfig.tpu_default(FS), _jmesh())
    want = np.asarray(jfn(fn_batch[:2], jbatch.stack_params(
        [_jparams(True)] * 2), np.asarray(lengths[:2])))
    one = batch.make_album_fn(_cfg(), device="cpu")(
        fn_batch[:2], _params(True), lengths[:2]).numpy()
    assert got.shape == want.shape == fn_batch[:2].shape
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    print(f"make_album_fn vs JAX rms {rms:.3e}, vs one device "
          f"{_max(got, one):.3e}")
    assert rms <= 1e-3 and _max(got, one) <= 2e-4
    for msg in runs["album_fn_uneven"]:
        assert msg is not None and "evenly" in msg
    with pytest.raises(ValueError):
        jfn(fn_batch, jbatch.stack_params([_jparams(True)] * 3),
            np.asarray(lengths))


@pytest.mark.parametrize("shared", [True, False])
def test_train_step_over_ranks_matches_jax(runs, shared):
    """One float64 Adam step over two tracks, one a rank, against JAX's
    step on the batch sharded over two devices; the port's folded
    one-device step too.  With ``shared`` θ is bitwise the same on both
    ranks; without, each rank holds its own track's row."""
    tracks, targets = _am_batch()
    theta0 = _theta0(shared)
    jm = jam.AutoMasterModel(config=JConfig(sample_rate=AM_FS,
                                            dtype="float64"))
    opt = optax.adam(AM_LR)
    step = jam.make_train_step(jm, opt, shared=shared)
    sh = jmesh.tracks_sharding(_jmesh())
    jt, _, jloss = step(jnp.asarray(theta0), opt.init(jnp.asarray(theta0)),
                        jax.device_put(jnp.asarray(tracks), sh),
                        jax.device_put(jnp.asarray(targets), sh))
    jt, jloss = np.asarray(jt), float(jloss)
    ranks = runs[f"step_shared={shared}"]
    theta = (ranks[0][1] if shared
             else np.concatenate([t for _, t in ranks]))
    if shared:
        np.testing.assert_array_equal(ranks[0][1], ranks[1][1])
    th1 = torch.tensor(theta0, requires_grad=True)
    pm = am.AutoMasterModel(config=_am_cfg(), device="cpu")
    one_loss = am.make_train_step(
        pm, torch.optim.Adam([th1], lr=AM_LR), shared=shared)(
        th1, torch.from_numpy(tracks), torch.from_numpy(targets))
    for what, loss, th in (("two ranks", ranks[0][0], theta),
                           ("one device", float(one_loss),
                            th1.detach().numpy())):
        print(f"{what}: loss rel {abs(loss - jloss) / abs(jloss):.3e}, "
              f"theta {np.abs(th - jt).max():.3e}")
        assert abs(loss - jloss) <= 1e-9 * abs(jloss)
        assert th.shape == jt.shape
        np.testing.assert_allclose(th, jt, rtol=0, atol=1e-9)
    assert ranks[0][0] == ranks[1][0]

