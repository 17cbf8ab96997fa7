"""The port's automaster (``models.automaster``) against the JAX package's,
on the same seeded numpy inputs.

JAX runs its automaster as its own tests run it on the CPU: ``master()``
under ``jax.value_and_grad`` on its XLA route (no Pallas kernel has a
gradient rule), here under ``jax.jit``.  The port runs the kernels' plain
twins on the CPU, through the same ``autograd.Function``s whose backward
the card runs.

Tolerances, each with what this test measured on the CPU:
* spectral profile and latent map, float64 on both sides: rtol 1e-9
  (measured ~1e-16);
* loss and the six-component gradient, float64 on both sides: 1e-9 of
  the loss and of max |grad| (measured ≤ 3e-13 for the worker and legacy
  chains, ≤ 1.2e-11 for quality mode);
* the same in float32 (the JAX chain builds its EQ operators in float32
  in-graph, the port in float64): 1e-3 of the loss and of max |grad|
  (measured ≤ 1.2e-4 and ≤ 2.5e-4);
* fits, train steps and a resumed fit, float64: losses 1e-9 relative, θ
  1e-9 absolute (measured ~1e-13).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu.models import automaster as jam
from python_audio_mastering_tpu_torch import ChainConfig, MasteringParams, convert
from python_audio_mastering_tpu_torch.models import automaster as am
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir

from .conftest import make_signal

FS = 44100
SECONDS = 1.5
LATENT = len(am._LATENT_SPEC)
CASES = {
    "worker": {},
    "legacy": {"variant": "legacy"},
    "quality": {"limiter_mode": "lookahead_truepeak"},
}
LIMITS = {"float64": 1e-9, "float32": 1e-3}


def _signals():
    x = (make_signal(int(FS * SECONDS), fs=FS, seed=3) * 0.3).astype(
        np.float32)
    ref = (make_signal(int(FS * SECONDS), fs=FS, seed=4) * 0.5).astype(
        np.float32)
    return x, ref


def _models(dtype="float64", **cfg):
    jm = jam.AutoMasterModel(config=JConfig(sample_rate=FS, dtype=dtype,
                                            **cfg))
    pm = am.AutoMasterModel(config=ChainConfig(sample_rate=FS, dtype=dtype,
                                               **cfg), device="cpu")
    return jm, pm


def _target(ref):
    return np.array(jam.spectral_profile(jnp.asarray(ref, jnp.float64), FS))


@pytest.mark.parametrize("channels,n_bands", [(2, 24), (1, 24), (2, 12)])
def test_spectral_profile_matches_jax(channels, n_bands):
    x = make_signal(int(FS * SECONDS), channels=channels, fs=FS, seed=9)
    want = np.asarray(jam.spectral_profile(jnp.asarray(x), FS, n_bands))
    got = am.spectral_profile(torch.from_numpy(x), FS, n_bands).numpy()
    assert got.shape == (n_bands,)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_latent_to_params_matches_jax():
    theta = np.concatenate([np.random.default_rng(0).standard_normal(6) * 2,
                            [10.0, -10.0, 0.0, 1e-3, -3.0, 30.0]]).reshape(
                                2, LATENT)
    for th in theta:
        want = jam.latent_to_params(jnp.asarray(th), lufs=-12.0)
        got = am.latent_to_params(torch.from_numpy(th), lufs=-12.0)
        for name, lo, hi in am._LATENT_SPEC:
            w, g = float(getattr(want, name)), float(getattr(got, name))
            assert lo <= g <= hi
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
        assert got.lufs == -12.0 and got.has_tensors()
        assert got.to_settings()["saturation"] == pytest.approx(
            float(want.saturation), rel=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grad_match_jax(case, dtype):
    """At θ = 0 and at one seeded θ.  Every gradient component is non-zero
    but, in the legacy chain, mid_cut's and presence's: its peaks blend a
    Butterworth band-pass whose edges ``fc/√Q`` and ``fc·√Q`` meet at the
    reference's Q = 1, a band of zero width that passes nothing (main.py:
    139-154), so those sliders do not move the output, in JAX too."""
    x, ref = _signals()
    target = _target(ref)
    jm, pm = _models(dtype, **CASES[case])
    value_and_grad = jax.jit(jax.value_and_grad(jm.loss))
    audio = pm.as_audio(x)
    lim = LIMITS[dtype]
    for theta in (np.zeros(LATENT),
                  np.random.default_rng(1).standard_normal(LATENT) * 0.5):
        jl, jg = value_and_grad(jnp.asarray(theta, jnp.dtype(dtype)),
                                jnp.asarray(x), jnp.asarray(target))
        th = torch.tensor(theta, dtype=getattr(torch, dtype),
                          requires_grad=True)
        loss = pm.loss(th, audio, torch.from_numpy(target))
        loss.backward()
        jg, pg = np.asarray(jg, np.float64), th.grad.numpy().astype(np.float64)
        loss = float(loss.detach())
        d_loss = abs(loss - float(jl)) / abs(float(jl))
        d_grad = np.abs(pg - jg).max() / np.abs(jg).max()
        print(f"{case} {dtype}: loss {loss:.8g} rel {d_loss:.3e}, "
              f"grad {d_grad:.3e} of max")
        assert d_loss <= lim and d_grad <= lim
        dead = [2, 3] if case == "legacy" else []
        assert np.all(np.delete(pg, dead) != 0.0), pg
        assert np.all(pg[dead] == 0.0) and np.all(jg[dead] == 0.0), (pg, jg)


def test_fit_matches_jax():
    """Five float64 Adam steps: the losses and the fitted sliders."""
    x, ref = _signals()
    target = _target(ref)
    jm, pm = _models()
    jp, jl = jam.fit(jm, x, target, steps=5, lr=0.1)
    pp, pl = am.fit(pm, x, target, steps=5, lr=0.1)
    np.testing.assert_allclose(pl, jl, rtol=1e-9)
    js, ps = jp.to_settings(), pp.to_settings()
    assert set(ps) == set(js)
    for k, v in js.items():
        if isinstance(v, float):
            assert abs(ps[k] - v) <= 1e-9, (k, ps[k], v)
        else:
            assert ps[k] == v


@pytest.mark.parametrize("shared", [True, False])
def test_train_step_matches_jax(shared):
    """One step over a batch of two tracks: one θ for both (shared), or a
    θ per track."""
    tracks = [(make_signal(int(FS * SECONDS), fs=FS, seed=i) * 0.3)
              for i in range(2)]
    jm, pm = _models()
    targets = np.stack([_target(t) for t in tracks])
    theta0 = (np.zeros(LATENT) if shared else
              np.random.default_rng(2).standard_normal((2, LATENT)) * 0.3)
    opt = optax.adam(0.05)
    step = jam.make_train_step(jm, opt, shared=shared)
    jt, _, jloss = step(jnp.asarray(theta0), opt.init(jnp.asarray(theta0)),
                        jnp.asarray(np.stack(tracks)), jnp.asarray(targets))
    theta = torch.tensor(theta0, requires_grad=True)
    pstep = am.make_train_step(pm, torch.optim.Adam([theta], lr=0.05),
                               shared=shared)
    ploss = pstep(theta, torch.from_numpy(np.stack(tracks)),
                  torch.from_numpy(targets))
    assert abs(float(ploss) - float(jloss)) <= 1e-9 * abs(float(jloss))
    assert theta.shape == theta0.shape
    np.testing.assert_allclose(theta.detach().numpy(), np.asarray(jt),
                               rtol=0, atol=1e-9)


def test_resume_from_optax_matches_jax():
    """A fit begun in JAX (3 steps) and continued in the port (2 steps,
    through ``convert.theta_from_jax`` / ``adam_state_from_optax``) gives
    JAX's 5-step θ and losses."""
    x, ref = _signals()
    target = _target(ref)
    jm, pm = _models()
    opt = optax.adam(0.1)
    step = jam.make_train_step(jm, opt, shared=True)
    th = jnp.zeros(LATENT)
    st = opt.init(th)
    batch, tg = jnp.asarray(x)[None], jnp.asarray(target)[None]
    losses = []
    for i in range(5):
        if i == 3:
            th3, st3 = th, st
        th, st, loss = step(th, st, batch, tg)
        losses.append(float(loss))
    theta = convert.theta_from_jax(th3).requires_grad_(True)
    optimizer = torch.optim.Adam([theta], lr=0.1)
    optimizer.load_state_dict(convert.adam_state_from_optax(st3, lr=0.1))
    pstep = am.make_train_step(pm, optimizer, shared=True)
    pbatch = pm.as_audio(x)[None]
    ptg = torch.tensor(np.asarray(target))[None]
    pl = [float(pstep(theta, pbatch, ptg)) for _ in range(2)]
    np.testing.assert_allclose(pl, losses[3:], rtol=1e-9)
    params = am.latent_to_params(theta.detach())
    want = jam.latent_to_params(th)
    for name, _, _ in am._LATENT_SPEC:
        assert abs(float(getattr(params, name))
                   - float(getattr(want, name))) <= 1e-9, name


@pytest.mark.parametrize("emit_mono,channels", [(False, 2), (True, 2),
                                                 (True, 1)])
def test_front_chain_vjp_gradcheck(emit_mono, channels):
    """K1's ``autograd.Function`` (the backward the card runs) against
    finite differences, float64, every input and slider."""
    g = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           requires_grad=True)

    args = (leaf(channels, 3, 16), leaf(channels, 3, 4), leaf(16, 16),
            leaf(16, 4), *(torch.tensor(v, dtype=torch.float64,
                                        requires_grad=True)
                           for v in (0.8, 0.2, 1.8, 1.3)))

    def f(x, s, t, w, dry, wet, drive, width):
        return cmb.front_chain(x, s, t, w, (dry, wet, drive), width,
                               emit_mono=emit_mono)

    assert torch.autograd.gradcheck(f, args)


def test_kweight_cells_vjp_gradcheck():
    g = torch.Generator().manual_seed(1)
    args = tuple(torch.randn(*s, generator=g, dtype=torch.float64,
                             requires_grad=True)
                 for s in ((1, 3, 12), (1, 3, 4), (12, 12), (12, 4)))
    assert torch.autograd.gradcheck(lambda *a: cmb.kweight_cells(*a, 3), args)


def test_fit_step_launches_and_plain_calls():
    """One fit step's forward runs K1 once and K4 twice (here their plain
    twins, on the CPU) and the tail as separate plain ops (K9's twin not
    called); its backward calls no twin."""
    x, ref = _signals()
    _, pm = _models("float32")
    theta = torch.zeros(LATENT, requires_grad=True)
    cmb.reset_launch_counts()
    loss = pm.loss(theta, pm.as_audio(x),
                   am.spectral_profile(torch.from_numpy(ref), FS))
    want = {"front_chain_ref": 1, "kweight_cells_ref": 2, "sos_scan_ref": 0,
            "gain_limit_ref": 0, "lookahead_limit_ref": 0}
    assert cmb.plain_calls() == want
    loss.backward()
    assert cmb.plain_calls() == want
    assert torch.all(theta.grad != 0)


def test_tensor_sliders_match_float_sliders():
    """The chain's tensor route (EQ operators built in the graph) gives the
    float route's output; tensor sliders with multiband on are refused."""
    x, _ = _signals()
    cfg = ChainConfig.gpu_default(FS)
    settings = {"saturation": 25.0, "bass_boost": 3.0, "mid_cut": 1.5,
                "presence_boost": -2.0, "treble_boost": 1.0, "width": 1.2}
    p = MasteringParams.from_settings(settings)
    pt = MasteringParams.from_settings(settings)
    for k, v in settings.items():
        setattr(pt, k, torch.tensor(v))
    from python_audio_mastering_tpu_torch import master

    y = master(x, p, cfg, device="cpu")
    yt = master(x, pt, cfg, device="cpu")
    assert float((y - yt).abs().max()) <= 1e-6
    pt.multiband = True
    with pytest.raises(ValueError, match="multiband"):
        master(x, pt, cfg, device="cpu")


def test_traced_operators_match_static():
    """``iir.blocked_ops_traced`` and its states pass (the partial last
    block's final state included) against the host-built operators."""
    from python_audio_mastering_tpu_torch.models.chain import eq_sos

    sos = eq_sos(MasteringParams(bass_boost=4.0, mid_cut=2.0,
                                 presence_boost=-3.0, treble_boost=2.5), FS)
    static = iir.blocked_ops(sos, 384, "cpu", torch.float64)
    traced = iir.blocked_ops_traced(torch.tensor(sos, requires_grad=True),
                                    384, torch.float64)
    # relative to each operator's max (measured ≤ 1.3e-13; A^L, whose
    # entries are small, 4.9e-12)
    for name, lim in (("t", 1e-12), ("g", 1e-12), ("w", 1e-12),
                      ("al", 1e-10)):
        a, b = getattr(static, name), getattr(traced, name).detach()
        assert float((a - b).abs().max() / a.abs().max()) <= lim, name
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 300, 384)))
    for n_valid in (None, 300 * 384 - 100, 299 * 384):
        s1, z1, _ = iir.sosfilt_states_rows(None, x, ops=static,
                                            n_valid=n_valid)
        s2, z2, _ = iir.sosfilt_states_rows(None, x, ops=traced,
                                            n_valid=n_valid)
        assert float((s1 - s2.detach()).abs().max()
                     / s1.abs().max()) <= 1e-12
        assert float((z1 - z2.detach()).abs().max()
                     / z1.abs().max()) <= 1e-12


def test_automaster_defaults_to_the_card(tmp_path):
    """Without ``device`` and without a card: the model raises naming
    CUDA, the engine answers None with an ``ERROR:`` line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="AutoMasterModel: device 'cuda'"):
        am.AutoMasterModel(config=ChainConfig.gpu_default(FS))
    from python_audio_mastering_tpu_torch import engine
    from python_audio_mastering_tpu_torch.io import wavio

    x, ref = _signals()
    wavio.write_wav(tmp_path / "in.wav", x, FS)
    wavio.write_wav(tmp_path / "ref.wav", ref, FS)
    msgs = []
    fitted = engine.automaster_audio(
        {"input_file": str(tmp_path / "in.wav"),
         "reference_file": str(tmp_path / "ref.wav"),
         "output_file": str(tmp_path / "out.wav")}, msgs.append, steps=1)
    assert fitted is None
    assert msgs[-1].startswith("ERROR:") and "CUDA" in msgs[-1], msgs
    assert not (tmp_path / "out.wav").exists()


@pytest.mark.parametrize("shared", [True, False])
def test_folded_step_makes_one_chain_call(shared):
    """A batch folds into the album's block axis: one chain call a step,
    K1 once (a group a θ row without ``shared``) and K4 twice, whatever
    T; each track's loss as :meth:`loss` gives it alone."""
    tracks = np.stack([make_signal(int(FS * SECONDS), fs=FS, seed=i) * 0.3
                       for i in range(3)])
    targets = np.stack([_target(t) for t in tracks])
    _, pm = _models()
    theta0 = (np.zeros(LATENT) if shared else
              np.random.default_rng(4).standard_normal((3, LATENT)) * 0.3)
    for t in (1, 3):
        theta = torch.tensor(theta0 if shared else theta0[:t],
                             requires_grad=True)
        cmb.reset_launch_counts()
        per_track = pm.batch_loss(theta, torch.from_numpy(tracks[:t]),
                                  torch.from_numpy(targets[:t]), shared)
        assert cmb.plain_calls() == {
            "front_chain_ref": 1 if shared else t, "kweight_cells_ref": 2,
            "sos_scan_ref": 0, "gain_limit_ref": 0,
            "lookahead_limit_ref": 0}
        for i in range(t):
            alone = pm.loss(theta if shared else theta[i], tracks[i],
                            torch.from_numpy(targets[i]))
            got, want = per_track[i].item(), alone.item()
            assert abs(got - want) <= 1e-12 * abs(want)
