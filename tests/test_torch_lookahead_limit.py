"""The lookahead limiter's route and its plain twin on the CPU
(``ops.limiter``): ``lookahead_limit_ref`` is, bit for bit, the limiter's
plain stages composed as ``lookahead_limiter`` composed them before K10
(``_limiter_before_k10``, a verbatim copy of that code) on float32 and
float64, mono and stereo, true peak on and off, on tracks shorter than the
kernel's halos, lengths that fill no tile, the chain's strided views,
silence, hard limiting and a track that ends inside an attack; the CPU
route takes the twin and launches nothing; the chain's quality output is
unchanged; a release with ``rho`` = 0; the kernel's look-ahead limit,
refused where the chain's configuration is checked; and every kernel
entry's C
parameters against its ``ctypes`` signature.  K10 against its twin on the
card is in ``test_torch_kernels.py``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.models import chain as chain_mod
from python_audio_mastering_tpu_torch.ops import _kernels
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import limiter as lim
from python_audio_mastering_tpu_torch.ops import lookahead_limit as k10

from ._limiter_before_k10 import lookahead_limiter as _before_k10
from .conftest import make_signal

FS = 44100
LOOK = 66                      # 1.5 ms at 44.1 kHz
# shorter than a halo (look + 16, 2·look + 16), one frame past K10's
# 4154-frame tile, two tiles and a ragged third
LENGTHS = (1, 65, 149, 4155, 9001)


def _signal(kind, n, channels, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / FS
    if kind == "noise":
        x = r.standard_normal((n, channels)) * 0.9
    elif kind == "silence":
        x = np.zeros((n, channels))
    elif kind == "square":                   # hot: hard limiting
        x = np.repeat(1.6 * np.sign(np.sin(2 * np.pi * 441.0 * t))[:, None],
                      channels, 1)
    else:                                    # quiet, then a burst at the end
        x = r.standard_normal((n, channels)) * 0.05
        x[-min(n, LOOK // 2):] *= 60.0
    return x


@pytest.mark.parametrize("true_peak", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["noise", "silence", "square", "end_attack"])
def test_twin_is_the_limiter_before_k10_bitwise(kind, n, dtype, channels,
                                                true_peak):
    x = torch.as_tensor(_signal(kind, n, channels, seed=n), dtype=dtype)
    got = lim.lookahead_limit_ref(x, FS, true_peak=true_peak)
    want = _before_k10(x, FS, true_peak=true_peak)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    if kind == "silence":
        assert not got.any()
    elif kind == "square" and n > LOOK:
        assert got.abs().max() < 0.9 * x.abs().max()        # limited


def test_twin_takes_mono_1d():
    x = torch.as_tensor(_signal("noise", 3001, 1)[:, 0], dtype=torch.float32)
    got = lim.lookahead_limit_ref(x, FS)
    assert got.shape == x.shape
    assert torch.equal(got, _before_k10(x, FS))


@pytest.mark.parametrize("view", ["chain_rows", "padded_length"])
@pytest.mark.parametrize("v", [149, 4155, 9001])
def test_twin_on_the_chains_strided_views(view, v):
    """``forward_tracks`` hands each track over as ``xr[:, i, :v].T`` of
    its channel-major rows; ``scripts/quality_faults.padded_length``
    reads past it with ``as_strided``.  Both give the bits of the same
    frames made contiguous."""
    tracks, m = 3, 9216
    rows = torch.as_tensor(np.stack([_signal("noise", m, 1, seed=s)[:, 0]
                                     for s in range(2 * tracks)]),
                           dtype=torch.float32).reshape(2, tracks, m)
    x = rows[:, 1, :v].T
    if view == "padded_length":
        x = x.as_strided((m, 2), x.stride(), x.storage_offset())
    assert not x.is_contiguous()
    got = lim.lookahead_limit_ref(x, FS)
    assert torch.equal(got, _before_k10(x, FS))
    assert torch.equal(got, lim.lookahead_limit_ref(x.contiguous(), FS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_takes_the_twin_and_launches_nothing(dtype):
    x = torch.as_tensor(_signal("noise", 5000, 2), dtype=dtype)
    cmb.reset_launch_counts()
    y = lim.lookahead_limiter(x, FS)
    assert cmb.plain_calls()["lookahead_limit_ref"] == 1
    assert cmb.launch_counts()["lookahead_limit"] == 0
    assert not any(cmb.launch_counts().values())
    assert torch.equal(y, _before_k10(x, FS))


def test_route_under_autograd_takes_the_twin():
    x = torch.as_tensor(_signal("noise", 3000, 2),
                        dtype=torch.float64).requires_grad_(True)
    cmb.reset_launch_counts()
    lim.lookahead_limiter(x, FS).sum().backward()
    assert cmb.plain_calls()["lookahead_limit_ref"] == 1
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_kernel_wrapper_refuses_the_cpu():
    x = torch.zeros((100, 2))
    with pytest.raises(ValueError, match="lookahead_limit: no kernel for "
                                         "device cpu"):
        k10.lookahead_limit(x, torch.zeros(128), FS)


def test_look_ahead_limit_is_the_kernels_and_the_chains():
    """K10's tile holds 4352 slots, 3·look of them halo: at most 1365
    frames of look-ahead (31 ms at 44.1 kHz), checked where the chain's
    configuration is; the plain route on the CPU takes any."""
    assert k10.MAX_LOOK == lim.MAX_LOOK == 1365
    assert k10.look_frames(FS, 30.0) <= k10.MAX_LOOK < k10.look_frames(
        FS, 31.0)
    x = torch.as_tensor(_signal("noise", 5000, 2), dtype=torch.float32)
    assert torch.equal(lim.lookahead_limiter(x, FS, lookahead_ms=40.0),
                       _before_k10(x, FS, lookahead_ms=40.0))
    quality = dataclasses.replace(ChainConfig.gpu_default(FS),
                                  limiter_mode="lookahead_truepeak")
    params = MasteringParams.from_settings({"lufs": -14.0})
    chain_mod.check_supported(params, quality)
    for fs in (96000, 192000, 768000):
        chain_mod.check_supported(
            params, dataclasses.replace(quality, sample_rate=fs))
    with pytest.raises(ValueError, match="over the kernel's 1365 frames"):
        chain_mod.check_supported(
            params, dataclasses.replace(quality, sample_rate=1_000_000))


def test_forward_tracks_quality_output_unchanged(monkeypatch):
    """The album path in quality mode on the CPU: each track limited to its
    own end through the route (the twin, once a track), bit for bit the
    output with the limiter as it was before K10."""
    cfg = dataclasses.replace(ChainConfig.gpu_default(FS),
                              limiter_mode="lookahead_truepeak")
    params = MasteringParams.from_settings(
        {"saturation": 20, "preset": "techno", "width": 1.3, "lufs": -8.0})
    lengths = [20000, 17000, 9001]
    batch = np.zeros((3, 20000, 2), np.float32)
    for i, v in enumerate(lengths):
        batch[i, :v] = make_signal(v, fs=FS, seed=70 + i) * 0.7
    chain = MasteringChain(cfg)
    cmb.reset_launch_counts()
    y, measured, _ = chain.forward_tracks(torch.from_numpy(batch), params,
                                          lengths)
    assert cmb.plain_calls()["lookahead_limit_ref"] == 3
    assert cmb.launch_counts()["lookahead_limit"] == 0
    monkeypatch.setattr(chain_mod, "lookahead_limiter", _before_k10)
    y0, measured0, _ = chain.forward_tracks(torch.from_numpy(batch), params,
                                            lengths)
    assert torch.equal(y, y0) and torch.equal(measured, measured0)
    assert not y[2, 9001:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_release_with_rho_zero_keeps_no_memory(dtype):
    """``rho`` = 0 (a release so short that ``exp`` underflows): ``u[i] =
    max(1 − t[i], 0)``, so the gain is its target where the recurrence
    gives it, and the carried gain is not read."""
    t = torch.as_tensor(np.random.default_rng(3).random(700) * 0.9 + 0.1,
                        dtype=dtype)
    t[::7] = 1.0
    got = lim._release_scan(t, 0.0)
    t64 = t.double()
    want = torch.minimum(t64, 1.0 - torch.clamp_min(1.0 - t64, 0.0))
    assert torch.equal(got, want.to(dtype))
    assert torch.equal(lim._release_scan(t, 0.0, g0=0.25), got)
    assert lim._rho(FS, 1e-6) == 0.0
    x = torch.as_tensor(_signal("noise", 4000, 2), dtype=dtype)
    y = lim.lookahead_limiter(x, FS, release_ms=1e-6)
    gain = lim._limiter_gain(x, FS, -1.0, 1.5, True)
    assert torch.equal(y, x * lim._release_scan(gain, 0.0)[:, None])
    # the gain returns at once: never under the 60 ms release's (but for
    # a rounding of the closed form's log and exp), often over it
    rise = y.abs() - lim.lookahead_limiter(x, FS).abs()
    assert rise.min() >= -1e-6 * x.abs().max() and rise.max() > 1e-2


_C_TYPES = {"int": _kernels._I, "float": _kernels._F, "double": _kernels._D,
            "long long": _kernels._LL}


def _c_entries():
    """``{name: [parameter type, ...]}`` of every ``extern "C"`` entry in
    the port's CUDA sources."""
    out = {}
    for src in sorted(Path(_kernels._SRC_DIR).glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (pam_\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            out[m.group(1)] = [
                _kernels._P if "*" in p else _C_TYPES[
                    re.sub(r"^const ", "", p).rsplit(" ", 1)[0]]
                for p in params]
    return out


_ENTRIES = _c_entries()


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_kernel_entry_matches_its_ctypes_signature(name):
    """Each entry's parameters, pointer, ``int``, ``long long``,
    ``float`` or ``double`` in order, are those ``_kernels`` declares for
    ``ctypes`` (a pointer or a 64-bit integer passed as a 32-bit one is
    cut; a ``double`` passed as a ``float`` is misread)."""
    assert _kernels._SIGNATURES[name] == _ENTRIES[name]


def test_every_ctypes_signature_has_its_entry():
    assert set(_kernels._SIGNATURES) == set(_ENTRIES)
    assert "pam_lookahead_limit" in _ENTRIES
    assert len(_ENTRIES["pam_lookahead_limit"]) == 16
