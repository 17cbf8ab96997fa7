"""The exact filter path (``filter_method``) against the JAX package, on
the same numpy-seeded inputs, on the CPU (the scan kernel's plain version,
``ops.sos_scan.sos_scan_ref``).

JAX runs its own row-major body (``lax.scan`` filters) with
``comp_ballistics="scan"``: its row-major ``_run_ballistics`` has no
interpret switch for the Pallas kernel.  Limits:

* ``sosfilt_scan`` in float64 against JAX's (under x64) and against
  ``scipy.signal.sosfilt``: 1e-12 of the max (measured 0 against scipy);
  in float32, its distance from the float64 filter (of the float32
  coefficients and input) at most twice JAX's own float32 distance, or
  1e-6 of the max: the two float32 scans round differently (XLA's
  compiled loop is not K8's operation order), each ~1e-6 to 6e-5 of the
  max from float64 on the chain's filters (the K-weighting's slow poles
  the most), so they cannot agree to 1e-6 of each other; a split run
  bitwise the whole, and the K8 plain version run on several filters at
  once bitwise the same filters one by one;
* ``sosfilt_blocked`` against JAX's at ``N % L != 0``: 2e-5 of the max
  (test_pallas_multiband.py:44), the final states too; ``sosfilt``
  bitwise the function JAX's rule picks;
* ``master()``, ``master_streamed``, ``master_album_streamed`` and
  ``comp_hop`` 5 at block 384: < 2e-4 max abs and < 1e-3 LU (the JAX
  kernels-vs-XLA chain budget, test_pallas_multiband.py:269);
* the automaster's loss and θ gradient under the scan (float32) against
  ``jax.value_and_grad``: 1e-4 of each one's max abs.

Signals are at most 0.5 s: the plain scan walks one sample a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from python_audio_mastering_tpu import ChainConfig as JConfig
from python_audio_mastering_tpu import MasteringParams as JParams
from python_audio_mastering_tpu import master as jmaster
from python_audio_mastering_tpu.models import automaster as jam
from python_audio_mastering_tpu.ops import iir as jiir
from python_audio_mastering_tpu.parallel import batch as jbatch
from python_audio_mastering_tpu.parallel import streaming as jstream
from python_audio_mastering_tpu_torch import MasteringChain, convert, master
from python_audio_mastering_tpu_torch.models import automaster as am
from python_audio_mastering_tpu_torch.models.chain import apply_eq
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops import sos_scan as k8
from python_audio_mastering_tpu_torch.ops.loudness import kweight_sos
from python_audio_mastering_tpu_torch.parallel import batch, streaming

from .conftest import make_signal

FS = 44100
FS48 = 48000      # streamed: 0.2 s chunks are whole 384-sample blocks
SECONDS = 0.42    # one 400 ms gating block: the loudness is finite
SETTINGS = {"saturation": 20, "preset": "techno", "width": 1.3,
            "lufs": -14.0}
MB_SETTINGS = {**SETTINGS, "multiband": True}
SOS = ss.butter(4, [300.0, 3000.0], "bandpass", fs=FS, output="sos")  # 4


def _signal(seconds, seed=0, fs=FS, scale=0.5):
    return (make_signal(int(fs * seconds), fs=fs, seed=seed)
            * scale).astype(np.float32)


def _budget(what, got, want, lu_got=None, lu_want=None):
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    msg = f"{what}: max abs {d:.3e}"
    ok = d < 2e-4
    if lu_got is not None:
        # a track shorter than one gating block measures -inf on both sides
        d_lu = (0.0 if float(lu_got) == float(lu_want)
                else abs(float(lu_got) - float(lu_want)))
        msg += f", |dLU| {d_lu:.3e}"
        ok = ok and d_lu < 1e-3
    print(msg)
    assert ok, msg


# ---------------------------------------------------------------------------
# The scan filter and its dispatch
# ---------------------------------------------------------------------------


FILTERS = {"bandpass": SOS, "kweight": kweight_sos(FS)}


def _scipy(sos, x, zi):
    k = sos.shape[0]
    if x.ndim == 1:
        return ss.sosfilt(sos, x, zi=np.zeros((k, 2)) if zi is None else zi)
    return ss.sosfilt(sos, x, axis=0,
                      zi=np.zeros((k, 2, x.shape[1])) if zi is None else zi)


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("with_zi", [False, True])
def test_sosfilt_scan_matches_jax_and_scipy(filt, shape, with_zi):
    """float64 against JAX ``sosfilt_scan`` and scipy; float32 against
    the float64 filter beside JAX's float32; a split run equal to the
    whole, bitwise."""
    sos = FILTERS[filt]
    k = sos.shape[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 2)) * 0.3
    zi = rng.standard_normal((k, 2, 2)) * 0.1 if with_zi else None
    if shape == "1d":
        x, zi = x[:, 0], None if zi is None else zi[:, :, 0]
    tz = None if zi is None else torch.from_numpy(zi)

    y64, z64 = iir.sosfilt_scan(sos, torch.from_numpy(x), tz)
    ref, zref = _scipy(sos, x, zi)
    scale = float(np.abs(ref).max())
    assert y64.shape == ref.shape and z64.shape == zref.shape
    assert float(np.abs(y64.numpy() - ref).max()) <= 1e-12 * scale
    assert float(np.abs(z64.numpy() - zref).max()) <= 1e-12 * scale
    with jax.enable_x64(True):
        jy, jz = jiir.sosfilt_scan(sos, jnp.asarray(x), None if zi is None
                                   else jnp.asarray(zi))
        assert float(np.abs(y64.numpy() - np.asarray(jy)).max()) <= \
            1e-12 * scale
        assert float(np.abs(z64.numpy() - np.asarray(jz)).max()) <= \
            1e-12 * scale

    x32 = x.astype(np.float32)
    z32i = None if zi is None else zi.astype(np.float32)
    y32, z32 = iir.sosfilt_scan(sos, torch.from_numpy(x32), None
                                if z32i is None else torch.from_numpy(z32i))
    jy, jz = jiir.sosfilt_scan(sos, jnp.asarray(x32), None if z32i is None
                               else jnp.asarray(z32i))
    exact, zexact = _scipy(sos.astype(np.float32).astype(np.float64),
                           x32.astype(np.float64),
                           None if z32i is None else z32i.astype(np.float64))
    for got, want, truth in ((y32.numpy(), np.asarray(jy), exact),
                             (z32.numpy(), np.asarray(jz), zexact)):
        err, jerr = (float(np.abs(v - truth).max()) for v in (got, want))
        print(f"{filt} {shape} zi={with_zi}: float32 port {err:.2e}, JAX "
              f"{jerr:.2e} from float64 (max {scale:.2e})")
        assert err <= max(2.0 * jerr, 1e-6 * scale)

    cut = 1234
    xt = torch.from_numpy(x)
    ya, za = iir.sosfilt_scan(sos, xt[:cut], tz)
    yb, zb = iir.sosfilt_scan(sos, xt[cut:], za)
    assert torch.equal(torch.cat([ya, yb]), y64) and torch.equal(zb, z64)


def test_scan_twin_several_filters_and_valid_lengths():
    """One call of F cascades equals F calls of one, bitwise; a column's
    final state is taken after its own valid length; the recorded
    sections end in the output."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 2000)))
    lp, hp = (ss.butter(4, 500.0, b, fs=FS, output="sos")
              for b in ("lowpass", "highpass"))
    both, zfs = k8.sos_scan_ref(x, [lp, SOS, hp], n_valid=[2000, 700, 0])
    for f, sos in enumerate((lp, SOS, hp)):
        one, _ = k8.sos_scan_ref(x, [sos])
        assert torch.equal(both[f], one[0])
        _, z700 = ss.sosfilt(sos, x[1, :700].numpy(),
                             zi=np.zeros((sos.shape[0], 2)))
        assert np.abs(zfs[f][:, :, 1].numpy() - z700).max() <= 1e-12
        assert torch.equal(zfs[f][:, :, 2], torch.zeros_like(
            zfs[f][:, :, 2]))
    rec = k8._sections(x, k8._as_sos(SOS, x), x.new_zeros((4, 2, 3)))
    assert torch.equal(rec[-1], both[1])


def test_scan_gradient_is_the_adjoint():
    """The autograd rule (K8 again, over the reversed gradient) against
    finite differences, in float64, for the input, the initial state and
    the coefficients."""
    torch.manual_seed(0)
    sos = torch.tensor(SOS, requires_grad=True)
    x = torch.randn(2, 40, dtype=torch.float64, requires_grad=True)
    zi = (torch.randn(4, 2, 2, dtype=torch.float64) * 0.1).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, s, z: k8.sos_scan(a, [s], [z])[0][0], (x, sos, zi),
        atol=1e-8)


def test_sosfilt_blocked_and_dispatch_match_jax():
    """``sosfilt_blocked`` at N % L != 0 against JAX's, and
    ``sosfilt_blocked_multi`` bitwise it filter by filter; ``sosfilt``'s
    choice (the scan below 4 · block_size) JAX's."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3001, 2)) * 0.3).astype(np.float32)
    zi = (rng.standard_normal((4, 2, 2)) * 0.1).astype(np.float32)
    xt, zt = torch.from_numpy(x), torch.from_numpy(zi)
    scale = float(np.abs(x).max())

    def close(got, want):
        assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) \
            <= 2e-5 * scale

    y, zf = iir.sosfilt_blocked(SOS, xt, zt, block_size=512)
    jy, jz = jiir.sosfilt_blocked(SOS, jnp.asarray(x), jnp.asarray(zi),
                                  block_size=512)
    close(y, jy)
    close(zf, jz)
    lp = ss.butter(4, 250.0, fs=FS, output="sos")
    ys, zfs = iir.sosfilt_blocked_multi((lp, SOS), xt, (None, zt))
    assert torch.equal(ys[1], y) and torch.equal(zfs[1], zf)
    assert torch.equal(ys[0], iir.sosfilt_blocked(lp, xt)[0])
    x64, z64 = torch.from_numpy(x.astype(np.float64)), zt.double()
    for n, method in ((1500, "auto"), (3001, "auto")):
        scans = iir.uses_scan(method, n)
        assert scans == (method == "scan" or (method == "auto" and n < 2048))
        y, zf = iir.sosfilt(SOS, x64[:n], z64, method=method)
        same = (iir.sosfilt_scan(SOS, x64[:n], z64) if scans
                else iir.sosfilt_blocked(SOS, x64[:n], z64))
        assert torch.equal(y, same[0]) and torch.equal(zf, same[1])


def test_apply_eq_matches_jax():
    """``apply_eq`` (scan and blocked) against JAX's."""
    x = _signal(0.1, seed=4)
    jp, p = JParams.from_settings(SETTINGS), convert.params_from_jax(
        JParams.from_settings(SETTINGS))
    for method in ("scan", "blocked"):
        jcfg = JConfig(filter_method=method)
        y, zf = apply_eq(torch.from_numpy(x), p, convert.config_from_jax(jcfg))
        jy, jz = jax.jit(lambda a: jchain_apply_eq(a, jp, jcfg))(x)
        assert float(np.abs(y.numpy() - jy).max()) <= 2e-5
        assert float(np.abs(zf.numpy() - jz).max()) <= 2e-5


def jchain_apply_eq(x, params, config):
    from python_audio_mastering_tpu.models import chain as jchain

    return jchain.apply_eq(x, params, config)


@pytest.mark.parametrize("variant", ["worker", "legacy"])
@pytest.mark.parametrize("method", ["auto", "scan", "blocked"])
@pytest.mark.parametrize("n", [1000, 1800, 3000, 40000])
def test_stage_scans_follow_jax(variant, method, n):
    """The port's per-stage choice is the JAX package's: its rows body
    (``channel_major``) scans nothing; its row-major body scans the EQ by
    ``sosfilt`` at the config's block and the crossovers and K-weighting
    at 512."""
    jcfg = JConfig(variant=variant, filter_method=method, block_size=384)
    chain = MasteringChain(convert.config_from_jax(jcfg))
    if jcfg.channel_major(n):
        want = (False, False, False)
    else:
        eq = method == "scan" or (method == "auto" and n < 4 * 384)
        fixed = method == "scan" or (method == "auto" and n < 4 * 512)
        want = (eq, fixed, fixed)
    assert chain.stage_scans(n) == want
    assert chain.config.channel_major(n) == jcfg.channel_major(n)


# ---------------------------------------------------------------------------
# The chain under the scan
# ---------------------------------------------------------------------------

MASTER_CASES = {
    # name: (JAX config kwargs, settings, seconds)
    "worker_off": (dict(filter_method="scan"), SETTINGS, SECONDS),
    "worker_on_hop1": (dict(filter_method="scan"), MB_SETTINGS, SECONDS),
    "worker_on_hop8": (dict(filter_method="scan", comp_hop=8), MB_SETTINGS,
                       SECONDS),
    "legacy_off": (dict(variant="legacy", filter_method="scan", comp_hop=8),
                   SETTINGS, SECONDS),
    "legacy_on_hop8": (dict(variant="legacy", filter_method="scan",
                            comp_hop=8), MB_SETTINGS, SECONDS),
    # JAX blocks the EQ (1800 >= 4 * 384) but scans the crossovers and the
    # K-weighting (1800 < 4 * 512)
    "legacy_1800_auto": (dict(variant="legacy", block_size=384,
                              filter_method="auto"), MB_SETTINGS,
                         1800 / FS),
}


@pytest.mark.parametrize("case", list(MASTER_CASES))
def test_master_scan_matches_jax(case):
    """``master()`` on the exact filter path against JAX ``master()``."""
    kw, settings, seconds = MASTER_CASES[case]
    jcfg = JConfig(comp_ballistics="scan", **kw)
    cfg = convert.config_from_jax(jcfg)
    x = _signal(seconds, seed=5)
    jp = JParams.from_settings(settings)
    want = _jax_master(x, jp, jcfg)
    got = master(x, convert.params_from_jax(jp), cfg, return_result=True,
                 device="cpu")
    lu = (got.measured_lufs, want.measured_lufs) if len(x) >= 0.4 * FS \
        else (None, None)
    _budget(f"master {case}", got.audio.numpy(), want.audio, *lu)


def _jax_master(x, jp, jcfg):
    return jax.jit(lambda a, p: jmaster(a, p, jcfg, return_result=True))(
        x, jp)


STREAM_CFG = dict(filter_method="scan", block_size=384)


@functools.lru_cache(maxsize=None)
def _stream_refs():
    """JAX's streamed and album runs on the exact filter path (computed
    once): 0.2 s chunks at 48 kHz."""
    jcfg = JConfig(sample_rate=FS48, comp_ballistics="scan", **STREAM_CFG)
    jp = JParams.from_settings(MB_SETTINGS)
    x = _signal(0.4, seed=6, fs=FS48)   # two chunks, one gating block
    one = jstream.master_streamed(x, jp, jcfg, chunk_seconds=0.2)
    tracks = [x, _signal(0.3, seed=7, fs=FS48)]
    album = jbatch.master_album_streamed(tracks, jp, jcfg, chunk_seconds=0.2)
    return jcfg, jp, x, tracks, one, album


def test_master_streamed_scan_matches_jax():
    """The scanned stream (every filter state carried exactly across
    chunks) against JAX's."""
    jcfg, jp, x, _, (jy, jlufs, _), _ = _stream_refs()
    cfg, p = convert.config_from_jax(jcfg), convert.params_from_jax(jp)
    msgs = []
    y, lufs, _ = streaming.master_streamed(x, p, cfg, chunk_seconds=0.2,
                                           progress_cb=msgs.append,
                                           device="cpu")
    assert sum("Processed chunk" in m for m in msgs) == 2
    _budget("master_streamed scan", y, jy, lufs, jlufs)


def test_master_album_streamed_scan_matches_jax():
    """Two tracks of their own lengths on the exact filter path against
    JAX's album."""
    jcfg, jp, _, tracks, _, (jouts, jmeasured) = _stream_refs()
    cfg, p = convert.config_from_jax(jcfg), convert.params_from_jax(jp)
    outs, measured = batch.master_album_streamed(tracks, p, cfg,
                                                 chunk_seconds=0.2,
                                                 device="cpu")
    for i, (a, b) in enumerate(zip(outs, jouts, strict=True)):
        assert a.shape == b.shape
        _budget(f"album track {i}", a, b, measured[i], jmeasured[i])


def test_comp_hop_not_dividing_the_block_matches_jax():
    """``comp_hop`` 5 at block 384 (the band kernels at hop 1, JAX's pad
    and reshape buckets) against JAX's rows body, one-shot and as a
    ``multiband_compress`` call."""
    jcfg = JConfig(block_size=384, comp_hop=5, filter_method="blocked",
                   comp_ballistics="scan")
    cfg = convert.config_from_jax(jcfg)
    x = _signal(0.8, seed=8)
    jp = JParams.from_settings(MB_SETTINGS)
    want = _jax_master(x, jp, jcfg)
    got = master(x, convert.params_from_jax(jp), cfg, return_result=True,
                 device="cpu")
    _budget("master comp_hop=5", got.audio.numpy(), want.audio,
            got.measured_lufs, want.measured_lufs)
    chain = MasteringChain(cfg)
    assert chain.stage_scans(x.shape[0]) == (False, False, False)


def test_automaster_scan_loss_and_gradient_match_jax():
    """The automaster's loss and θ gradient under the scan (float32)
    against JAX's ``jax.value_and_grad`` of its loss."""
    jcfg = JConfig(filter_method="scan")
    x = _signal(SECONDS, seed=9)
    target = np.asarray(jam.spectral_profile(jnp.asarray(x * 0.7), FS),
                        np.float32)
    theta = np.asarray([0.3, -0.2, 0.1, 0.25, -0.15, 0.05], np.float32)
    jm = jam.AutoMasterModel(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jnp.asarray(theta), jnp.asarray(x), jnp.asarray(target))
    m = am.AutoMasterModel(convert.config_from_jax(jcfg), device="cpu")
    th = torch.tensor(theta, requires_grad=True)
    loss = m.loss(th, x, target)
    loss.backward()
    jg = np.asarray(jg)
    loss = float(loss.detach())
    print(f"loss {loss:.6f} vs {float(jl):.6f}; grad "
          f"{th.grad.numpy()} vs {jg}")
    assert abs(loss - float(jl)) <= 1e-4 * abs(float(jl))
    assert float(np.abs(th.grad.numpy() - jg).max()) <= 1e-4 * np.abs(
        jg).max()


def test_scan_kernel_refuses_devices_without_one():
    """Neither CPU nor CUDA: no kernel, no silent fallback."""
    x = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k8.sos_scan(x, [SOS])


# ---------------------------------------------------------------------------
# The scan kernel's launch plan and tile split (its arithmetic in Python)
# ---------------------------------------------------------------------------

_ELEM = {torch.float32: 4, torch.float64: 8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", list(range(1, k8.SECTIONS_MAX + 1)))
def test_scan_launch_plan(k, dtype):
    """Tile, ring depth, warps and shared memory of every launch the
    kernel takes: a 4 KiB tile of whole 16-byte chunks, at least two slots
    a ring (the pipeline's phase parity), a walker warp a section and the
    producer and drainer, and ``k + 1`` rings of padded slots with their
    two mbarriers within the H100's 232 448 bytes a block."""
    plan = k8.launch_plan(k, dtype)
    elem = _ELEM[dtype]
    assert plan.tile * elem == 4096 and plan.tile % (16 // elem) == 0
    assert plan.depth >= 2 and plan.warps == k + 2
    slot = (plan.tile + 16 // elem) * elem
    assert slot % 16 == 0
    assert plan.smem_bytes == (k + 1) * plan.depth * (slot + 16)
    assert plan.smem_bytes <= 232448      # the H100's shared memory a block


def test_scan_launch_plan_refuses_what_the_kernel_cannot_take():
    for k, dtype in ((0, torch.float32), (k8.SECTIONS_MAX + 1, torch.float64),
                     (2, torch.float16)):
        with pytest.raises(ValueError, match="K8 takes"):
            k8.launch_plan(k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 1024, 1025, 2048, 5001,
                               3 * 1024 + 7])
def test_scan_tile_split(n, dtype):
    """The kernel's copies of a column of n samples at every offset from
    a 16-byte boundary: the tiles cover ``[0, n)`` in order, each once;
    a tile's body starts on a 16-byte boundary and is whole 16-byte
    chunks; its head and tail are under 16 bytes each unless the tile
    holds no aligned 16 bytes (then it is all head)."""
    elem = _ELEM[dtype]
    vec = 16 // elem
    tile = k8.launch_plan(1, dtype).tile
    for phase in range(vec):
        split = k8._tile_split(n, phase, dtype)
        assert len(split) == -(-n // tile)
        t = 0
        for i, (head, body, tail) in enumerate(split):
            assert head[0] == t == i * tile
            assert head[1] == body[0] and body[1] == tail[0]
            t = tail[1]
            assert t == min((i + 1) * tile, n)
            if body[1] > body[0]:
                assert (phase + body[0]) % vec == 0
                assert (body[1] - body[0]) % vec == 0
                assert head[1] - head[0] < vec and tail[1] - tail[0] < vec
            else:
                assert tail[1] - tail[0] == 0 and head[1] - head[0] < 2 * vec
        assert t == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_scan_twin_split_at_tile_edges(edge, dtype):
    """The plain version split at the kernel's tile edge (tile - 1, tile,
    tile + 1), the second part from the first's final state, and a final
    state taken there by the valid length: bitwise the whole run."""
    tile = k8.launch_plan(4, dtype).tile
    cut = tile + edge
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 2 * tile + 5)) * 0.3).to(
        dtype)
    zi = torch.from_numpy(rng.standard_normal((4, 2, 2)) * 0.1).to(dtype)
    whole, (zf,) = k8.sos_scan_ref(x, [SOS], [zi])
    first, (z_cut,) = k8.sos_scan_ref(x[:, :cut], [SOS], [zi])
    second, (z_end,) = k8.sos_scan_ref(x[:, cut:], [SOS], [z_cut])
    assert torch.equal(torch.cat([first, second], dim=2), whole)
    assert torch.equal(z_end, zf)
    at_cut, (z_nv,) = k8.sos_scan_ref(x, [SOS], [zi], n_valid=cut)
    assert torch.equal(at_cut, whole) and torch.equal(z_nv, z_cut)
