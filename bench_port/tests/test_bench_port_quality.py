"""The quality cell (``worker_quality.album12_loud``): its plain reference
(``reference/worker_quality.py``) against the port and against its own
definition, the faults of the lookahead limiter that its check has to
fail, and the readers of its per-layer metrics.

The program runs on the CPU at the size ``test_bench_port_correct.py``
gives every cell (albums of the cell's 12 tracks, 2-4 s each, padded to
whole seconds); the faults are ``scripts/quality_faults.py``'s, planted by
monkeypatching under the album entry."""

import importlib.util
import math

import numpy as np
import pytest
import torch

from bench_port import correctness, device_trace, peaks, registry, traffic
from bench_port import run as bench_run
from bench_port.reference import worker_quality as wq
from bench_port.tests.test_bench_port_correct import SEED, tiny

CELL = "worker_quality.album12_loud"
FS = 44100


def _faults():
    path = registry.ROOT / "scripts" / "quality_faults.py"
    spec = importlib.util.spec_from_file_location("quality_faults", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QF = _faults()


@pytest.fixture(scope="module")
def album():
    """The tiny cell's first album through the program, and every track's
    ``(input, output, settings)`` on the host."""
    prog = bench_run.Program(tiny(CELL), SEED, "cpu")
    y = prog.call(0)
    return prog, prog.track_items(0, y, range(len(prog.plans[0].lengths)))


def test_reference_is_the_configurations():
    cell = registry.cell(CELL)
    assert registry.reference_name(cell.config) == "worker_quality"
    assert registry.reference(cell.config).__file__ == wq.__file__
    with pytest.raises(ValueError, match="lookahead"):
        wq.master_track(np.zeros((FS, 2)), {"lufs": -8.0},
                        {**cell.config["chain"], "limiter_mode": "reference"})


def test_program_matches_the_reference(album):
    """Every track of the album against the float64 reference.  The
    program's signal is float32 (the front's K1 and K4 on their plain
    twins here, the limiter's interpolator a float32 product): a few
    dozen float32 roundings of a signal near full scale, ~1e-6 at most
    (measured 1.0e-6 max, 3.3e-7 RMS over the reference's RMS); the
    limits leave 10x room and stay under the cell's own."""
    prog, items = album
    chain = prog.chain_for_reference()
    for x, y, settings in items:
        ref, measured, alt = wq.master_track(x, settings, chain)
        assert alt is ref and math.isfinite(measured)
        r = correctness.readings(y, ref, FS)
        assert r["max_err"] <= 1e-5, r
        assert r["rms_err"] <= 3e-6, r


def test_limiter_matches_the_ports_in_float64():
    """On seeded noise the port's limiter in float64 and the reference's
    compute the same sums in other orders (a direct FIR against a banded
    product, a loop against a prefix max in the log domain): measured
    1.3e-11; the limit leaves 100x room."""
    from python_audio_mastering_tpu_torch.ops.limiter import (
        lookahead_limiter,
    )

    x = np.random.default_rng(2026).standard_normal((2 * FS, 2)) * 0.5
    got = lookahead_limiter(torch.from_numpy(x), FS).numpy()
    assert np.abs(got - wq.limit(x, FS)).max() <= 1e-9


def test_reference_output_true_peak_under_the_ceiling(album):
    """The reference's own interpolator reads its output at −1 dBTP or
    under, within 0.01 dB: the limiter caps each position's interpolated
    peak of the input times the gain there, and the gain moves inside
    the interpolator's 32-tap window, so the output's interpolated peak
    can sit a little over the ceiling (measured up to 0.0012 dB over at
    this size).  The loud tracks reach the ceiling."""
    prog, items = album
    chain = prog.chain_for_reference()
    tps = [wq.true_peak(wq.master_track(x, s, chain)[0])
           for x, _, s in items]
    assert max(tps) <= wq.CEILING_DB + 0.01, tps
    assert sum(tp > wq.CEILING_DB - 0.01 for tp in tps) >= len(tps) // 2


def test_release_loop_equals_the_closed_form():
    """``g[i] = min(a[i], 1 − (1 − g[i−1])·ρ)`` from ``g[−1] = 1`` is
    ``min(a[i], 1 − max_j≤i (1 − a[j])·ρ^(i−j))``."""
    rng = np.random.default_rng(7)
    a = np.minimum(1.0, 0.3 + rng.random(1500))
    rho = math.exp(-1.0 / 120.0)
    i = np.arange(a.size)
    decay = np.where(i[:, None] >= i[None, :],
                     rho ** (i[:, None] - i[None, :]).astype(np.float64), 0.0)
    closed = np.minimum(a, 1.0 - ((1.0 - a)[None, :] * decay).max(axis=1))
    np.testing.assert_allclose(wq.release(a, rho), closed, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("fault", ["sample_peak", "look_one",
                                   "instant_release"])
def test_fault_is_not_correct(fault):
    res = bench_run.run_cell(tiny(CELL), SEED, 0.5, False, device="cpu",
                             wrap=QF.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_padded_length_fails_where_a_track_ends_in_an_attack():
    """Limiting each track over the album's padded length changes only
    the samples whose moving average reaches past the track's end, and
    only where the attack, not the release, sets the gain there: on most
    tracks the output is the program's to the last bit.  Over the tiny
    cell's albums it fails the cell's limits on some tracks (3 of 24 at
    this seed), and the program on none."""
    cell = tiny(CELL)
    prog = bench_run.Program(cell, SEED, "cpu")
    chain = prog.chain_for_reference()
    failed = 0
    for k, plan in enumerate(prog.plans):
        good = prog.track_items(k, prog.call(k), range(len(plan.lengths)))
        bad = prog.track_items(k, QF.padded_length(prog.fn)(
            prog.batches[k], prog.params[k], plan.lengths),
            range(len(plan.lengths)))
        for (x, y, s), (_, yf, _) in zip(good, bad):
            r = correctness.track_readings(x, y, s, chain,
                                           faults={"padded": yf},
                                           reference=prog.reference)
            over = {m: lim for m, lim in cell.limits.items()
                    if r["padded"][m] > lim}
            assert not any(r["program"][m] > lim
                           for m, lim in cell.limits.items()), r
            failed += bool(over)
    assert failed >= 1


def test_album_frames_are_the_tracks_own():
    cell = registry.cell(CELL)
    entry = registry.entry(cell.traffic)
    for plan in traffic.schedule(cell.traffic, FS, SEED):
        assert entry.frames(plan, cell.config, cell.traffic) == round(
            sum(plan.lengths) / 12)
        assert plan.frames == 420 * FS and plan.settings["lufs"] == -8.0


# ------------------------------------------------------------- metrics

# (name, start ns, duration ns): one album, the limiter's spans nested
HOST = [
    ("bench_port.window", 0, 1000),
    ("pam.chain", 10, 900),
    ("pam.chain/loudness", 20, 80),
    ("aten::sum", 30, 10),
    ("cudaLaunchKernel", 32, 2),
    ("pam.chain/limiter", 100, 700),
    ("pam.chain/limiter/truepeak", 110, 200),
    ("aten::mm", 120, 20),
    ("cudaLaunchKernel", 125, 2),
    ("pam.chain/limiter/attack", 320, 200),
    ("aten::minimum", 330, 20),
    ("cudaLaunchKernel", 335, 2),
    ("pam.chain/limiter/release", 530, 200),
    ("aten::cummax", 540, 20),
    ("cudaLaunchKernel", 545, 2),
    ("aten::mul", 740, 20),
    ("cudaLaunchKernel", 745, 2),
]
DEVICE = [("sum", 40, 10), ("gemm", 130, 300), ("min", 440, 100),
          ("cummax", 560, 200), ("mul", 770, 40)]
SHAPE = {"tracks": 12, "channels": 2, "frames": 285 * FS}


def ctx(host=HOST):
    return device_trace.TraceContext(
        albums=1, window_s=1000e-9, names=[d[0] for d in DEVICE],
        starts=np.array([d[1] for d in DEVICE], dtype=np.float64),
        durs=np.array([d[2] for d in DEVICE], dtype=np.float64),
        host_names=[h[0] for h in host],
        host_starts=np.array([h[1] for h in host], dtype=np.float64),
        host_durs=np.array([h[2] for h in host], dtype=np.float64),
        launches={}, host_syncs=6.0, shape=[SHAPE])


METRICS = {"plain_torch.truepeak_ms": 300e-6,
           "plain_torch.attack_ms": 100e-6,
           "plain_torch.release_ms": 200e-6}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_stage_metric_reads_its_span(name):
    assert registry.metric(name).read(ctx()) == pytest.approx(METRICS[name])


def test_bound_is_the_count_over_the_limiters_time():
    flops, n_bytes = registry.roofline("lookahead").count(SHAPE)
    samples = 12 * 285 * FS * 2
    assert n_bytes == 8 * samples
    assert flops == 256 * samples + 12 * samples // 2
    seconds, by = peaks.bound_seconds(flops, n_bytes)
    assert by == "arithmetic"
    limiter_ms = (300 + 100 + 200 + 40) * 1e-6
    got = registry.metric("lookahead.bound_pct").read(ctx())
    assert got == pytest.approx(100.0 * seconds * 1e3 / limiter_ms)


@pytest.mark.parametrize("name", sorted(METRICS) + ["lookahead.bound_pct"])
def test_no_reading_without_the_spans(name):
    """A program that opens no stage span inside its limiter (the one the
    cell was added under) gives no reading, and nothing raises."""
    host = [h for h in HOST if not h[0].startswith("pam.chain/limiter/")]
    assert registry.metric(name).read(ctx(host)) is None


@pytest.mark.parametrize("name", sorted(METRICS) + ["lookahead.bound_pct"])
def test_metric_entry_names_the_cell(name):
    entry = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}[
        name]
    assert entry["workloads"] == [CELL] and entry["layer"] == (
        "lookahead limiter")
