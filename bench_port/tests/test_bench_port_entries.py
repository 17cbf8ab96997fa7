"""The entry a traffic mix names, the reference a configuration names, and
the pcm16 wire's rounding in the comparison, on the CPU at a small size.

A mix without ``entry`` runs the album on the card as it always has; the
streamed album job takes host tracks on the pcm16 grid and returns host
outputs, as ``master_album_streamed`` does when called by hand; the
reference's output is rounded as the port's wire rounds; a configuration
routes the check to the reference it names and a missing one fails."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from bench_port import correctness, registry, traffic
from bench_port import run as bench_run
from bench_port.reference import chain as ref_chain
from bench_port.tests import job_cell

SEED = 2 ** 31 + 4242
STREAMED = job_cell.NAME
ON_CARD = [w["name"] for w in registry.load_benchmark()["workloads"]
           if "entry" not in registry.cell(w["name"]).traffic]
TINY = {"albums": 1, "tracks_per_album": 4, "length_s": [4, 10],
        "pad_multiple_s": 1, "chunk_seconds": 1}


def tiny(name):
    c = job_cell.load(name)
    return dataclasses.replace(c, traffic={**c.traffic, **TINY})


@pytest.mark.parametrize("cell", ON_CARD)
def test_entry_absent_is_the_album_on_the_card(cell):
    """The three accepted cells name no entry and run the album on the
    card: the rendered batch as the input, the padded album's frames as
    the roofline's, and the chain fields the reference read before."""
    c = tiny(cell)
    assert registry.entry(c.traffic).__name__.endswith("album_on_card")
    assert "reference" not in c.config
    prog = bench_run.Program(c, SEED, "cpu")
    plan = prog.plans[0]
    assert torch.equal(prog.batches[0],
                       traffic.render(plan, prog.fs, prog.channels, "cpu"))
    assert prog.frames(0) == plan.frames
    y = prog.call(0)
    assert tuple(y.shape) == tuple(prog.batches[0].shape)
    chain = prog.chain_for_reference()
    cfg = prog.config
    assert (chain["variant"], chain["sample_rate"], chain["comp_hop"],
            chain["limiter_threshold"]) == (cfg.variant, cfg.sample_rate,
                                            cfg.comp_hop,
                                            cfg.limiter_threshold)


def test_streamed_entry_is_the_album_job():
    """Host tracks on the pcm16 grid in, host outputs on it out, the same
    as ``master_album_streamed`` called by hand with the mix's options,
    and the meters with them."""
    from python_audio_mastering_tpu_torch.parallel.batch import (
        master_album_streamed,
    )

    c = tiny(STREAMED)
    prog = bench_run.Program(c, SEED, "cpu")
    plan, x = prog.plans[0], prog.batches[0]
    assert [t.shape for t in x] == [(n, 2) for n in plan.lengths]
    for t in x:
        assert t.dtype == np.float32
        assert np.array_equal(np.round(t * 32767.0) / np.float32(32767.0), t)
    outs, measured, meters = prog.call(0)
    want = master_album_streamed(x, prog.params[0], prog.config,
                                 transfer="pcm16", chunk_seconds=1,
                                 return_meters=True, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(outs, want[0]))
    assert len(meters) == len(plan.lengths) and "true_peak_dbtp" in meters[0]
    for i, n in enumerate(plan.lengths):
        y = prog.entry.track_out((outs, measured, meters), i, n)
        assert y.shape == (n, 2)
        assert np.array_equal(correctness.round_pcm16(y), y)
    # chunks of 6.4 s, the longest track's whole
    chunk = 6.4 * 44100
    assert prog.frames(0) == math.ceil(max(plan.lengths) / chunk) * chunk


def test_streamed_frames_are_the_runners_chunks():
    """The roofline's frames for the streamed job, at the cell's own
    sizes: the port's chunk (30 s rounded down to 25.6 s) times the
    chunks of the longest track, 408.75 s: 16."""
    from python_audio_mastering_tpu_torch import ChainConfig
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        default_chunk_frames,
    )

    c = job_cell.cell()
    chunk = default_chunk_frames(ChainConfig(**c.config["chain"]),
                                 c.traffic["chunk_seconds"])
    assert chunk == 1128960
    entry = registry.entry(c.traffic)
    for plan in traffic.schedule(c.traffic, 44100, SEED):
        assert entry.frames(plan, c.config, c.traffic) == 16 * chunk


def test_round_pcm16_is_the_wires():
    """The comparison's rounding against the port's requantization on
    the device and its dequantization on the host: random values, ±1,
    the half steps and overs."""
    from python_audio_mastering_tpu_torch.parallel.streaming import (
        dequantize_pcm16_host,
        requantize_pcm16,
    )

    rng = np.random.default_rng(7)
    k = np.arange(-40, 40, dtype=np.float32)
    y = np.concatenate([
        rng.uniform(-1.2, 1.2, 100_000).astype(np.float32),
        np.array([1.0, -1.0, 1.0001, -1.0001, 1.5, -1.5, 0.0, 2.0, -2.0],
                 np.float32),
        (k + 0.5) / np.float32(32767.0), k / np.float32(32767.0)])
    wire = dequantize_pcm16_host(requantize_pcm16(torch.from_numpy(y))
                                 .numpy())
    assert np.array_equal(correctness.round_pcm16(y), wire)
    assert correctness.round_pcm16(np.float32([-2.0]))[0] == np.float32(
        -32768.0 / 32767.0)


def test_pcm16_wire_rounds_the_reference():
    """With the pcm16 wire the reference's output is compared rounded:
    the rounded reference itself reads 0, and the unrounded one reads
    over nothing but the rounding."""
    c = tiny(STREAMED)
    prog = bench_run.Program(c, SEED, "cpu")
    plan = prog.plans[0]
    n = plan.lengths[0]
    x = prog.entry.track_in(prog.batches[0], 0, n)
    chain = prog.chain_for_reference()
    ref, _, _ = ref_chain.master_track(x, plan.settings, chain)
    rounded = correctness.round_pcm16(ref)
    r = correctness.track_readings(x, rounded, plan.settings, chain,
                                   wire="pcm16")["program"]
    assert r["rms_err"] == 0.0 and r["max_err"] == 0.0
    r = correctness.track_readings(x, ref, plan.settings, chain,
                                   wire="pcm16")["program"]
    assert 0.0 < r["max_err"] <= 0.5 / 32767.0 + 2e-7
    with pytest.raises(ValueError):
        correctness.track_readings(x, ref, plan.settings, chain, wire="mp3")


def test_missing_reference_raises():
    c = registry.cell(ON_CARD[0])
    bad = dataclasses.replace(c, config={**c.config, "reference": "nope"})
    with pytest.raises(KeyError):
        registry.reference(bad.config)
    with pytest.raises(KeyError):
        bench_run.Program(bad, SEED, "cpu")


def test_reference_refuses_another_limiter():
    x = np.zeros((44100, 2))
    chain = dict(registry.cell(ON_CARD[0]).config["chain"],
                 limiter_mode="lookahead_truepeak")
    with pytest.raises(ValueError, match="limiter_mode"):
        ref_chain.master_track(x, {"lufs": -14.0}, chain)


def test_named_reference_routes_the_check(tmp_path, monkeypatch):
    """A configuration naming ``"reference": "probe"`` is judged against
    ``reference/probe.py``: here a reference that returns its input, so
    the input itself reads 0."""
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "probe.py").write_text(
        "import numpy as np\n"
        "def master_track(x, settings, chain, precision='float64'):\n"
        "    y = np.asarray(x, np.float64)\n"
        "    return y, float('nan'), y\n")
    monkeypatch.setattr(registry, "HERE", tmp_path)
    config = {"reference": "probe", "chain": {"sample_rate": 44100}}
    assert registry.reference(config).__file__.endswith("probe.py")
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (44100, 2))
    r = correctness.track_readings(x, x, {}, config["chain"],
                                   reference=registry.reference_name(config))
    assert r["program"]["rms_err"] == 0.0
