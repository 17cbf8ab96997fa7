"""The comparison that decides ``correct`` fails what it must fail.

Each test drives the rest of a run on the CPU, at a size a test run can
hold (the port's plain path, albums of the cell's own 12 tracks, each
2-4 s long, 4-10 s in chunks of 6.4 s for the streamed job, and the
cell's own number of checked tracks), with the
harness's look for a card skipped: a sound run comes out correct, and
with the timed path broken underneath (``bench_port.faults``: half of the
album's tracks left out, every output 0.05 dB loud, the limiter skipped,
the band gains left out, the streamed job's carried state dropped at
every chunk boundary) it does not.  One chip serves each cell, so no
exchange between chips can be left out.  The control, the reference
computed in TF32, has to fail the cell's limits too."""

import dataclasses
import math

import numpy as np
import pytest

from bench_port import correctness, faults, registry, traffic
from bench_port import run as bench_run
from bench_port.tests import job_cell

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]] + [
    job_cell.NAME]
TINY = {"albums": 2, "length_s": [2, 4], "pad_multiple_s": 1,
        "trace_albums": 2}
# the streamed job's chunk rounds down to 6.4 s at 44.1 kHz: longer tracks
# cross a chunk boundary
TINY_STREAMED = {"length_s": [4, 10], "chunk_seconds": 1}
SEED = 2 ** 31 + 77


def tiny(cell):
    c = job_cell.load(cell)
    more = TINY_STREAMED if "chunk_seconds" in c.traffic else {}
    return dataclasses.replace(c, traffic={**c.traffic, **TINY, **more})


CELL_FAULTS = [(c, f) for c in CELLS
               for f in faults.faults_for(job_cell.load(c).traffic)]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = bench_run.run_cell(tiny(cell), SEED, 0.5, False, device="cpu")
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert {m["name"] for m in tiny(cell).end_to_end} == set(res["metrics"])


@pytest.mark.parametrize("cell,fault", CELL_FAULTS,
                         ids=[f"{c}-{f}" for c, f in CELL_FAULTS])
def test_fault_is_not_correct(cell, fault):
    res = bench_run.run_cell(tiny(cell), SEED, 0.5, False, device="cpu",
                             wrap=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct(cell):
    res = bench_run.run_cell(tiny(cell), SEED + 1, 0.5, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == TINY["trace_albums"]
    assert "busy_s" in res["device"] and "breakdown" in res


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference in TF32, put in the program's place, reads over at
    least one of the cell's limits on each of three seeds."""
    c = tiny(cell)
    prog = bench_run.Program(c, SEED, "cpu")
    chain = prog.chain_for_reference()
    for k, plan in enumerate(prog.plans[:1]):
        for i, n in enumerate(plan.lengths[:3]):
            xi = prog.entry.track_in(prog.batches[k], i, n)
            r = correctness.track_readings(
                xi, xi, plan.settings, chain, control=True,
                reference=prog.reference, wire=prog.wire)["control"]
            assert any(r[k2] > lim for k2, lim in c.limits.items()), r


def test_readings_of_a_broken_output():
    ref = np.full((1000, 2), 0.1)
    assert correctness.readings(ref, ref, 44100)["rms_err"] == 0.0
    bad = ref.copy()
    bad[3, 0] = math.nan
    assert correctness.readings(bad, ref, 44100)["max_err"] == math.inf


def test_reservoir_and_picks_follow_the_seed():
    picks = [correctness.pick_tracks([5, 9, 7, 1], 2, s) for s in range(20)]
    assert all(p[0] == 1 for p in picks) and len({tuple(p) for p in picks}) > 1
    r1, r2 = correctness.Reservoir(3), correctness.Reservoir(3)
    for i in range(50):
        r1.offer(i)
        r2.offer(i)
    assert r1.item == r2.item


@pytest.mark.parametrize("cell", CELLS)
def test_picks_meet_both_halves(cell):
    """At the cell's own album and number of checked tracks, every seed
    checks the longest track and a track of each half of the album."""
    c = job_cell.load(cell)
    k = int(c.traffic["check_tracks"])
    for plan in traffic.schedule(c.traffic, 44100, SEED):
        n = len(plan.lengths)
        for s in range(200):
            p = correctness.pick_tracks(plan.lengths, k, SEED + s)
            assert len(set(p)) == len(p) == min(k, n)
            assert p[0] == int(np.argmax(plan.lengths))
            assert min(p) < n // 2 <= max(p)
