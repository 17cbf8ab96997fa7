"""K9 ``gain_limit``'s roofline count at the album's shape (12 stereo
tracks padded to 420 s at 44.1 kHz) against a sum done by hand: every
frame of every channel read once and written once (float32), the gains
read once, one operation a pointwise step of the worker limiter and one
for the gain; and its metric's module against its entry."""

import pytest

from bench_port import peaks, registry, roofline

T, C = 12, 2
N = 420 * 44100                # 18 522 000 frames a track
SAMPLES = T * N * C            # 444 528 000


def shape(lufs=True):
    cfg = registry.cell("worker_gpu_default.album12_mb").config
    return roofline.album_shape(cfg, N, T, C, True, lufs)


def test_counts_the_album_by_hand():
    flops, n_bytes = registry.roofline("k9_gain_limit").count(shape())
    assert n_bytes == 4 * C * T * N + 4 * T * N * C + 4 * T
    assert flops == SAMPLES * 13


def test_without_loudness_no_gain_is_read_or_applied():
    flops, n_bytes = registry.roofline("k9_gain_limit").count(shape(False))
    assert n_bytes == 8 * SAMPLES and flops == SAMPLES * 12


def test_bound_is_bytes_at_about_a_millisecond_an_album():
    seconds, by = peaks.bound_seconds(
        *registry.roofline("k9_gain_limit").count(shape()))
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(1.0615, abs=1e-3)


def test_metric_reads_its_kernel():
    entry = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}[
        "k9_gain_limit.roofline_pct"]
    mod = registry.metric("k9_gain_limit.roofline_pct")
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    assert registry.roofline("k9_gain_limit").LAUNCHES == ("gain_limit",)
    cells = {w["name"] for w in registry.load_benchmark()["workloads"]}
    assert set(entry["workloads"]) <= cells
    assert {"worker_gpu_default.album12_mb", "worker_gpu_default.album12_nomb",
            "monolith_legacy.album12_mb"} <= set(entry["workloads"])
