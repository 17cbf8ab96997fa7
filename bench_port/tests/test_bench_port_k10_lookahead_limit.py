"""K10 ``lookahead_limit``'s roofline count and metric: the count is the
lookahead limiter's own (``rooflines/lookahead.count``), read and not
copied, at the quality cell's shape; the share reads None where the
traced window holds no launch of the kernel (a program that runs the
limiter's plain stages, as the parent of K10 does) and the count's bound
over the kernel's device time where it holds them; the metric module
matches its ``BENCHMARK.json`` entry."""

import numpy as np
import pytest

from bench_port import device_trace, peaks, registry

FS = 44100
CELL = "worker_quality.album12_loud"
SHAPE = {"tracks": 12, "channels": 2, "frames": 285 * FS}
NAME = "k10_lookahead_limit.roofline_pct"


def ctx(launches, names, durs):
    return device_trace.TraceContext(
        albums=1, window_s=1e-3, names=names,
        starts=np.arange(len(names), dtype=np.float64) * 1e5,
        durs=np.asarray(durs, dtype=np.float64), host_names=[],
        host_starts=np.zeros(0), host_durs=np.zeros(0), launches=launches,
        host_syncs=6.0, shape=[SHAPE])


@pytest.mark.parametrize("shape", [SHAPE, {"tracks": 1, "channels": 1,
                                           "frames": 4155}])
def test_count_is_the_limiters(shape):
    k10 = registry.roofline("k10_lookahead_limit")
    assert k10.count(shape) == registry.roofline("lookahead").count(shape)
    assert k10.count.__module__ == "bench_port.rooflines.lookahead"
    t, c, n = shape["tracks"], shape["channels"], shape["frames"]
    assert k10.count(shape) == (256 * c * t * n + 12 * t * n, 8 * c * t * n)


def test_no_launch_no_reading():
    """The parent's trace of the quality cell: the limiter's plain
    kernels, no K10 launch counted or seen."""
    plain = ctx({"front_chain": 1.0, "kweight_cells": 1.0},
                ["void pam::front_chain_kernel<...>", "gemm", "reduce_kernel"],
                [1e5, 6e6, 11e6])
    assert registry.metric(NAME).read(plain) is None
    counted_unseen = ctx({"lookahead_limit": 12.0}, ["gemm"], [1e6])
    assert registry.metric(NAME).read(counted_unseen) is None


def test_share_is_the_bound_over_the_kernels_time():
    names = [f"void pam::lookahead_limit_kernel<true>(float const*, ...) #{i}"
             for i in range(12)] + ["void pam::kweight_cells_kernel(...)"]
    durs = [200e3] * 12 + [100e3]              # 0.2 ms a track
    got = registry.metric(NAME).read(ctx({"lookahead_limit": 12.0,
                                          "kweight_cells": 1.0}, names, durs))
    seconds, by = peaks.bound_seconds(
        *registry.roofline("lookahead").count(SHAPE))
    assert by == "arithmetic"
    assert got == pytest.approx(100.0 * seconds * 1e3 / 2.4)


def test_metric_reads_its_kernel():
    entry = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}[
        NAME]
    mod = registry.metric(NAME)
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    assert (entry["source"], entry["better"]) == ("device_trace", "higher")
    assert entry["workloads"] == [CELL]
    assert registry.roofline("k10_lookahead_limit").LAUNCHES == (
        "lookahead_limit",)
