"""The trace reader's arithmetic on a made-up timeline."""

import numpy as np

from bench_port import device_trace


def ctx(names, starts, durs, launches, host=()):
    hn = [h[0] for h in host]
    hs = np.array([h[1] for h in host], dtype=np.float64)
    hd = np.array([h[2] for h in host], dtype=np.float64)
    return device_trace.TraceContext(
        albums=2, window_s=100e-9, names=list(names),
        starts=np.array(starts, dtype=np.float64),
        durs=np.array(durs, dtype=np.float64), host_names=hn,
        host_starts=hs, host_durs=hd, launches=launches, host_syncs=None,
        shape=[])


def test_busy_is_the_union():
    c = ctx(["a", "b", "c"], [0, 5, 40], [10, 10, 10], {})
    assert c.busy_s == 25e-9      # [0, 15) and [40, 50)


def test_kernel_time_scales_to_the_launches_made():
    c = ctx(["void pam::front_chain_kernel<4>(x)", "k"], [0, 20], [8, 4],
            {"front_chain": 2.0})
    # one launch seen of four made: its mean times two a call
    assert c.kernel_ms(["front_chain"]) == 16e-6
    assert any("short" in n for n in c.notes)
    assert ctx(["k"], [0], [4], {"front_chain": 1.0}).kernel_ms(
        ["front_chain"]) is None
    assert c.kernel_ms(["band_energies"]) is None


def test_plain_time_and_gaps():
    host = [("bench_port.album", 0, 100), ("aten::copy_", 30, 20),
            ("cudaLaunchKernel", 1, 1), ("cudaLaunchKernel", 12, 1)]
    c = ctx(["pam::kweight_cells_kernel", "elementwise", "Memcpy DtoD"],
            [0, 10, 60], [10, 10, 5], {"kweight_cells": 0.5}, host)
    assert c.plain_ms() == 15e-6 / 2
    gaps = dict((k, v) for k, v in c.idle_gaps((0, 100)))
    assert gaps["aten::copy_"] == 40e-9
    assert gaps["host: between recorded operations"] == 35e-9
    assert c.device_ops()[0] == ["pam::kweight_cells_kernel", 10e-9]


def test_copy_time_by_direction():
    """The wire metrics' readers: the copies of each direction summed,
    per album; none of a direction reads nothing."""
    from bench_port import registry

    c = ctx(["Memcpy HtoD (Pageable -> Device)", "k",
             "Memcpy DtoH (Device -> Pinned)", "Memcpy HtoD (Pinned -> Device)"],
            [0, 10, 20, 30], [6e6, 1e6, 2e6, 4e6], {})
    assert c.copy_ms("HtoD") == 5.0 and c.copy_ms("DtoH") == 1.0
    assert registry.metric("wire.h2d_ms").read(c) == 5.0
    assert registry.metric("wire.d2h_ms").read(c) == 1.0
    assert ctx(["k"], [0], [4], {}).copy_ms("DtoH") is None
