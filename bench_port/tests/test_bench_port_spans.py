"""The stage-span reader's arithmetic on a made-up record: two albums'
worth of one chain, its spans, the runtime calls inside its ops and the
activities they launched, linked by launch order."""

import numpy as np
import pytest

from bench_port import device_trace, registry, spans

# (name, start ns, duration ns)
HOST = [
    ("bench_port.window", 0, 2000),
    ("pam.chain", 100, 1500),
    ("aten::pad", 110, 30),
    ("cudaLaunchKernel", 115, 5),
    ("pam.chain/front", 200, 400),
    ("aten::mul", 210, 20),
    ("cudaLaunchKernel", 212, 3),
    ("pam.chain/front/states", 250, 100),
    ("aten::mm", 260, 20),
    ("cudaLaunchKernel", 265, 5),
    ("aten::to", 290, 30),
    ("cudaMemcpyAsync", 295, 5),
    ("cudaLaunchKernel", 400, 5),          # the port's, from ctypes
    ("pam.chain/multiband", 600, 400),
    ("pam.chain/multiband/detector", 700, 200),
    ("aten::sum", 710, 20),
    ("cudaLaunchKernel", 715, 5),
    ("aten::item", 800, 80),
    ("cudaMemcpyAsync", 805, 5),
    ("cudaStreamSynchronize", 812, 60),
    ("pam.chain/limiter", 1100, 200),
    ("aten::clamp", 1110, 20),
    ("cudaLaunchKernel", 1115, 5),
    ("aten::copy_", 1700, 20),              # the harness's, outside
    ("cudaMemcpyAsync", 1705, 5),
    ("cudaDeviceSynchronize", 1750, 100),
]
# (name, start ns, duration ns)
DEVICE = [
    ("fold", 200, 10),
    ("exciter", 260, 20),
    ("gemm", 300, 40),
    ("Memcpy HtoD (Pageable -> Device)", 345, 5),
    ("void pam::front_chain_kernel<4>(x)", 410, 100),
    ("reduce", 720, 30),
    ("Memcpy DtoH (Device -> Pageable)", 810, 5),
    ("clamp", 1120, 50),
    ("Memcpy DtoD (Device -> Device)", 1710, 10),
]
ORPHAN = ("orphan", 1180, 7)                  # launched by no runtime call
ALBUMS = 2
MS = 1e-6 / ALBUMS                            # ns over the record -> ms/album


def ctx(device=DEVICE, host=HOST):
    c = device_trace.TraceContext(
        albums=ALBUMS, window_s=2000e-9, names=[d[0] for d in device],
        starts=np.array([d[1] for d in device], dtype=np.float64),
        durs=np.array([d[2] for d in device], dtype=np.float64),
        host_names=[h[0] for h in host],
        host_starts=np.array([h[1] for h in host], dtype=np.float64),
        host_durs=np.array([h[2] for h in host], dtype=np.float64),
        launches={"front_chain": 1.0}, host_syncs=None, shape=[])
    return c


def test_stage_sums_are_each_spans_own():
    c = ctx()
    s = spans.split(c)
    want = {"chain": 10, "front": 20, "states": 45, "detector": 35,
            "limiter": 50}
    assert s.plain_ms == pytest.approx({k: v * MS for k, v in want.items()})
    assert spans.stage_ms(c, "multiband") == 0.0
    assert s.outside_plain_ms == pytest.approx(10 * MS)
    assert s.unattributed_ms == 0.0
    total = sum(s.plain_ms.values()) + s.outside_plain_ms
    assert total == pytest.approx(c.plain_ms())


def test_activity_without_launch_is_unattributed():
    c = ctx(device=DEVICE + [ORPHAN])
    s = spans.split(c)
    total = (sum(s.plain_ms.values()) + s.outside_plain_ms
             + s.unattributed_ms)
    assert total == pytest.approx(c.plain_ms())
    # six plain kernels, five launches: no kernel taken by order
    assert s.unattributed_ms == pytest.approx(
        (10 + 20 + 40 + 30 + 50 + 7) * MS)
    assert s.plain_ms["states"] == pytest.approx(5 * MS)   # the copy
    assert any("unattributed" in n for n in c.notes)


def test_syncs_are_read_inside_the_chain_only():
    s = spans.split(ctx())
    assert s.syncs == {"detector": 1 / ALBUMS}
    assert s.wait_ms == pytest.approx({"detector": 60 * MS})
    assert s.chain_syncs == 1 / ALBUMS
    assert s.chain_wait_ms == pytest.approx(60 * MS)
    assert s.chain_host_ms == pytest.approx(1500 * MS)


def test_idle_by_innermost_span():
    c = ctx()
    s = spans.split(c)
    want = {"chain": 500, "front": 190, "states": 35, "multiband": 200,
            "detector": 165, "limiter": 150}
    assert s.idle_ms == pytest.approx({k: v * MS for k, v in want.items()})
    assert s.outside_idle_ms == pytest.approx(490 * MS)
    idle = sum(s.idle_ms.values()) + s.outside_idle_ms
    assert idle == pytest.approx((2000e-9 - c.busy_s) * 1e3 / ALBUMS)


def test_one_note_a_run():
    c = ctx()
    first = spans.split(c)
    for name in NEW:
        registry.metric(name).read(c)
    assert spans.split(c) is first
    notes = [n for n in c.notes if n.startswith("stage spans")]
    assert len(notes) == 1
    assert "detector plain" in notes[0] and "outside the program" in notes[0]


def test_nothing_to_read_without_chain_spans_or_device():
    parent = [h for h in HOST if not h[0].startswith(spans.PROGRAM)]
    assert spans.split(ctx(host=parent)) is None
    assert spans.split(ctx(device=[])) is None
    for name in NEW:
        assert registry.metric(name).read(ctx(host=parent)) is None


NEW = ["plain_torch.fold_ms", "plain_torch.front_ms", "plain_torch.states_ms",
       "plain_torch.multiband_ms", "plain_torch.detector_ms",
       "plain_torch.loudness_ms", "plain_torch.limiter_ms",
       "chain.sync_wait_ms", "chain.host_issue_ms"]


def test_metrics_read_the_split():
    c = ctx()
    got = {n: registry.metric(n).read(c) for n in NEW}
    assert got == pytest.approx({
        "plain_torch.fold_ms": 10 * MS, "plain_torch.front_ms": 20 * MS,
        "plain_torch.states_ms": 45 * MS, "plain_torch.multiband_ms": 0.0,
        "plain_torch.detector_ms": 35 * MS, "plain_torch.loudness_ms": 0.0,
        "plain_torch.limiter_ms": 50 * MS,
        "chain.sync_wait_ms": 60 * MS,
        "chain.host_issue_ms": (1500 - 60) * MS})
    entries = {m["name"] for m in registry.load_benchmark()["per_layer"]}
    assert set(NEW) <= entries


STAGE = [n for n in NEW if n.startswith("plain_torch.")]


@pytest.mark.parametrize("lost", ["gemm", "Memcpy DtoH (Device -> Pageable)"])
@pytest.mark.parametrize("name", STAGE)
def test_lost_activity_reads_as_no_stage_reading(name, lost):
    """A window that lost one activity leaves its kind unlinked: the stage
    metrics read None, not 0; the host-side metrics still read."""
    c = ctx(device=[d for d in DEVICE if d[0] != lost])
    s = spans.split(c)
    assert s.unattributed_ms > spans.UNATTRIBUTED * c.plain_ms()
    assert registry.metric(name).read(c) is None
    assert registry.metric("chain.sync_wait_ms").read(c) == pytest.approx(
        60 * MS)
