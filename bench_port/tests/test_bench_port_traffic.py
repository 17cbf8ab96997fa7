"""The traffic generator: one seed, one traffic; another seed, another
order and other signals over the same lengths."""

import dataclasses

import torch

from bench_port import registry, traffic

FS = 8000
TINY = {"albums": 3, "tracks_per_album": 4, "length_s": [1, 2],
        "pad_multiple_s": 1}


def tiny(mix="album12_mb"):
    return {**registry.cell(f"worker_gpu_default.{mix}").traffic, **TINY}


def test_same_seed_same_traffic():
    t = tiny()
    a, b = traffic.schedule(t, FS, 2 ** 31 + 11), traffic.schedule(
        t, FS, 2 ** 31 + 11)
    assert a == b
    for pa, pb in zip(a, b):
        assert torch.equal(traffic.render(pa, FS, 2, "cpu"),
                           traffic.render(pb, FS, 2, "cpu"))


def test_other_seed_same_albums_in_another_order():
    t = tiny()
    a, b = traffic.schedule(t, FS, 5), traffic.schedule(t, FS, 6)
    assert a != b
    assert sorted(a, key=repr) == sorted(b, key=repr)
    other = {**t, "content_seed": t["content_seed"] + 1}
    c = traffic.schedule(other, FS, 5)
    assert all(sorted(pa.lengths) == sorted(pc.lengths)
               for pa, pc in zip(a, c))
    xa, xc = (traffic.render(p, FS, 2, "cpu") for p in (a[0], c[0]))
    assert not torch.equal(xa, xc)


def test_album_shape_and_padding():
    t = tiny()
    for plan in traffic.schedule(t, FS, 9):
        x = traffic.render(plan, FS, 2, "cpu")
        assert x.shape == (4, plan.frames, 2) and plan.frames % FS == 0
        assert plan.frames >= max(plan.lengths)
        for i, n in enumerate(plan.lengths):
            assert torch.all(x[i, n:] == 0) and x[i, :n].abs().max() > 0.05
        kinds = sorted(tr.material for tr in plan.tracks)
        assert kinds == sorted(t["materials"])


def test_full_schedule_is_the_stratified_lengths():
    t = registry.cell("worker_gpu_default.album12_mb").traffic
    plans = traffic.schedule(t, 44100, 2 ** 31 + 3)
    want = [round((150 + 270 * (i + 0.5) / 12) * 44100) for i in range(12)]
    for p in plans:
        assert sorted(p.lengths) == want and p.frames == 420 * 44100
        assert p.settings["preset"] in t["presets"]
    assert dataclasses.asdict(plans[0])["settings"]["saturation"] == 20
