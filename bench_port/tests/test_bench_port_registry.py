"""Every name in BENCHMARK.json resolves to its files, and every entry
keeps to the benchmark contract's characters and keys."""

import json
import re

import pytest

from bench_port import registry
from bench_port.tests import job_cell

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("cell", CELLS + [job_cell.NAME])
def test_cell_resolves(cell):
    c = job_cell.load(cell)
    assert c.chips == 1
    assert {"chain", "channels"} <= set(c.config)
    for key in ("albums", "content_seed", "tracks_per_album", "length_s",
                "materials",
                "presets", "settings", "check_tracks", "trace_albums"):
        assert key in c.traffic
    assert c.limits and set(c.limits) <= {"rms_err", "med_err", "max_err",
                                          "lufs_err"}
    assert callable(registry.entry(c.traffic).build)
    assert callable(registry.reference(c.config).master_track)
    assert c.per_layer, "every cell reports a per-layer metric"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "audio_rtf"}


@pytest.mark.parametrize("name", METRICS)
def test_metric_module_matches_its_entry(name):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[name]
    mod = registry.metric(name)
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    assert callable(mod.read)
    if name.endswith(".roofline_pct"):
        roof = registry.roofline(name[:-len(".roofline_pct")])
        assert roof.LAUNCHES and callable(roof.count)


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e) - {"workloads"} == (
            {"name", "unit", "better", "bound", "source"}
            if "bound" in e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert len(json.dumps(BENCH)) < 64 * 1024
