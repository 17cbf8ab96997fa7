"""Everything a cell is made of, found by name from ``BENCHMARK.json``.

* a configuration: the JSON file its entry names (``file``), whose
  ``chain`` holds the port's ``ChainConfig`` fields and whose optional
  ``reference`` names its plain reference, ``reference/<name>.py``
  (``chain`` when absent);
* a traffic mix: ``traffic/<traffic>.json`` (read by ``traffic``), whose
  optional ``entry`` names the program's entry it drives,
  ``entries/<name>.py`` (``album_on_card`` when absent);
* a cell's correctness limits: ``cells/<cell>.json``;
* a per-layer metric: ``metrics/<metric>.py``, declaring ``NAME``,
  ``UNIT``, ``LAYER``, ``MOVES`` and ``read(ctx)``;
* a kernel's roofline count: ``rooflines/<kernel>.py``, declaring
  ``LAUNCHES`` (the port's launch-counter names) and ``count(shape)``.

Adding any of them is adding a file and an entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "load_benchmark", "cell", "load_module", "metric",
           "roofline", "reference", "entry", "ROOT", "HERE"]

DEFAULT_REFERENCE = "chain"
DEFAULT_ENTRY = "album_on_card"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict         # the configuration file's contents
    traffic: dict        # the traffic mix's contents
    limits: dict         # {number: limit}
    per_layer: tuple     # the per-layer metric names this cell reports
    end_to_end: tuple    # the end-to-end metric entries it reports


def _read(path):
    return json.loads(Path(path).read_text())


def load_benchmark(root=ROOT):
    return _read(Path(root) / "BENCHMARK.json")


def _applies(entry, cell_name):
    return "workloads" not in entry or cell_name in entry["workloads"]


def cell(name, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded;
    ``KeyError`` for a name the benchmark does not hold."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_read(Path(root) / conf["file"]),
        traffic=_read(HERE / "traffic" / f"{work['traffic']}.json"),
        limits=_read(HERE / "cells" / f"{name}.json")["limits"],
        per_layer=tuple(m["name"] for m in bench["per_layer"]
                        if _applies(m, name)),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)))


@functools.cache
def load_module(kind, name):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name):
    return load_module("metrics", name)


def roofline(name):
    return load_module("rooflines", name)


def reference(config):
    """The plain reference module a configuration names; ``KeyError`` for
    one that ``reference/`` does not hold."""
    return load_module("reference", reference_name(config))


def reference_name(config):
    return config.get("reference", DEFAULT_REFERENCE)


def entry(traffic):
    """The entry module a traffic mix names; ``KeyError`` for one that
    ``entries/`` does not hold."""
    return load_module("entries", traffic.get("entry", DEFAULT_ENTRY))
