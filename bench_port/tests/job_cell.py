"""The streamed album job's cell, built from its files.  Its traffic mix
(``traffic/album_job_stream.json``), its limits
(``cells/worker_gpu_default.album_job_stream.json``) and its entry
(``entries/album_job_streamed.py``) are in place; ``BENCHMARK.json`` does
not hold it, since its runs spread wider than any bound (PERF.md §7).
Its configuration is the worker's, as ``worker_gpu_default.album12_mb``
runs it."""

import dataclasses
import json

from bench_port import registry

NAME = "worker_gpu_default.album_job_stream"
TRAFFIC = "album_job_stream"
LIKE = "worker_gpu_default.album12_mb"     # the cell of the same config


def cell():
    base = registry.cell(LIKE)
    return dataclasses.replace(
        base, name=NAME,
        traffic=json.loads((registry.HERE / "traffic" / f"{TRAFFIC}.json")
                           .read_text()),
        limits=json.loads((registry.HERE / "cells" / f"{NAME}.json")
                          .read_text())["limits"])


def load(name):
    """``registry.cell(name)``, or the job's cell by its name."""
    return cell() if name == NAME else registry.cell(name)
