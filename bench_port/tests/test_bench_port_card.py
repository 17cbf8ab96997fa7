"""One short run of each cell on the card, as the benchmark's command
runs it: exit 0, correct, the metrics the cell names, the card named.
Skips without a CUDA device.  On the card:

    python3 -m pytest bench_port/tests/test_bench_port_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

from bench_port import registry

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(registry.HERE / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 1234), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=900,
        cwd=str(registry.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    c = registry.cell(cell)
    want = (set(c.per_layer) if trace else
            {m["name"] for m in c.end_to_end})
    assert want == set(res["metrics"])
