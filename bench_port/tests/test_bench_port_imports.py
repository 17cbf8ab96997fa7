"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port.  Top-level module names
are compared whole, so that ``python_audio_mastering_tpu_torch`` is not
taken for the JAX package ``python_audio_mastering_tpu``."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "python_audio_mastering_tpu"}
PORT = "python_audio_mastering_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def top_levels(path):
    """Every imported module's top-level name in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("python_audio_mastering_tpu")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax_import(path):
    assert not top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_levels(path)
    assert PORT not in names and "torch" not in names
    assert names <= {"__future__", "math", "numpy", "scipy"}


def test_run_loads_no_jax():
    """The harness and the port together, in a fresh process, leave no
    JAX module behind."""
    code = ("import sys; sys.path.insert(0, %r); import bench_port.run as r; "
            "r.import_port(); import bench_port.calibrate; "
            "print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refused_without_the_port(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files
    under ``paths``, the harness finds no port of its checkout and
    refuses to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys; sys.path.insert(0, %r); import bench_port.run as r; "
            "r.import_port()" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and "RunRefused" in out.stderr
