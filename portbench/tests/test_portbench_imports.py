"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmarks (top-level module names compared whole: the port's name begins
with the JAX package's), the reference imports nothing of the port, and a
run without a card exits non-zero with no result."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.helpers import ROOT

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))
PORT = "dynamicfuion_python_tpu_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not {name.split(".")[0] for name in _imports(path)} & set(harness.FORBIDDEN)


def test_the_reference_and_the_yardstick_import_nothing_of_the_port():
    for path in SOURCES:
        part = path.relative_to(ROOT / "portbench").parts[0]
        if part in ("reference", "traffic", "counts", "check", "weights.py"):
            assert not any(n.split(".")[0] == PORT for n in _imports(path)), path


def test_top_level_names_are_compared_whole():
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert harness.FORBIDDEN[3] == "dynamicfuion_python_tpu" and PORT.startswith(harness.FORBIDDEN[3])


def test_a_run_loads_no_forbidden_module():
    """A whole training run on the CPU (tiny sizes), then the process's
    modules."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness\n"
        "from portbench.tests.helpers import tiny_run\n"
        "harness.run_cell(tiny_run('train.solver448', 5))\n"
        "print(harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fusion.bend480", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fusion.bend480", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
