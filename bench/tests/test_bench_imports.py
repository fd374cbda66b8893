"""What the harness and the reference import: never JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference nothing of the port."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from ._cells import ROOT, harness

SOURCES = sorted(p for p in (ROOT / "bench").rglob("*.py")
                 if "tests" not in p.relative_to(ROOT / "bench").parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in top_level_imports(path)


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded_after("import bench.reference.inputs, "
                           "bench.reference.direct")
    assert not set(loaded) & set(harness.FORBIDDEN)
    assert "repro_torch" not in loaded


def test_the_harness_drivers_and_readers_load_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = "from bench import harness, tracing\n" + "".join(
        f"harness.driver_class({w['traffic']!r})\n"
        for w in bench["workloads"]) + "".join(
        f"harness.reader({m['name']!r})\n"
        for m in bench["end_to_end"] + bench["per_layer"])
    assert not set(_loaded_after(code)) & set(harness.FORBIDDEN)


def _run_py(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "f64-uniform-solve",
         "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(cwd),
             "CUDA_VISIBLE_DEVICES": ""})


def test_run_exits_nonzero_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and ``bench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
