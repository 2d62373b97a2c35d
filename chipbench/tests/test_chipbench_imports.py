"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
the reference imports nothing of the program, and nothing reads the JAX
package's old harness."""
import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_old_harness(path):
    assert "benchmarks" not in path.read_text()


def test_reference_imports_nothing_of_the_program():
    for mod in ("reference.py", "harness.py", "work.py"):
        tops = {m.split(".")[0] for m in imported(HERE / mod)}
        assert "repro_torch" not in tops, mod


def test_forbidden_names_are_whole():
    from chipbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torchx"] = sys.modules["sys"]
        sys.modules["jaxfoo.bar"] = sys.modules["sys"]
        assert harness.forbidden_modules() == []
        sys.modules["repro.conv"] = sys.modules["sys"]
        assert harness.forbidden_modules() == ["repro.conv"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A whole (small, host) run in a fresh process: afterwards nothing of
    JAX or ``repro`` is loaded."""
    code = (
        "import sys, json; sys.path[:0] = ['chipbench/tests']\n"
        "from conftest import shrink\n"
        "import torch\n"
        "from chipbench import harness, run\n"
        "cell, cfg = shrink(*harness.load_cell('vgg16-t1.infer-b64'))\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "run.execute(cell, cfg, bench, seed=3, seconds=0.2, trace=0,\n"
        "            device=torch.device('cpu'))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card the command fails and prints no result line."""
    out = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "vgg16-t1.infer-b64", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_fail(tmp_path):
    """In a directory that holds only BENCHMARK.json and chipbench/, the
    command fails and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "vgg16-t1.infer-b64", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
