"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), the plain
references import nothing of the program, and a run without a card
prints no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gangbench import run as bench_run
from gangbench.harness import catalog

JAX = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in catalog.BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(catalog.ROOT)) for p in FILES])
def test_no_jax_and_references_free_of_the_program(path):
    names = top_level_imports(path)
    assert not names & JAX, names & JAX
    if "reference" in path.parts:
        assert "repro_torch" not in names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.fake", object())
    assert bench_run.forbidden_modules() == [] or all(
        n.split(".")[0] in JAX for n in bench_run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in bench_run.forbidden_modules()


def _copy_of_benchmark(tmp_path):
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH_DIR, tmp_path / "gangbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.mark.parametrize("with_program", [True, False])
def test_run_without_a_card_prints_no_result(tmp_path, with_program):
    root = _copy_of_benchmark(tmp_path)
    if with_program:
        os.symlink(catalog.ROOT / "src", root / "src")
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "gangbench/run.py", "--workload",
         "olmoe-1b-7b.serve.long_prompt", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=root, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
