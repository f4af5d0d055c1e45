"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``.

A configuration is ``gangbench/configs/<name>.json``, a traffic mix
``gangbench/traffic/<name>.json``, a per-layer metric's reader
``gangbench/metrics/<name>.py``, a family's plain reference
``gangbench/reference/<name>.py`` (named by the configuration's
``reference`` key) and a driver of the program's entry points
``gangbench/drivers/<name>.py`` (named by the traffic's ``driver`` key). A
later change adds a cell, a mix or a metric by adding such a file and an
entry; nothing here names one.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "gangbench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_data(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The data file ``<bench_dir>/<kind>/<name>.json``."""
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    return path


def read_data(path: Path) -> Any:
    return json.loads(path.read_text())


def load_data(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Any:
    return read_data(find_data(kind, name, bench_dir))


def load_module(kind: str, name: str,
                bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py`` as a module, loaded once a file."""
    path = (bench_dir / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    mod_name = "gangbench_part_" + hashlib.sha1(
        str(path).encode()).hexdigest()[:16]
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those with no ``workloads`` key and those that list
    it."""
    return [m for m in bench[section]
            if cell in m.get("workloads", (cell,))]


def config_of(bench: dict, name: str) -> Optional[dict]:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    return None
