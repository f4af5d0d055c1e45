"""The port's copy of the gang executor, and the port's import rules.

The three executor tests are those of tests/test_serving_executor.py, run
against ``repro_torch.core.executor``. The guards check that the port and
``chip_smoke.py`` import neither JAX nor the JAX package ``repro``.
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.core.executor import BEJob, GangExecutor, RTJob

ROOT = Path(__file__).resolve().parents[1]


def test_executor_one_gang_at_a_time():
    """Two RT jobs at different priorities never hold lanes concurrently."""
    ex = GangExecutor(n_lanes=4, regulation_interval_s=0.01)
    overlap = []

    running = set()

    def mk_fn(name, dur):
        def fn(lane, idx):
            running.add(name)
            if len({n for n in running}) > 1:
                overlap.append(tuple(running))
            time.sleep(dur)
            running.discard(name)
        return fn

    ex.submit_rt(RTJob("hi", mk_fn("hi", 0.002), lanes=(0, 1), prio=9,
                       period_s=0.02, n_jobs=20))
    ex.submit_rt(RTJob("lo", mk_fn("lo", 0.004), lanes=(2, 3), prio=1,
                       period_s=0.03, n_jobs=15))
    stats = ex.run(1.2)
    assert len(overlap) == 0, overlap
    assert len(stats["response_times"]["hi"]) >= 10
    assert ex.sched.check_invariant()


def test_executor_throttles_best_effort():
    """BE quanta admitted only within the running gang's byte budget."""
    def busy(lane, idx):
        time.sleep(0.004)

    def be_quantum(lane):
        time.sleep(0.0005)

    results = {}
    for budget in (0.0, 1e9):
        ex = GangExecutor(n_lanes=2, regulation_interval_s=0.01)
        ex.submit_rt(RTJob("rt", busy, lanes=(0,), prio=5, period_s=0.005,
                           budget_bytes=budget, n_jobs=100))
        ex.submit_be(BEJob("be", be_quantum, lanes=(1,),
                           bytes_per_quantum=1000.0))
        stats = ex.run(0.8)
        results[budget] = stats["be_quanta"]["be"]
    assert results[0.0] < results[1e9] * 0.2, results


def test_executor_records_stragglers():
    slow = {"n": 0}

    def fn(lane, idx):
        slow["n"] += 1
        time.sleep(0.05 if slow["n"] == 10 else 0.001)

    ex = GangExecutor(n_lanes=1, straggler_factor=5.0)
    ex.submit_rt(RTJob("j", fn, lanes=(0,), prio=5, period_s=0.005,
                       n_jobs=20))
    ex.run(0.6)
    assert any(s[0] == "j" for s in ex.stragglers)


GUARD = """
import importlib, pkgutil, sys
import repro_torch, repro_torch.launch.serve, chip_smoke
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax", "jaxlib")
             or m.startswith("jax"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)"
                     r"|from\s+repro(\.|\s))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
