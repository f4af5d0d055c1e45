"""The port's virtual-gang grid (``repro_torch.vgang.grid``) and
schedulability sweep (``repro_torch.launch.sweep``) against the JAX
package's, on the arguments of tests/test_vgang.py and on the seeded
smoke configs; their default outputs; the dry-run mode's dispatch of its
cells; and the torch RTA backend of the grid, which runs on
torch or raises.

Rows are compared whole except their wall-clock fields.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import sweep as jax_sweep  # noqa: E402
from repro.vgang import grid as jax_grid  # noqa: E402

from repro_torch.analysis import batched_rta  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.vgang import grid  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "experiments")
WALL = ("wall_s", "wall_rta_s", "wall_s_total")


def rows_of(out):
    return [{k: v for k, v in r.items() if k not in WALL}
            for r in out["results" if "results" in out else "rows"]]


def curve_rows(out_dir):
    """{file name: rows} of a grid's curve files."""
    with open(os.path.join(out_dir, "summary.json")) as f:
        files = json.load(f)["files"]
    got = {}
    for rel in files:
        with open(os.path.join(out_dir, os.path.basename(rel))) as f:
            got[os.path.basename(rel)] = [
                {k: v for k, v in r.items() if k not in WALL}
                for r in json.load(f)["rows"]]
    return got


# the run_grid arguments of tests/test_vgang.py
GRID_CASES = [
    dict(cores=(4,), dists=("mixed",), utils=(0.8, 2.4),
         heuristics=("ffd", "intfaware"), n_per_cell=4, sim_check=1,
         processes=1, seed=3),
    dict(cores=(4,), dists=("mixed",), utils=(0.8,),
         heuristics=("rtgang", "ffd"), n_per_cell=2, sim_check=0,
         processes=1),
    dict(cores=(4,), dists=("mixed",), utils=(0.8, 1.2),
         heuristics=("intfaware", "rtgT"), n_per_cell=6, sim_check=2,
         processes=1, seed=1),
]


@pytest.mark.parametrize("kw", GRID_CASES)
def test_run_grid_rows_equal_jax(kw, tmp_path):
    got = grid.run_grid(out_dir=str(tmp_path / "port"), **kw)
    want = jax_grid.run_grid(out_dir=str(tmp_path / "jax"), **kw)
    assert rows_of(got) == rows_of(want)
    assert got["summary"]["heuristics"] == want["summary"]["heuristics"]
    assert got["summary"]["soundness_violations"] == 0


def test_run_grid_rejects_unknown_column(tmp_path):
    with pytest.raises(ValueError, match="unknown policy column"):
        grid.run_grid(cores=(4,), dists=("mixed",), utils=(0.8,),
                      heuristics=("nope",), n_per_cell=1, sim_check=0,
                      processes=1, out_dir=str(tmp_path))


@pytest.mark.parametrize("config", ["grid_smoke.json",
                                    "grid_part_smoke.json"])
def test_grid_main_on_smoke_config_equals_jax(config, tmp_path):
    path = os.path.join(CONFIGS, config)
    port, jax = tmp_path / "port", tmp_path / "jax"
    # in process: no pool forked from a process that holds JAX's threads
    assert grid.main(["--config", path, "--out", str(port),
                      "--procs", "1"]) == 0
    assert jax_grid.main(["--config", path, "--out", str(jax),
                          "--procs", "1"]) == 0
    got, want = curve_rows(port), curve_rows(jax)
    assert got == want and got


def test_grid_torch_backend_on_cpu_equals_numpy(tmp_path):
    """--backend torch --device cpu runs the float64 torch backend (its
    call counter moves) and gives numpy's rows; the environment it set
    for the run is restored."""
    path = os.path.join(CONFIGS, "grid_smoke.json")
    before = batched_rta.torch_calls
    assert grid.main(["--config", path, "--out", str(tmp_path / "t"),
                      "--backend", "torch", "--device", "cpu"]) == 0
    assert batched_rta.torch_calls > before
    assert "REPRO_RTA_BACKEND" not in os.environ
    assert "REPRO_RTA_DEVICE" not in os.environ
    calls = batched_rta.torch_calls
    assert grid.main(["--config", path, "--out", str(tmp_path / "n"),
                      "--backend", "numpy", "--procs", "1"]) == 0
    assert batched_rta.torch_calls == calls
    assert curve_rows(tmp_path / "t") == curve_rows(tmp_path / "n")


def test_grid_torch_backend_without_card_raises(monkeypatch, tmp_path):
    """Asked for torch on the card where there is none, the grid raises
    instead of carrying on in numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        grid.main(["--config", os.path.join(CONFIGS, "grid_smoke.json"),
                   "--out", str(tmp_path), "--backend", "torch"])
    assert not os.listdir(tmp_path)


def test_default_outputs_leave_the_jax_artifacts_alone():
    results = os.path.join(ROOT, "results")
    assert grid.OUT_DEFAULT == os.path.join(results, "vgang_torch")
    assert sweep.SWEEP_OUT_DEFAULT == os.path.join(
        results, "sched_sweep_torch.json")
    assert sweep.OUT == os.path.join(results, "dryrun_torch")
    for p in (grid.OUT_DEFAULT, sweep.SWEEP_OUT_DEFAULT, sweep.OUT):
        assert p not in (jax_grid.OUT_DEFAULT, jax_sweep.OUT,
                         os.path.join(results, "sched_sweep.json"))
    # grid_16c.json and sweep.json name no output: the defaults apply
    for name in ("grid_16c.json", "sweep.json"):
        with open(os.path.join(CONFIGS, name)) as f:
            assert json.load(f)["output"]["out"] is None


def test_sweep_dry_run_mode_dispatches_every_cell(tmp_path, monkeypatch):
    """The dry-run mode (no --schedulability, no --config) runs every
    runnable cell once on each mesh through ``run_one`` (stubbed here;
    tests/test_torch_dryrun.py runs real cells) and writes the skip list
    beside the cells."""
    from repro_torch.configs import valid_cells
    calls = []

    def one(arch, shape, multi_pod, force):
        calls.append((arch, shape, multi_pod, force))
        return {"lower_s": 0.0}

    monkeypatch.setattr(sweep, "OUT", str(tmp_path))
    monkeypatch.setattr(sweep, "run_one", one)
    sweep.main([])
    runnable, _ = valid_cells()
    assert runnable
    assert calls == [(a, s, pod, False) for pod in (False, True)
                     for a, s in runnable]
    calls.clear()
    sweep.main(["--single-pod-only", "--force"])
    assert calls == [(a, s, False, True) for a, s in runnable]
    with open(tmp_path / "skipped.json") as f:
        assert "qwen2-7b|long_500k" in json.load(f)


def test_schedulability_sweep_equals_jax():
    kw = dict(n_cores=4, n_tasks=3, utils=(0.5, 0.9), n_per_util=3,
              cycles=5.0, processes=1, seed=42)
    got = sweep.schedulability_sweep(**kw)
    want = jax_sweep.schedulability_sweep(**kw)
    assert rows_of(got) == rows_of(want)
    assert got["config_digest"] == want["config_digest"]
    # sharding-independent: more workers, the same rows
    assert rows_of(sweep.schedulability_sweep(**{**kw, "processes": 4})) \
        == rows_of(got)
    cell = sweep._sched_cell(sweep.taskset_seed(42, 1, 0.5), 4, 3, 0.5, 5.0)
    jcell = jax_sweep._sched_cell(jax_sweep.taskset_seed(42, 1, 0.5), 4, 3,
                                  0.5, 5.0)
    assert {k: v for k, v in cell.items() if k != "wall_s"} == \
        {k: v for k, v in jcell.items() if k != "wall_s"}


def test_sweep_main_on_smoke_config_equals_jax(tmp_path, monkeypatch):
    path = os.path.join(CONFIGS, "sweep_smoke.json")
    sweep.main(["--config", path, "--out", str(tmp_path / "port.json"),
                "--procs", "1"])
    monkeypatch.setattr(sys, "argv", ["sweep", "--config", path, "--out",
                                      str(tmp_path / "jax.json"), "--procs",
                                      "1"])
    jax_sweep.main()
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert rows_of(got) == rows_of(want)
    assert [r["n"] for r in got["rows"]] == [10, 10]


def test_sweep_and_grid_share_the_taskset_helpers():
    """The grid draws its task sets with the sweep's seed rule and
    UUniFast, as JAX's does."""
    assert grid.taskset_seed is sweep.taskset_seed
    assert grid.uunifast is sweep.uunifast
    assert sweep.taskset_seed(0, 3, 0.7) == jax_sweep.taskset_seed(0, 3, 0.7)
