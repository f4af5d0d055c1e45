"""A traffic mix and a per-layer metric added as new files are found by
name, with no file of the harness edited."""
import json
import shutil

from gangbench.harness import catalog
from gangbench.harness.cell import per_layer
from gangbench.tests import tiny


def test_new_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "gangbench"
    shutil.copytree(catalog.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = tiny.mix(tiny.SERVE)
    mix["rate_per_s"] = 5
    (bench / "traffic" / "olmoe-1b-7b.serve.new_mix.json").write_text(
        json.dumps(mix))
    (bench / "metrics" / "refills_in_window.py").write_text(
        "def read(run):\n    return len(run.in_window('refill'))\n")
    found = catalog.load_data("traffic", "olmoe-1b-7b.serve.new_mix", bench)
    assert found["rate_per_s"] == 5
    res = tiny.run(tiny.SERVE, mx=found, bench_dir=bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 10


def test_metric_reader_returning_nothing_is_left_out(tmp_path):
    bench = tmp_path / "gangbench"
    (bench / "metrics").mkdir(parents=True)
    (bench / "metrics" / "silent.py").write_text(
        "def read(run):\n    return None\n")
    (bench / "metrics" / "loud.py").write_text(
        "def read(run):\n    return 2\n")
    assert per_layer(None, ["silent", "loud"], bench) == {"loud": 2.0}
