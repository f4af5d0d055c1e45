"""Run a cell several times, one process a run, and report each metric's
spread.

    python3 gangbench/tools/spread.py --workload <cell> --seeds 1 2 3 \
        [--seconds S] [--trace 0|1] [--out FILE]

Each run is ``python3 gangbench/run.py`` as the benchmark's command runs
it. Prints the result line of every run and, per metric, the values,
their median and the spread (interquartile distance over the median, as
``statistics.quantiles(values, n=4)`` gives it) as JSON lines, and writes
every line to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if not __package__:     # run as a script from the checkout's root
    sys.path[:0] = [str(ROOT)]

from gangbench.harness.stats import spread  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    lines, values = [], {}
    for seed in args.seeds:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "gangbench/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(args.trace)], cwd=ROOT, capture_output=True, text=True)
        wall = time.time() - t0
        out = proc.stdout.strip().splitlines()
        try:
            res = json.loads(out[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall,
               "result": res}
        if res is None:
            row["stderr"] = proc.stderr[-3000:]
        else:
            row["stderr_tail"] = proc.stderr.strip().splitlines()[-6:]
            for k, v in res["metrics"].items():
                values.setdefault(k, []).append(v["value"])
        lines.append(row)
        print(json.dumps(row), flush=True)
    for k, vs in values.items():
        row = {"metric": k, "values": vs, "median": statistics.median(vs)}
        if len(vs) >= 2:
            row["spread"] = spread(vs)
        lines.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))


if __name__ == "__main__":
    main()
