"""Readings for a cell's correctness limit, in one process on the card.

    python3 gangbench/tools/calibrate.py --workload <cell> \
        --seeds 11 12 ... [--seconds 12] [--out FILE]

For each seed, one whole run of the cell (``harness.cell.run_cell``, at
the cell's own sizes and load, over a short window) with the control:
the program's served tokens against the float32 reference (the lower
reading), and the tokens the reference computed with fp8 operands puts
first, against the same float32 reference (the control's reading). Prints
one JSON line a seed and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if not __package__:     # run as a script from the checkout's root
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from gangbench.harness import catalog  # noqa: E402
from gangbench.harness.cell import run_cell  # noqa: E402


def run(workload: str, seeds, seconds: float = 12.0) -> list:
    """One row a seed: correct, the readings, the checks, the metrics."""
    bench = catalog.load_benchmark()
    cell = catalog.workload(bench, workload)
    config = catalog.read_data(ROOT / catalog.config_of(
        bench, cell["config"])["file"])
    mix = catalog.load_data("traffic", cell["traffic"])
    rows = []
    for seed in seeds:
        t0 = time.time()
        res = run_cell(cell=cell["name"], config=config, mix=mix, seed=seed,
                       seconds=seconds, trace=False,
                       device=torch.device("cuda", 0), t_start=t0,
                       e2e=catalog.metrics_of(bench, "end_to_end",
                                              cell["name"]),
                       layers=[], control=True)
        row = {"seed": seed, "correct": res["correct"],
               "readings": res["readings"], "checks": res["checks"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "seconds": time.time() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = run(args.workload, args.seeds, args.seconds)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))


if __name__ == "__main__":
    main()
