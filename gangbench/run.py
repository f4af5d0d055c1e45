"""The benchmark of the PyTorch/CUDA port (``repro_torch``) of RT-Gang.

    python3 gangbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It runs one cell of ``BENCHMARK.json`` on
one card: set-up (the model built, the weights drawn on the card from
the seed, the cell's shapes warmed up), then the gang executor for
``--seconds`` (and the mix's drain), then the comparison of the served
tokens with the plain float32 reference. The last line of standard output
is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones read from
the benchmark's spans and the device trace), device, breakdown (traced)
and checks (each number compared, with its limit). The checks are also
the last lines of standard error.

Exits non-zero, printing no result, without a card, or if any of jax,
jaxlib, flax or the JAX package ``repro`` was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def setup_environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX behind a
    library's back."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if sys.path[2:] and Path(sys.path[2]).resolve() == ROOT / "gangbench":
        del sys.path[2]   # the script's folder: its parts are gangbench.*


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_environment()

    from gangbench.harness import catalog, checks
    bench = catalog.load_benchmark(ROOT)
    cell = catalog.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"gangbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from gangbench.harness.cell import run_cell
    config = catalog.read_data(ROOT / catalog.config_of(
        bench, cell["config"])["file"])
    mix = catalog.load_data("traffic", cell["traffic"])
    result = run_cell(
        cell=cell["name"], config=config, mix=mix, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=t_start,
        e2e=catalog.metrics_of(bench, "end_to_end", cell["name"]),
        layers=catalog.metrics_of(bench, "per_layer", cell["name"]))
    bad = forbidden_modules()
    if bad:
        print(f"gangbench: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in checks.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
