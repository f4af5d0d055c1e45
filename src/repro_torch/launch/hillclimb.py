"""Perf hillclimb of the port (counterpart of
``repro.launch.hillclimb``): run named variants (ParallelConfig
overrides) of a dry-run cell and print the H100 roofline terms of each
beside the baseline's.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch kimi-k2-1t-a32b --shape decode_32k --multi-pod \\
        --variant ws moe_weight_stationary=true

Variants are cached as results/dryrun_torch/<arch>_<shape>_<mesh>__
<variant>.json, each traced in a process of its own
(``dryrun.run_cell_subprocess``).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun
from repro_torch.roofline.report import roofline_row


def run_variant(arch: str, shape: str, multi_pod: bool, variant: str,
                overrides: list[str], force: bool = False) -> dict:
    path = dryrun.cell_path(arch, shape, multi_pod, variant)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    return dryrun.run_cell_subprocess(arch, shape, multi_pod, overrides,
                                      variant, out=path)


def compare(cells: list[dict]) -> None:
    print(f"{'variant':<28} {'compute_s':>10} {'memory_s':>10} "
          f"{'collect_s':>10} {'dominant':>10} {'temp_gb':>8} "
          f"{'roofline':>9}")
    for c in cells:
        r = roofline_row(c)
        print(f"{r['variant']:<28} {r['compute_s']:>10.4g} "
              f"{r['memory_s']:>10.4g} {r['collective_s']:>10.4g} "
              f"{r['dominant']:>10} {r['mem_temp_gb']:>8.3g} "
              f"{r['roofline_fraction']:>9.4g}")
    print("\ntop collectives (baseline):")
    for t in cells[0].get("top_collectives", [])[:8]:
        print(f"  {t['bytes'] / 2**30:8.2f} GiB  {t['kind']:<18} "
              f"x{t['mult']:.0f}  {t['sig']}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", nargs="+", action="append", default=[],
                    metavar="NAME OVERRIDE...",
                    help="variant name followed by k=v overrides")
    args = ap.parse_args(argv)
    cells = [run_variant(args.arch, args.shape, args.multi_pod, "baseline",
                         [], force=False)]
    for spec in args.variant:
        name, overrides = spec[0], spec[1:]
        cells.append(run_variant(args.arch, args.shape, args.multi_pod,
                                 name, overrides, force=args.force))
    compare(cells)
    return cells


if __name__ == "__main__":
    main()
