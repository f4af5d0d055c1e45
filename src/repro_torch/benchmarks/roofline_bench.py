"""Roofline benchmark of the port: reads the port's dry-run cells
(results/dryrun_torch/*.json) and computes the three H100 roofline terms
per (arch x shape x mesh); files without ``flops_per_device`` (a skip
list, say) are passed over. ``repro_torch.launch.dryrun`` (one cell) and
``repro_torch.launch.sweep`` (every cell) write the cells.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_bench
"""
import glob
import json
import os

from repro_torch.launch.sweep import OUT as RESULTS
from repro_torch.roofline.report import markdown_table, roofline_row


def run(results: str = RESULTS):
    rows = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if "flops_per_device" not in cell:
            continue
        rows.append(roofline_row(cell))
    return rows


if __name__ == "__main__":
    print(markdown_table(run()))
