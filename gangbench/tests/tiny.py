"""Cells of the benchmark cut to a size the CPU runs in seconds: the
same configuration files and mixes, at widths of tens."""
from __future__ import annotations

import copy
import time

import torch

from gangbench.harness import catalog
from gangbench.harness.cell import run_cell

SERVE = "olmoe-1b-7b.serve.long_prompt"
BUSY = "olmoe-1b-7b.serve.long_output"
ROUNDS = "mamba2-1.3b.gang.long_prompt"
SEED = 2**31 + 1234567


# cell -> (configuration, traffic mix); the last is a mix no cell runs yet
PARTS = {SERVE: ("olmoe-1b-7b", SERVE), ROUNDS: ("mamba2-1.3b", ROUNDS),
         BUSY: ("olmoe-1b-7b", BUSY)}


def config(cell: str, bench_dir=catalog.BENCH_DIR) -> dict:
    c = copy.deepcopy(catalog.load_data("configs", PARTS[cell][0], bench_dir))
    m = c["model"]
    m.update(n_layers=2, d_model=64, vocab_size=256, dtype="float32")
    if m["family"] == "moe":
        m.update(n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32)
        m["moe"].update(n_experts=8, top_k=2)
    else:
        m["ssm"].update(state_dim=16, head_dim=16, chunk=8)
    return c


def mix(cell: str, bench_dir=catalog.BENCH_DIR, name=None) -> dict:
    x = copy.deepcopy(catalog.load_data("traffic", name or PARTS[cell][1],
                                        bench_dir))
    x.update(prompt={"dist": "loguniform", "lo": 12, "hi": 40},
             period_ms=20, drain_s=1.0, hog_buffer_bytes=1 << 16,
             hog_declared_bytes=1 << 17)
    if x["driver"] == "serve":
        x.update(output={"dist": "uniform", "lo": 3, "hi": 8}, slots=4,
                 max_seq=64, rate_per_s=8)
        if "busy_slots" in x:
            x["busy_slots"] = 4
    else:
        x.update(batch=4, new_tokens=5)
    x["check"].update(min_tokens=10, token_gap_max=1e-3, token_gap_mean=1e-5)
    return x


def run(cell: str, *, trace=False, control=False, seconds=2.0,
        cfg=None, mx=None, bench_dir=catalog.BENCH_DIR, seed=SEED):
    bench = catalog.load_benchmark()
    return run_cell(
        cell=cell, config=cfg or config(cell), mix=mx or mix(cell),
        seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cpu"), t_start=time.time(),
        e2e=catalog.metrics_of(bench, "end_to_end", cell),
        layers=catalog.metrics_of(bench, "per_layer", cell),
        bench_dir=bench_dir, control=control)
