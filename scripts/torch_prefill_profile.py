#!/usr/bin/env python3
"""Where a 1024-token prefill's time goes, on one NVIDIA card.

    python3 scripts/torch_prefill_profile.py [--arch mamba2-1.3b] [--seq 1024]

Builds the model at full width and depth in bf16 with random weights from
seed 0 (as ``chip_smoke.py``'s gang phases do), runs one batch-1 prefill
to warm up, then times three more on the host clock (each ends in a
synchronize) and traces one of them with ``torch.profiler`` (CPU and
CUDA activities). Prints the median wall time, the device's busy time
(the sum of the traced device events' durations: kernels, copies and
fills, on one stream), the idle share (1 - busy / wall, against the
untraced median and against the traced run), the device events, and the
kernels that take the most device time. A device-bound prefill has an idle share near 0; a
host-bound one (Python dispatch slower than the kernels it launches)
near 1, and then a faster kernel does not shorten the prefill. Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefill_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    api = build_model(cfg, ParallelConfig(param_dtype="bfloat16",
                                          compute_dtype="bfloat16"), dev)
    params = api.init(seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, args.seq)), device=dev)
    batch = {"tokens": tokens}
    api.prefill_fn(params, batch)                      # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    wall_ms = float(np.median(walls))
    print(f"[{args.arch}] {args.seq}-token prefill at batch 1, bf16: wall "
          f"median {wall_ms:.3f} ms of {len(walls)} "
          f"({', '.join(f'{w:.3f}' for w in walls)}); "
          f"traced run {traced_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms in {len(kernels)} device events, idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the median, "
          f"{1 - busy_ms / traced_ms:.3f} of the traced run [{smi}]")
    if not kernels:
        print(f"[{args.arch}] the trace holds no device time: time the "
              f"kernels with CUDA events instead")
        return 1
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:args.top]
    for name, ts in top:
        print(f"[{args.arch}]   {sum(ts):8.3f} ms in {len(ts):4d} launches: "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
