"""The paper's headline scenario, end to end, on the card: a DAVE-2 DNN
control loop as the real-time gang, co-located with a memory-heavy
best-effort job, with and without RT-Gang — on the port's gang executor.

    python -m repro_torch.examples.deeppicar_gang [--device cpu]
        [--duration 5]

Counterpart of ``examples/deeppicar_gang.py``. Every quantum runs on its
lane's CUDA stream and ends when that stream has drained
(``device.Lanes``); an exception in a quantum fails the run after it.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.configs.deeppicar import CONFIG
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.device import Lanes, resolve_device, synchronize
from repro_torch.models.dave2 import make_dave2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=5.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CONFIG
    _, model = make_dave2(cfg, device=dev)
    img = torch.ones((1, *cfg.input_hw, cfg.in_channels), device=dev)
    mem = torch.ones((1536, 1536), device=dev)
    lanes = Lanes(dev, 2)
    errors: List[BaseException] = []
    dnn_q = lanes.quantum(lambda lane, i: model(img), errors)
    mem_q = lanes.quantum(lambda lane: (mem @ mem).sum(), errors)
    synchronize(dev)
    dnn_q(0, 0)
    mem_q(0)

    period = 0.033                       # 30 Hz control loop (paper §II)
    rows = {}
    for enabled in (False, True):
        ex = GangExecutor(n_lanes=2, enabled=enabled,
                          regulation_interval_s=0.01)
        ex.submit_rt(RTJob("dnn-control", dnn_q, lanes=(0,), prio=10,
                           period_s=period, budget_bytes=0.0, n_jobs=120))
        ex.submit_be(BEJob("mem-hog", mem_q, lanes=(0, 1),
                           bytes_per_quantum=1536 * 1536 * 8.0))
        stats = ex.run(args.duration)
        if errors:
            raise errors[0]
        lat = np.array([s.t1 - s.t0 for s in ex.trace.segments
                        if s.label == "dnn-control"])
        mode = "RT-Gang" if enabled else "Co-Sched"
        rows[mode] = {"lat_ms": lat,
                      "jobs": len(stats["response_times"]["dnn-control"]),
                      "be_quanta": stats["be_quanta"]["mem-hog"]}
        print(f"{mode:>8}: dnn p50={np.percentile(lat, 50):.2f}ms "
              f"p99={np.percentile(lat, 99):.2f}ms max={lat.max():.2f}ms "
              f"jobs={rows[mode]['jobs']} "
              f"be_quanta={rows[mode]['be_quanta']}")
    print("RT-Gang keeps the control-loop latency near its solo value while"
          " the best-effort job is throttled to the declared budget.")
    return rows


if __name__ == "__main__":
    main()
