"""Paper Fig.6 on the port: DAVE-2 inference-time percentiles under Solo /
Co-Sched / RT-Gang, through the gang executor, on the card.

The executor branch of ``benchmarks/fig6_dnn_cdf.py`` (its ``--sim``
branch runs no device work and stays in the JAX package's shared core):
DAVE-2 at batch 1 is the RT gang (lane 0, priority 10, a 20 ms period),
beside two best-effort jobs on lanes 0 and 1, ``lbm_mem`` (a 1536² f32
matmul, 1536²·8 bytes a quantum) and ``cutcp_cpu`` (sin of 4096 f32,
4096·4 bytes). Co-Sched runs the executor with RT-Gang off and an
unbounded byte budget, RT-Gang with it on and a budget of 0. Every quantum,
and each Solo call, runs on its lane's CUDA stream and ends when that
stream has drained (``device.Lanes``); an exception in a quantum fails the
run after it.

    python -m repro_torch.benchmarks.fig6_dnn_cdf [--device cpu]
        [--duration 6]

``Fig6(device).gang(..., best_effort=False)`` runs the DNN alone on the
executor at its period: on the card a call at the period is slower than
one of Solo's back-to-back calls, so this is the baseline RT-Gang can
match.

On the card each mode also reports ``dev_p50_ms`` / ``dev_p99_ms``: CUDA
events on the lane's stream around the forward, the time from the
stream's first launch of the quantum to its last finishing (device time,
plus any wait of the stream for the host between launches).

As in the JAX package, ``cutcp_cpu`` gets no quantum in any mode: best-effort
jobs are tried in submission order, ``lbm_mem`` is admitted whenever
anything is, and RT-Gang's budget of 0 admits nothing while the gang runs.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.deeppicar import CONFIG
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.device import Lanes, resolve_device, synchronize
from repro_torch.models.dave2 import make_dave2


def percentiles(xs):
    xs = np.asarray(xs) * 1e3
    if len(xs) == 0:
        return {}
    return {"p50_ms": round(float(np.percentile(xs, 50)), 3),
            "p95_ms": round(float(np.percentile(xs, 95)), 3),
            "p99_ms": round(float(np.percentile(xs, 99)), 3),
            "max_ms": round(float(np.max(xs)), 3),
            "n": len(xs)}


def _device_ms(events: List[Tuple[torch.cuda.Event, torch.cuda.Event]]
               ) -> dict:
    ms = np.array([a.elapsed_time(b) for a, b in events])
    return {"dev_p50_ms": round(float(np.percentile(ms, 50)), 4),
            "dev_p99_ms": round(float(np.percentile(ms, 99)), 4)}


MODES = (("cosched", False, 1e18), ("rtgang", True, 0.0))


class Fig6:
    """The Fig.6 set-up on one device: DAVE-2 at batch 1 on an all-ones
    image, the best-effort jobs' inputs, two lanes, and the three quanta
    wrapped for them (``device.Lanes.quantum``), warmed up once each."""

    def __init__(self, device: Optional[str | torch.device] = None):
        self.device = dev = resolve_device(device)
        cfg = CONFIG
        _, self.model = make_dave2(cfg, device=dev)
        self.img = torch.ones((1, *cfg.input_hw, cfg.in_channels),
                              device=dev)
        self.mem = torch.ones((1536, 1536), device=dev)
        self.cpu_arr = torch.ones((4096,), device=dev)
        self.timing = dev.type == "cuda"
        self.events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.errors: List[BaseException] = []
        lanes = Lanes(dev, 2)
        self.dnn_q = lanes.quantum(self._dnn, self.errors)
        self.mem_q = lanes.quantum(self._mem, self.errors)
        self.cpu_q = lanes.quantum(self._cpu, self.errors)
        synchronize(dev)              # the inputs, made on another stream
        self.dnn_q(0, 0)              # warm up (cuDNN / cuBLAS plans)
        self.mem_q(0)
        self.cpu_q(0)

    def _dnn(self, lane, idx):
        if self.timing:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.model(self.img)
            end.record()
            self.events.append((start, end))
        else:
            self.model(self.img)

    def _mem(self, lane):
        (self.mem @ self.mem).sum()

    def _cpu(self, lane):
        torch.sin(self.cpu_arr).sum()

    def _with_device_ms(self, row: dict) -> dict:
        if self.timing and self.events:
            synchronize(self.device)
            row.update(_device_ms(self.events))
        return row

    def solo(self) -> dict:
        """100 calls back to back, on lane 0's stream as the gang quanta
        run."""
        self.events.clear()
        lat = []
        for i in range(100):
            t0 = time.perf_counter()
            self.dnn_q(0, i)
            lat.append(time.perf_counter() - t0)
        return self._with_device_ms(percentiles(lat))

    def gang(self, enabled: bool, budget: float, duration: float,
             period_s: float = 0.020, best_effort: bool = True) -> dict:
        """DAVE-2 as the RT gang for ``duration`` seconds, beside
        ``lbm_mem`` and ``cutcp_cpu`` unless ``best_effort`` is False."""
        ex = GangExecutor(n_lanes=2, enabled=enabled,
                          regulation_interval_s=0.01)
        n_jobs = int(duration / period_s) - 2
        ex.submit_rt(RTJob("dnn", self.dnn_q, lanes=(0,), prio=10,
                           period_s=period_s, budget_bytes=budget,
                           n_jobs=n_jobs))
        if best_effort:
            ex.submit_be(BEJob("lbm_mem", self.mem_q, lanes=(0, 1),
                               bytes_per_quantum=1536 * 1536 * 8.0))
            ex.submit_be(BEJob("cutcp_cpu", self.cpu_q, lanes=(0, 1),
                               bytes_per_quantum=4096 * 4.0))
        self.events.clear()
        stats = ex.run(duration)
        if self.errors:
            raise self.errors[0]
        # quantum *execution* time: trace segments labelled dnn
        stats_lat = [s.t1 - s.t0 for s in ex.trace.segments
                     if s.label == "dnn"]
        row = percentiles(np.asarray(stats_lat) / 1e3)
        row["be_quanta"] = stats["be_quanta"]
        return self._with_device_ms(row)


def run(duration: float = 6.0, period_s: float = 0.020,
        device: Optional[str | torch.device] = None) -> dict:
    bench = Fig6(device)
    results = {"solo": bench.solo()}
    for mode, enabled, budget in MODES:
        results[mode] = bench.gang(enabled, budget, duration, period_s)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=6.0)
    args = ap.parse_args(argv)
    rows = run(args.duration, device=args.device)
    for k, v in rows.items():
        print(k, v)
    return rows


if __name__ == "__main__":
    main()
