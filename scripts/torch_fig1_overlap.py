#!/usr/bin/env python3
"""How often the port's Fig.1 co-runner runs beside DAVE-2 on one NVIDIA
card: ``chip_smoke.py`` (g)'s traced co-run, repeated.

    PYTHONPATH=<checkout>/src python3 scripts/torch_fig1_overlap.py \
        [--reps 20] [--tag T]

Each repetition runs the DNN 10 times on a stream of its own inside
``fig1_parallelization.hammering`` under ``torch.profiler`` (as (g) does),
takes the DNN's stream (the one with the most distinct kernels) and the
co-runner's (the busiest other one) from the trace, and prints how much
of the DNN's kernel time the co-runner's kernels ran beside it (and how
much of the DNN's span, first kernel to last, the co-runner kept its
stream busy): (g) fails a run whose overlap is 0. ``--busy-threads N``
runs N pure-Python threads beside each co-run, a host whose GIL is
contended. ``chip_smoke.py`` reads its traces with this
module's ``device_events``, ``overlap`` and ``corun_overlap``. The benchmark comes from whichever checkout's
``src`` is first on ``PYTHONPATH``, so one copy of this script compares
two commits in one call. Prints one line a repetition, then the count of
repetitions with no overlap, with the card's name and power limit. Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

from repro_torch.benchmarks import fig1_parallelization as fig1
from repro_torch.configs.deeppicar import CONFIG
from repro_torch.models.dave2 import make_dave2


def device_events(fn, trace: Path) -> list[dict]:
    """The device events (kernels, copies, memsets) of ``fn()`` under
    ``torch.profiler``, from its chrome trace (written to ``trace``):
    name, stream, start and duration in µs (device clock)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return [{"name": e["name"], "stream": e.get("args", {}).get("stream"),
             "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def overlap(dnn: list[dict], others: list[dict]) -> dict:
    """How much of the DNN's kernel time the other kernels ran beside it."""
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    dnn_us = sum(e["dur"] for e in dnn)
    t0 = min((e["ts"] for e in dnn), default=0.0)
    t1 = max((e["ts"] + e["dur"] for e in dnn), default=0.0)
    in_span_us = sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merged)
    both_us = sum(max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
                  for e in dnn for a, b in merged)
    return {"dnn_kernel_ms": dnn_us / 1e3, "overlap_ms": both_us / 1e3,
            "share": both_us / dnn_us if dnn_us else 0.0,
            "dnn_kernels": len(dnn), "other_kernels": len(others),
            "other_busy_ms": sum(b - a for a, b in merged) / 1e3,
            "dnn_span_ms": (t1 - t0) / 1e3,
            "other_span_share": in_span_us / (t1 - t0) if t1 > t0 else 0.0}


def corun_overlap(by_stream: dict) -> dict:
    """(g)'s reading of a co-run's events by stream: the DNN's stream has
    the most distinct kernels, the co-runner's is the busiest other one;
    nothing overlaps when the trace holds one stream."""
    if len(by_stream) < 2:
        return overlap([e for es in by_stream.values() for e in es], [])
    mine = max(by_stream, key=lambda s: len({e["name"]
                                             for e in by_stream[s]}))
    hog = max((s for s in by_stream if s != mine),
              key=lambda s: sum(e["dur"] for e in by_stream[s]))
    return overlap(by_stream[mine], by_stream[hog])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="", help="label printed on each line")
    ap.add_argument("--busy-threads", type=int, default=0,
                    help="pure-Python threads spinning beside each co-run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fig1_overlap: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _, model = make_dave2(CONFIG, device=dev)
    img = torch.ones((fig1.BATCH, *CONFIG.input_hw, CONFIG.in_channels),
                     device=dev)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()

    def dnn():
        with torch.cuda.stream(stream):
            model(img)

    def spin(stop):
        while not stop.is_set():
            sum(range(1000))

    def corun():
        stop = threading.Event()
        spinners = [threading.Thread(target=spin, args=(stop,))
                    for _ in range(args.busy_threads)]
        for t in spinners:
            t.start()
        try:
            with fig1.hammering(dev):
                fig1.time_fn(dnn, stream, iters=10)
        finally:
            stop.set()
            for t in spinners:
                t.join()
    zero, shares = 0, []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.reps):
            by_stream: dict = {}
            for e in device_events(corun, Path(tmp) / "trace.json"):
                by_stream.setdefault(e["stream"], []).append(e)
            ov = corun_overlap(by_stream)
            zero += ov["overlap_ms"] <= 0
            shares.append(ov["share"])
            print(f"[{args.tag}] rep {rep}: overlap {ov['overlap_ms']:.4f} ms "
                  f"of the DNN's {ov['dnn_kernel_ms']:.4f} ms kernel time "
                  f"({ov['share']:.3f}), {ov['other_kernels']} co-runner "
                  f"kernels busy {ov['other_span_share']:.3f} of the DNN's "
                  f"{ov['dnn_span_ms']:.4f} ms span", flush=True)
    print(f"[{args.tag}] {zero} of {args.reps} repetitions with no overlap; "
          f"share min {min(shares):.3f}, max {max(shares):.3f}; in flight "
          f"{getattr(fig1, 'IN_FLIGHT', 1)} x "
          f"{getattr(fig1, 'CALLS_PER_LAUNCH', 1)} calls, "
          f"{args.busy_threads} busy threads [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
